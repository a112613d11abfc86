"""Launch tooling of the port (see ``repro.launch`` for the reference):
the solve mesh of sharded lattice solves (``launch.mesh``) and the
batched LM serving driver (``launch.serve``)."""
