"""Device layout of the port (see ``repro.launch`` for the reference):
the solve mesh of sharded lattice solves (``launch.mesh``)."""
