"""Launch tooling of the port (see ``repro.launch`` for the reference):
the solve mesh of sharded lattice solves (``launch.mesh``), the batched
LM serving driver (``launch.serve``), the training driver
(``launch.train``) and the analytic step cost model
(``launch.costmodel``)."""
