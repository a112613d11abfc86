"""Launch tooling of the port (see ``repro.launch`` for the reference):
the solve mesh of sharded lattice solves (``launch.mesh``), the batched
LM serving driver (``launch.serve``), the training driver
(``launch.train``), the analytic step cost model (``launch.costmodel``)
and the dry-run (``launch.dryrun`` over ``launch.specs``' cells, with
``launch.hlo_parse``'s collective accounting)."""
