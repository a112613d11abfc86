"""Planners built on the port's DPconv: tensor contraction order
(``einsum_path``) and data-pipeline joins (``datajoin``)."""
