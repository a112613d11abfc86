"""Core DPconv algorithms of the port (see ``repro.core`` for the
reference).  Unlike the reference package this imports no framework at
import time."""
from repro_torch.core.querygraph import QueryGraph  # noqa: F401
from repro_torch.core.jointree import JoinTree  # noqa: F401
