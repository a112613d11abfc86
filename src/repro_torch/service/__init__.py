"""Serving layer of the port (counterpart of ``repro.service``).

Ported: the batch lane (``batch``), canonicalization (``canon``), the
plan cache (``cache``), the admission router (``router``), the
layer-granular fragment cache (``layercache``), the synthetic request
generator (``workload``) and the plan server's single-request and
micro-batch path (``server.PlanServer.plan_one`` / ``_process``).  Stream
serving, the async front end and prewarm need the serving runtime and
raise ``NotImplementedError`` until it is ported.
"""
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.service.batch import BatchedSolver, BatchPolicy  # noqa: F401
from repro_torch.service.cache import (CachedPlan, CacheStats,  # noqa: F401
                                       PlanCache)
from repro_torch.service.canon import (CanonicalForm,  # noqa: F401
                                       canonicalize, relabel_tree,
                                       topology_signature)
from repro_torch.service.layercache import (LayerCache,  # noqa: F401
                                            LayerCacheStats)
from repro_torch.service.router import Route, Router, RouterConfig  # noqa: F401
from repro_torch.service.server import (LatencyHistogram,  # noqa: F401
                                        PlanRequest, PlanResponse,
                                        PlanServer, ServeStats)
from repro_torch.service.workload import (WorkloadSpec,  # noqa: F401
                                          make_query, make_workload)
