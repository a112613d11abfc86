"""Serving layer of the port (counterpart of ``repro.service``).

Ported: the batch lane (``batch``: ``BatchedSolver`` with ``submit`` /
``collect``), canonicalization (``canon``), the plan cache (``cache``),
the admission router (``router``), the layer-granular fragment cache
(``layercache``), the synthetic request generator (``workload``), the
serving runtime (``runtime``: clocks, SLO classes, per-``(n, cost)``
admission queues with an adaptive batch former, the cache-hit fast path,
coalescing of relabeled duplicates, shedding, N solve lanes with work
stealing and hedged probes), the resilience layer (``faults``: typed
errors, breakers, quarantine, seeded fault injection), tenant quotas
(``tenancy``) and the plan server (``server.PlanServer``: ``plan_one``,
``serve``, ``plan_async``, ``prewarm``).  The wire layer (``net``) and
the replica cluster (``cluster``) are not ported yet.
"""
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: F401
                             Tracer)
from repro_torch.service.batch import (BatchedSolver,  # noqa: F401
                                       BatchPolicy, SolveHandle)
from repro_torch.service.cache import (CachedPlan, CacheStats,  # noqa: F401
                                       PlanCache)
from repro_torch.service.canon import (CanonicalForm,  # noqa: F401
                                       canonicalize, relabel_tree,
                                       topology_signature)
from repro_torch.service.faults import (BreakerBoard,  # noqa: F401
                                        BreakerConfig, CacheBackendError,
                                        CompileError, EngineError,
                                        FaultInjector, FaultPlan,
                                        FaultSpec, FaultStats,
                                        NetworkError, PlanError,
                                        PlanTimeoutError, Quarantine,
                                        QuarantinedError, ReplicaDeadError,
                                        ShedError, WorkerDied)
from repro_torch.service.layercache import (LayerCache,  # noqa: F401
                                            LayerCacheStats)
from repro_torch.service.router import Route, Router, RouterConfig  # noqa: F401
from repro_torch.service.runtime import (Clock, RuntimeConfig,  # noqa: F401
                                         RuntimeStats, ServingRuntime,
                                         SLOClass, Ticket, VirtualClock,
                                         WallClock)
from repro_torch.service.server import (LatencyHistogram,  # noqa: F401
                                        PlanRequest, PlanResponse,
                                        PlanServer, ServeStats)
from repro_torch.service.tenancy import (AdmissionCeilings,  # noqa: F401
                                         QuotaBoard, TenantQuota)
from repro_torch.service.workload import (WorkloadSpec,  # noqa: F401
                                          make_query, make_workload)
