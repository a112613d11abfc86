"""PyTorch port of ``repro`` for NVIDIA Hopper (H100, sm_90a).

The package keeps ``repro``'s module layout and names.  It imports
``torch`` and numpy only: never ``jax``, and nothing of ``repro`` (the
numpy-only modules it needs are copied into it).  Plain tensor code is
PyTorch; every Pallas kernel of ``repro`` on the ported path is a CUDA
C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``kernels/build.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.

Ported so far: the plan server (``service.server.PlanServer``:
``plan_one``, stream serving with ``serve``, the awaitable ``plan_async``
front end and ``prewarm``) over the serving runtime
(``service.runtime``: SLO classes, deadline shedding, coalescing, N solve
lanes, the failure ladder of ``service.faults`` and the tenant quotas of
``service.tenancy``) with its tracing (``obs``); canonicalization,
routing, the plan cache and the layer cache's warm starts; the batch
lane's four costs (``max``, ``cap``, ``cap_conn``, ``out``) from
``service.batch.BatchedSolver`` down to the zeta/Moebius and
ranked-convolution kernels; every (cost, method) pair of
``core.dpconv.optimize`` with the host loop's early-exit and (G+1)-ary
searches; the einsum and data-join planners (``planner``) with the
model configs they plan at (``configs``, ``models.common.ModelConfig``)
and the einsum replay lane; the replica cluster (``service.net``,
``service.cluster``); and the sharded lattice solve (``shards = D`` in
every fused program, over a single-controller solve mesh of
``launch.mesh``, with ``force_device_count`` to run a D-way mesh on one
device) with the batch lane's ``BatchPolicy.solve_shards`` and the
server's lifted cap/out ceilings.  On the LM side: the models of the
ten configs' six families (``models``: dense, moe, ssm, hybrid, encdec,
vlm) with their KV/SSM decode caches, the serve steps
(``train.steps``), the input shapes (``configs.shapes``) and the
batched serving driver (``launch.serve``); and LM training on one
device: the train steps (``train.steps``: chunked cross-entropy,
per-layer recomputation under ``remat``, gradient accumulation,
compressed gradients with error feedback), AdamW (``optim.adamw``),
checkpoints in the reference's file format (``checkpoint.ckpt``), the
synthetic data stream (``data.synthetic``), the fault-tolerant driver
(``launch.train``) and the analytic step cost model
(``launch.costmodel``).  The LM meshes and the dry-run tooling
(``launch.{dryrun,hlo_parse,specs}``, ``models.sharding``) are not
ported.
"""
