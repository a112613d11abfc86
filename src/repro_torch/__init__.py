"""PyTorch port of ``repro`` for NVIDIA Hopper (H100, sm_90a).

The package keeps ``repro``'s module layout and names.  It imports
``torch`` and numpy only: never ``jax``, and nothing of ``repro`` (the
numpy-only modules it needs are copied into it).  Plain tensor code is
PyTorch; every Pallas kernel of ``repro`` on the ported path is a CUDA
C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``kernels/build.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.

Ported so far: the plan server's single-request and micro-batch path
(``service.server.PlanServer.plan_one``: canonicalization, routing, the
plan cache and the layer cache's warm starts), the batch lane's four
costs (``max``, ``cap``, ``cap_conn``, ``out``) from
``service.batch.BatchedSolver`` down to the zeta/Moebius and
ranked-convolution kernels, and every (cost, method) pair of
``core.dpconv.optimize``.  ``shards > 1`` and the serving runtime
(``PlanServer.serve``, ``plan_async``, ``prewarm``) raise
``NotImplementedError``.
"""
