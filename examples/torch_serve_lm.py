"""Batched LM serving demo on the PyTorch port: the model stack's einsum
contraction orders are planned through the port's ``PlanServer``, then
prompts are consumed and tokens decoded greedily through the KV-cache
decode path (``repro_torch.launch.serve``).

    python3 examples/torch_serve_lm.py [--arch gemma3-1b]   # card
    python3 examples/torch_serve_lm.py --device cpu

The port of ``examples/serve_lm.py``: a reduced config, batch 4, 24
prompt and 24 generated tokens.  gemma3's 5:1 local:global pattern
exercises the ring-buffer local caches.  The contraction orders are
served through the synchronous ``PlanServer.serve`` front end, the
driver over the same deadline-aware scheduler that ``plan_async`` uses
(``repro_torch.service.runtime``).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.obs import span_phase_summary  # noqa: E402
from repro_torch.service import (PlanServer, WorkloadSpec,  # noqa: E402
                                 make_einsum_workload)


def plan_contraction_orders(device: str) -> None:
    """Serve the canned model-stack contraction trace through the
    runtime-backed sync front end, SLO-classed as interactive traffic."""
    reqs = make_einsum_workload(WorkloadSpec(
        n_requests=32, seed=0, rate=500.0,
        cost_mix=(("max", 0.8), ("out", 0.2)),
        slo_mix=(("interactive", 0.5), ("standard", 0.5))))
    srv = PlanServer(max_batch=8, device=device)
    # build the fused programs before traffic arrives, so that the first
    # interactive requests do not pay for the builds inline
    pw = srv.prewarm(sorted({r.q.n for r in reqs}))
    print(f"[planner] prewarmed {pw['compiled']} programs in "
          f"{pw['seconds']:.1f}s before admitting traffic")
    _, stats = srv.serve(reqs)                 # sync driver, arrivals on
    rs = srv.last_runtime.stats
    cs = srv.cache.stats
    print(f"[planner] {stats.served} contraction plans served via the "
          f"sync runtime driver: {rs.fast_path_hits} fast-path hits, "
          f"{rs.coalesced} coalesced, {rs.batches} batched solves, "
          f"{rs.deadline_misses} deadline misses")
    print(f"[planner] cache hit rate {cs.hit_rate:.0%} "
          f"({cs.relabel_hits} relabeled), "
          f"latency p99 {stats.latency.percentile(99) * 1e3:.2f}ms")
    rt = srv.last_runtime
    trs = rt.tracer.stats()
    phases = span_phase_summary(srv.registry)
    disp = phases.get("dispatch", {"count": 0})
    print(f"[planner] obs: {trs['requests']} span trees "
          f"({trs['unclosed_spans']} unclosed), dispatch p95 "
          f"{disp.get('p95_ms', 0.0):.2f}ms over {disp['count']} solves; "
          f"recorder {rt.recorder.snapshot()['counts']}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to plan and serve on (default: cuda)")
    args, _ = ap.parse_known_args()
    plan_contraction_orders(args.device)
    sys.exit(serve_main([
        "--arch", args.arch, "--reduced",
        "--batch", "4", "--prompt-len", "24", "--gen", "24",
        "--device", args.device,
    ]))
