"""DPconv as a framework planning service, on the PyTorch port.

    python3 examples/torch_planner_demo.py              # card
    python3 examples/torch_planner_demo.py --device cpu

The port of ``examples/planner_demo.py``; every solve runs on
``--device`` (CUDA by default).

1. Einsum contraction ordering: C_max finds the contraction tree with the
   smallest peak intermediate tensor (device memory budgeting); compared
   against the greedy (opt_einsum-style) heuristic, and executed with
   ``torch.einsum`` against one ``torch.einsum`` of the whole expression.
2. Data-pipeline join planning: C_cap orders the metadata joins of a
   training-mixture assembly so peak worker memory is optimal and shuffle
   traffic is minimal under that cap — then actually executes the joins.
3. The plan-serving subsystem (``repro_torch.service``): both of the
   above run through a ``PlanServer`` — canonicalization, LRU plan cache,
   admission router, batched DPconv[max] — and a small mixed workload is
   served to show cache hits (including relabeled repeats) and routing
   decisions.
4. The async runtime front end: concurrent ``plan_async`` submitters
   share one deadline-aware scheduler (``repro_torch.service.runtime``) —
   their misses batch together, duplicate canonical forms coalesce onto
   one fused dispatch, and cache hits overtake the in-flight solve.
"""
import argparse
import asyncio
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.querygraph import permute_card, relabel  # noqa: E402
from repro_torch.obs import span_phase_summary  # noqa: E402
from repro_torch.planner.datajoin import (JoinSpec, Table,  # noqa: E402
                                          plan_joins)
from repro_torch.planner.einsum_path import (  # noqa: E402
    Contraction, cardinalities, execute_plan, greedy_plan, plan_contraction)
from repro_torch.service import (PlanServer, WorkloadSpec,  # noqa: E402
                                 make_workload)


def main(device: str) -> None:
    server = PlanServer(max_batch=8, cache_capacity=1024, device=device)

    # --- 1. a star-ish tensor network where the greedy
    #        smallest-intermediate-first heuristic pays 2.1x the optimal
    #        total intermediate volume (found by random search; seed fixed)
    c = Contraction(
        operands=("ab", "bc", "ad", "be", "ef", "eg"), output="a",
        sizes={"a": 21, "b": 6, "c": 149, "d": 87, "e": 143, "f": 178,
               "g": 151})
    card = cardinalities(c)
    res_out = plan_contraction(c, cost="out", method="dpsub", device=device)
    res_max = plan_contraction(c, cost="max", server=server)
    gtree, gpeak, gtotal = greedy_plan(c)
    print("einsum ab,bc,ad,be,ef,eg->a:")
    print(f"  DPconv total intermediate volume: {res_out.cost:,.0f} elements")
    print(f"  greedy  total intermediate volume: {gtotal:,.0f} "
          f"({gtotal / res_out.cost:.2f}x worse)")
    print(f"  peak: DPconv[max] {res_max.cost:,.0f} vs greedy {gpeak:,.0f}")
    print(f"  [service] routed via {res_max.route.method} "
          f"({res_max.route.reason})")
    # planning the SAME contraction again is a plan-cache hit
    res_again = plan_contraction(c, cost="max", server=server)
    print(f"  [service] replanning: cache_hit={res_again.cache_hit}, "
          f"same cost={res_again.cost == res_max.cost}")
    rng = np.random.default_rng(0)
    tensors = [torch.as_tensor(rng.normal(size=tuple(c.sizes[i] for i in op)),
                              device=device) for op in c.operands]
    out = execute_plan(c, res_out.tree, tensors)
    ref = torch.einsum("ab,bc,ad,be,ef,eg->a", *tensors)
    print(f"  executed plan matches torch.einsum: "
          f"{bool(torch.allclose(out, ref, atol=1e-6))}\n")

    # --- 2. training-mixture metadata joins
    tables = [Table("examples", ("doc",), 2_000_000),
              Table("docs", ("doc", "src"), 500_000),
              Table("sources", ("src",), 2_000),
              Table("quality", ("doc",), 480_000),
              Table("dedup", ("doc",), 450_000)]
    joins = [JoinSpec(0, 1, "doc", 1 / 500_000),
             JoinSpec(1, 2, "src", 1 / 2_000),
             JoinSpec(1, 3, "doc", 1 / 490_000),
             JoinSpec(1, 4, "doc", 1 / 470_000)]
    plan, card = plan_joins(tables, joins, cost="cap", server=server)
    print("pipeline join plan (C_cap, via the plan server):")
    print(f"  tree: {plan.tree}")
    print(f"  peak intermediate rows (optimal): {plan.meta['gamma']:,.0f}")
    print(f"  total intermediate rows under that cap: {plan.cost:,.0f}")
    # the same pipeline with the tables registered in another order is the
    # same query up to relabeling -> the canonical cache key still hits
    shuffle = [3, 0, 4, 2, 1]
    tables2 = [tables[i] for i in shuffle]
    inv = {old: new for new, old in enumerate(shuffle)}
    joins2 = [JoinSpec(inv[j.left], inv[j.right], j.col, j.selectivity)
              for j in joins]
    plan2, _ = plan_joins(tables2, joins2, cost="cap", server=server)
    print(f"  re-planned with shuffled table order: "
          f"cache_hit={plan2.cache_hit}, cost match="
          f"{plan2.cost == plan.cost}\n")

    # --- 3. serving a mixed workload
    print("plan server on a mixed workload "
          "(40 requests, Zipf repeats, relabelings):")
    reqs = make_workload(WorkloadSpec(n_requests=40, seed=1, n_range=(5, 9),
                                      pool_size=8, budget_frac=0.05))
    # first pass pays the first touches + cold cache; the second shows
    # the steady state a production plan server lives in
    _, _ = server.serve(reqs, closed_loop=True)
    served0, wall0 = server.stats.served, server.stats.wall_s
    responses, stats = server.serve(reqs, closed_loop=True)
    warm_rate = (stats.served - served0) / (stats.wall_s - wall0)
    cs = server.cache.stats
    print(f"  served {stats.served} plans total; steady-state "
          f"{warm_rate:,.0f} plans/s")
    print(f"  cache: {cs.hits} hits / {cs.misses} misses "
          f"(hit rate {cs.hit_rate:.0%}, {cs.relabel_hits} via relabeling)")
    print(f"  routes: {server.router.decisions}")
    print(f"  latency: {stats.latency.summary()}")

    # --- 4. concurrent submission through the async runtime
    print("\nasync front end (concurrent plan_async submitters, one "
          "scheduler):")
    # queries the server has never seen (seed disjoint from section 3's
    # pool) — their solves go through the scheduler's batch former
    fresh = [r for r in make_workload(WorkloadSpec(
        n_requests=12, seed=99, n_range=(6, 8), pool_size=12,
        cost_mix=(("max", 1.0),))) if r.q.n >= 6][:2]
    perm = np.random.default_rng(0).permutation(fresh[0].q.n)
    dup_q = relabel(fresh[0].q, perm)          # same query, relabeled
    dup_card = permute_card(fresh[0].card, fresh[0].q.n, perm)


    async def submit_concurrently():
        # a fresh miss, its relabeled duplicate (joins the same in-flight
        # solve), a second distinct miss (batches with the first), and a
        # cache hit from section 3 (overtakes everything)
        return await asyncio.gather(
            server.plan_async(fresh[0].q, fresh[0].card, cost="max"),
            server.plan_async(dup_q, dup_card, cost="max"),
            server.plan_async(fresh[1].q, fresh[1].card, cost="max"),
            server.plan_async(reqs[0].q, reqs[0].card, cost=reqs[0].cost),
        )

    r_a, r_dup, r_b, r_hot = asyncio.run(submit_concurrently())
    rt = server.async_runtime()
    rs = rt.stats
    print(f"  4 concurrent awaiters -> cost match on relabeled duplicate: "
          f"{float(r_a.cost) == float(r_dup.cost)}")
    print(f"  runtime: {rs.fast_path_hits} fast-path hits "
          f"({rs.overtakes} overtaking an in-flight solve), "
          f"{rs.coalesced} coalesced, {rs.batches} batched solves, "
          f"mean occupancy {rs.mean_batch_occupancy:.1f}")

    # --- 5. observability: per-request provenance + the metrics registry
    print("\nobservability (repro_torch.obs):")
    resp = server.plan_one(fresh[0].q, fresh[0].card, cost="max",
                           explain=True)
    exp = resp.explain
    print(f"  explain: lane={exp['lane']} method={exp['method']} "
          f"engine_tag={exp['engine_tag']} cache_hit={exp['cache_hit']} "
          f"reason={exp['reason']!r}")
    trs = rt.tracer.stats()
    print(f"  tracer: {trs['requests']} requests traced, "
          f"{trs['spans_opened']} spans, {trs['unclosed_spans']} unclosed, "
          f"{trs['lane_shape_mismatches']} lane-shape mismatches")
    print(f"  flight recorder: {rt.recorder.snapshot()['counts']}")
    for phase, row in span_phase_summary(server.registry).items():
        if row["count"]:
            print(f"    {phase:<12} n={row['count']:<4} "
                  f"p50={row['p50_ms']:.3f}ms p95={row['p95_ms']:.3f}ms")
    rt.close()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: cuda)")
    main(ap.parse_args().device)
