"""DPconv as a tensor-contraction (einsum) path optimizer (counterpart of
``repro.planner.einsum_path``).

Einsum path optimization IS join ordering: tensors are relations, shared
indices are join predicates, and the size of an intermediate contraction
equals a join cardinality.  This module maps a multi-tensor contraction
onto a query graph + cardinality function and runs the paper's algorithms:

  * C_max  -> minimize the PEAK intermediate tensor size (device
              memory budgeting — the paper's Sec. 11 "resource-aware"
              reading), via DPconv[max] in O(2^n n^3);
  * C_out  -> minimize the TOTAL intermediate elements (memory traffic),
              via DPsub[out] / C_cap's pruned pass;
  * C_cap  -> best traffic subject to optimal peak memory.

The planner feeds ``torch.einsum`` call order (``plan_to_einsum_calls``,
``execute_plan``) and the data-pipeline join planner
(``repro_torch.planner.datajoin``).  ``plan_contraction`` solves on the
device ``optimize`` is given (CUDA unless ``device=`` says otherwise);
``execute_plan`` runs on its tensors' device.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.querygraph import QueryGraph
from repro_torch.core.dpconv import optimize, PlanResult
from repro_torch.core.jointree import JoinTree


@dataclasses.dataclass(frozen=True)
class Contraction:
    """operands: list of index strings (e.g. ["ij", "jk", "kl"]);
    output: index string; sizes: {index: dim}."""
    operands: tuple
    output: str
    sizes: dict

    @property
    def n(self) -> int:
        return len(self.operands)


class ContractionLog:
    """Append-only log of planned contractions.

    ``plan_contraction(..., logger=log)`` records every contraction it
    plans; a saved log replays through the serving tier
    (``repro_torch.service.workload.make_einsum_workload``), so the plan
    server is exercised by the contraction mix a real run actually issued
    instead of synthetic query templates only.
    """

    def __init__(self, records: "list | None" = None):
        self.records: list = list(records or [])

    def log(self, c: Contraction) -> None:
        self.records.append(c)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([{"operands": list(c.operands), "output": c.output,
                        "sizes": c.sizes} for c in self.records], f)

    @staticmethod
    def load(path: str) -> "ContractionLog":
        with open(path) as f:
            raw = json.load(f)
        return ContractionLog([
            Contraction(tuple(r["operands"]), r["output"],
                        {k: int(v) for k, v in r["sizes"].items()})
            for r in raw])


def builtin_trace() -> "list[Contraction]":
    """A canned contraction trace shaped like the repo's model stack.

    Each entry is a multi-operand tensor network mirroring an einsum
    chain the model layer actually runs (fused attention with Q/K/V
    projections, gated MLP, MoE routing, SSM state scan, LoRA update,
    cross-attention), with dims from the small-config family.  Used as
    the default replay workload when no logged trace is supplied —
    structurally real traffic: star/chain-ish graphs, heavily repeated
    index sizes (so candidate tables carry duplicates, unlike the
    synthetic generator's almost-surely-distinct random tables).
    """
    return [
        # fused attention: x·Wq, x·Wk, x·Wv, softmax-less core
        Contraction(("bsd", "dh", "bte", "eh", "btf", "fv"), "bsv",
                    {"b": 8, "s": 128, "t": 128, "d": 512, "e": 512,
                     "f": 512, "h": 64, "v": 64}),
        # attention + output projection (one more hop on the chain)
        Contraction(("bsd", "dh", "bte", "eh", "btf", "fv", "vo"), "bso",
                    {"b": 8, "s": 64, "t": 64, "d": 256, "e": 256,
                     "f": 256, "h": 64, "v": 64, "o": 256}),
        # gated MLP: up, gate and down projections around the activation
        Contraction(("bsd", "df", "dg", "fh", "gh", "he"), "bse",
                    {"b": 8, "s": 128, "d": 512, "f": 1024, "g": 1024,
                     "h": 1024, "e": 512}),
        # MoE routing: token-expert affinity folded with expert weights
        Contraction(("bsd", "de", "ef", "bsf", "fg"), "bsg",
                    {"b": 4, "s": 256, "d": 512, "e": 8, "f": 512,
                     "g": 512}),
        # SSM state scan step: input proj, state mix, gate, output proj
        Contraction(("bld", "dn", "nm", "blm", "md", "de"), "ble",
                    {"b": 8, "l": 256, "d": 256, "n": 16, "m": 16,
                     "e": 256}),
        # LoRA update: frozen path + low-rank A·B correction
        Contraction(("bsd", "dr", "rk", "bsk", "ke"), "bse",
                    {"b": 8, "s": 128, "d": 512, "r": 16, "k": 512,
                     "e": 512}),
        # cross-attention (encoder-decoder): distinct kv source length
        Contraction(("bsd", "dh", "bue", "eh", "buf", "fv", "vw"),
                    "bsw",
                    {"b": 4, "s": 64, "u": 1500, "d": 384, "e": 384,
                     "f": 384, "h": 64, "v": 64, "w": 384}),
        # pipeline of blockwise reductions (chain topology, n = 8)
        Contraction(("ab", "bc", "cd", "de", "ef", "fg", "gh", "hi"),
                    "ai",
                    {"a": 32, "b": 96, "c": 64, "d": 96, "e": 64,
                     "f": 96, "g": 64, "h": 96, "i": 32}),
    ]


def model_planner_trace(cfg=None, batch: int = 4, seq: int = 64,
                        layers: "int | None" = None,
                        logger: "ContractionLog | None" = None
                        ) -> "list[Contraction]":
    """Contractions the model stack's train/serve steps actually plan.

    Where ``builtin_trace`` is a canned sampler of *shapes* of model
    traffic, this derives the einsum structures of the model stack's
    step builders (``repro.train.steps`` in the JAX package) for a
    concrete ``ModelConfig``:
    per layer the fused-attention core (Q/K/V projections + QK^T + AV),
    the same chain extended by the output projection, and the gated MLP;
    then the chunked cross-entropy projection (``chunked_ce_loss``), the
    single-token decode attention (``make_decode_step``), and the
    family extras (MoE routing, SSM state scan, cross-attention) when
    the config enables them.  Every contraction is logged through
    ``logger`` exactly as ``plan_contraction(..., logger=)`` would, so
    the result replays through ``make_einsum_workload`` like a captured
    production log.

    The trace is deliberately *repetitive with shared structure* — every
    layer re-issues identical contractions, and the attention core is a
    sub-network of the attention+projection chain — which is the traffic
    the layer-granular fragment cache (``service.layercache``) exists
    for: repeats warm-start the C_max search, one-tensor extensions seed
    their solved sub-table.
    """
    if cfg is None:
        from repro_torch.models.common import ModelConfig
        cfg = ModelConfig(name="planner-small", family="dense",
                          n_layers=3, d_model=256, n_heads=4,
                          n_kv_heads=4, d_ff=512, vocab_size=4096)
    d = int(cfg.d_model)
    h = int(cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1)) or 64)
    ff = int(cfg.d_ff)
    out: list = []

    def emit(operands, output, sizes):
        c = Contraction(tuple(operands), output, dict(sizes))
        if logger is not None:
            logger.log(c)
        out.append(c)

    attn_sizes = {"b": batch, "s": seq, "t": seq, "d": d, "e": d,
                  "f": d, "h": h, "v": h, "o": d}
    n_layers = int(cfg.n_layers if layers is None else layers)
    for i in range(n_layers):
        # hybrids interleave attention per layer_is_attn; every other
        # attention-bearing family applies it at each layer
        attn = bool(cfg.n_heads) and (
            cfg.layer_is_attn(i) if cfg.family == "hybrid"
            else cfg.family != "ssm")
        if attn:
            # fused attention core: x·Wq, x·Wk, x·Wv, QK^T, AV
            emit(("bsd", "dh", "bte", "eh", "btf", "fv"), "bsv",
                 attn_sizes)
            # the same chain + output projection: shares the whole
            # attention-core sub-network (a leave-one-out fragment)
            emit(("bsd", "dh", "bte", "eh", "btf", "fv", "vo"), "bso",
                 attn_sizes)
            # gated MLP: up/gate/down around the activation
            emit(("bsd", "df", "dg", "fh", "gh", "he"), "bse",
                 {"b": batch, "s": seq, "d": d, "f": ff, "g": ff,
                  "h": ff, "e": d})
        if cfg.n_experts:
            # MoE routing: token-expert affinity folded through experts
            emit(("bsd", "de", "ef", "bsf", "fg"), "bsg",
                 {"b": batch, "s": seq, "d": d, "e": cfg.n_experts,
                  "f": d, "g": d})
        if cfg.ssm_state and not attn:
            # SSM state scan step: in-proj, state mix, gate, out-proj
            emit(("bld", "dn", "nm", "blm", "md", "de"), "ble",
                 {"b": batch, "l": seq, "d": d, "n": cfg.ssm_state,
                  "m": cfg.ssm_state, "e": d})
    # chunked cross-entropy (train/steps.chunked_ce_loss): the hidden
    # chunk against the unembedding, with the z-loss reduction folded
    emit(("cd", "dv", "vz"), "cz",
         {"c": 1024, "d": d, "v": int(cfg.vocab_size), "z": 1})
    # decode-step attention (make_decode_step): one query token against
    # a seq-long KV cache, through the output projection
    emit(("bd", "dh", "bte", "eh", "btf", "fv", "vo"), "bo",
         {"b": batch, "t": seq, "d": d, "e": d, "f": d, "h": h,
          "v": h, "o": d})
    if cfg.n_enc_layers:
        # encoder-decoder cross-attention: KV from the encoder frames
        emit(("bsd", "dh", "bue", "eh", "buf", "fv", "vw"), "bsw",
             {"b": batch, "s": seq, "u": int(cfg.n_frames), "d": d,
              "e": d, "f": d, "h": h, "v": h, "w": d})
    return out


def _intermediate_indices(c: Contraction, mask: int) -> set:
    """Index set of the tensor produced by fully contracting the operand
    subset ``mask``: indices appearing both inside and (outside or in the
    output)."""
    inside: set = set()
    outside = set(c.output)
    for i, op in enumerate(c.operands):
        if (mask >> i) & 1:
            inside |= set(op)
        else:
            outside |= set(op)
    return inside & outside


def cardinalities(c: Contraction) -> np.ndarray:
    """Dense (2^n,) table: size of each subset's contraction output."""
    size = 1 << c.n
    card = np.ones(size, np.float64)
    for mask in range(1, size):
        idx = _intermediate_indices(c, mask)
        v = 1.0
        for ix in idx:
            v *= c.sizes[ix]
        card[mask] = v
    return card


def query_graph(c: Contraction) -> QueryGraph:
    edges = set()
    for i in range(c.n):
        for j in range(i + 1, c.n):
            if set(c.operands[i]) & set(c.operands[j]):
                edges.add((i, j))
    return QueryGraph(c.n, tuple(sorted(edges)))


def plan_contraction(c: Contraction, cost: str = "max",
                     method: str = "dpconv", server=None,
                     logger: "ContractionLog | None" = None,
                     **kw) -> PlanResult:
    """Plan the contraction order.

    With ``server`` (a ``repro_torch.service.PlanServer``) the request goes
    through the serving path — canonicalization, plan cache, admission
    router, batched solver — instead of a direct single-query solve; the
    returned response is duck-compatible with ``PlanResult``
    (``cost`` / ``tree`` / ``meta``).  Repeated or relabeled contractions
    then hit the cache, and ``method`` is chosen by the router.

    ``logger`` records the contraction into a ``ContractionLog`` for
    later workload replay through the serving benchmark.
    """
    if logger is not None:
        logger.log(c)
    q = query_graph(c)
    card = cardinalities(c)
    if server is not None:
        budget = kw.pop("latency_budget", None)
        if kw:
            raise ValueError(
                f"solver kwargs {sorted(kw)} are not supported on the "
                "serving path (the router chooses the method and its "
                "parameters); drop them or plan without server=")
        return server.plan_one(q, card, cost=cost, latency_budget=budget)
    return optimize(q, card, cost=cost, method=method, **kw)


def greedy_plan(c: Contraction) -> tuple:
    """Greedy smallest-intermediate-first baseline (GOO-style; what
    opt_einsum's 'greedy' does in spirit).  Returns (tree, peak, total)."""
    card = cardinalities(c)
    active = [(1 << i, JoinTree(1 << i)) for i in range(c.n)]
    peak = 0.0
    total = 0.0
    while len(active) > 1:
        best = None
        for a in range(len(active)):
            for b in range(a + 1, len(active)):
                m = active[a][0] | active[b][0]
                if best is None or card[m] < best[0]:
                    best = (card[m], a, b)
        sz, a, b = best
        peak = max(peak, sz)
        total += sz
        node = JoinTree(active[a][0] | active[b][0],
                        active[a][1], active[b][1])
        new = [(m, t) for i, (m, t) in enumerate(active) if i not in (a, b)]
        new.append((node.mask, node))
        active = new
    return active[0][1], peak, total


def plan_to_einsum_calls(c: Contraction, tree: JoinTree) -> list:
    """Flatten a bushy contraction tree into pairwise einsum calls:
    [(spec, left_id, right_id, new_id), ...] — ids index a value stack
    where 0..n-1 are the original operands."""
    calls = []
    next_id = [c.n]
    idx_of: dict = {1 << i: (c.operands[i], i) for i in range(c.n)}

    def emit(t: JoinTree) -> tuple:
        if t.mask in idx_of:
            return idx_of[t.mask]
        li, lid = emit(t.left)
        ri, rid = emit(t.right)
        out_idx = "".join(sorted(_intermediate_indices(c, t.mask)))
        spec = f"{li},{ri}->{out_idx}"
        nid = next_id[0]
        next_id[0] += 1
        calls.append((spec, lid, rid, nid))
        idx_of[t.mask] = (out_idx, nid)
        return out_idx, nid

    emit(tree)
    return calls


def execute_plan(c: Contraction, tree: JoinTree, tensors: list):
    """Execute the contraction tree with pairwise ``torch.einsum`` calls,
    on the tensors' device (tests/demo)."""
    import torch
    vals = {i: tensors[i] for i in range(c.n)}
    for spec, lid, rid, nid in plan_to_einsum_calls(c, tree):
        vals[nid] = torch.einsum(spec, vals[lid], vals[rid])
    final_id = max(vals)
    out = vals[final_id]
    have = "".join(sorted(_intermediate_indices(c, (1 << c.n) - 1)))
    if have != c.output:
        out = torch.einsum(f"{have}->{c.output}", out)
    return out
