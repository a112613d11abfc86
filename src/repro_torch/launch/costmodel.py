"""Analytic per-step cost model: FLOPs, device-memory bytes, collective
bytes (a numpy copy of ``repro.launch.costmodel``, with the layer plan
of the port's ``models.transformer``).

The FLOP and byte counts are the reference's, term by term; the
reference validates them against XLA's cost analysis, and the port's
tests hold the FLOP count against ``torch.utils.flop_counter`` on
reduced configs.  ``xla_cost_analysis`` is left out: it reads an XLA
compile, and nothing is compiled here.

Conventions:
  * FLOPs count multiply-adds as 2; backward = 2x forward for matmuls;
    full remat recomputes forward once more (the 6ND -> 8ND waste the
    roofline ratio exposes).
  * bytes = device-memory traffic: param shards + all-gathered params,
    optimizer read/write, layer-boundary activations (remat policy), and
    blocked-attention operand re-reads.
  * collective bytes = per-device link traffic under ring algorithms.
  * ``roofline_terms`` divides by one H100 SXM's data-sheet peaks
    (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import enc_plan, layer_plan

BF16 = 2
F32 = 4


@dataclasses.dataclass
class Cost:
    flops: float = 0.0           # whole-program, all devices
    hbm_bytes: float = 0.0       # whole-program, all devices
    coll_bytes: float = 0.0      # per-chip link traffic * n_chips

    def add(self, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll


def _attn_block_tokens(S: int, T: int, window: int, causal: bool,
                       qb: int = 512, kb: int = 512,
                       scheme: str = "simple") -> float:
    """Key-tokens processed per query token under the blocked schedule
    (includes the simple-schedule causal waste)."""
    if S == 1:                   # decode: scores against full cache
        return T
    nq = max(S // min(qb, S), 1)
    nk = max(T // min(kb, T), 1)
    kbe = T / nk
    if window > 0 and causal:
        wb = min((window + kbe - 1) // kbe + 1, nk)
        return wb * kbe
    if causal:
        if scheme == "zigzag" and nq % 2 == 0 and nq == nk:
            # balanced pairing: (nq/2) pairs x (nq+1) block-visits
            return T * (nq + 1) / (2.0 * nq)
        return T                 # all kb iterated, half masked (waste)
    return T


def _layer_cost(cfg: ModelConfig, slot, B: int, S: int, T: int,
                kind: str, c: Cost, n_chips: int, tp: int, dp: int,
                opts: dict | None = None):
    """One sub-layer, whole-program numbers.  kind: train|prefill|decode."""
    opts = opts or {}
    scheme = opts.get("attn_scheme", "simple")
    remat = opts.get("remat", "full")
    D, H, K, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    tok = B * S
    # fwd(1) + bwd(2) + remat re-fwd(1 for "full", ~0 for "dots" which
    # saves matmul outputs and replays only elementwise ops)
    train_mult = 4.0 if remat == "full" else 3.0
    fwd_mult = {"train": train_mult, "prefill": 1.0, "decode": 1.0}[kind]

    if slot.kind == "ssm":
        Di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        proj = 2 * tok * D * (2 * Di + 2 * N + Hs) + 2 * tok * Di * D
        if kind == "decode":
            ssd = 2 * B * (Hs * N * P) * 3          # state update + readout
        else:
            Q = min(cfg.ssm_chunk, S)
            ssd = (2 * tok * Q * N                  # C·B^T chunk scores
                   + 2 * tok * Q * Hs * P           # intra-chunk apply
                   + 4 * tok * Hs * N * P)          # states + inter-chunk
        c.add(flops=(proj + ssd) * fwd_mult,
              hbm=tok * Di * BF16 * 4 * fwd_mult)
        params_b = (D * (2 * Di + 2 * N + Hs) + Di * D) * BF16
        gm = 3 if remat == "full" else 2
        c.add(coll=params_b * (gm if kind == "train" else 0)
              + (tok * D * BF16 * ((dp - 1) / dp if dp > 1 else 0)
                 if kind != "train" else 0))
        return

    # attention
    kt = _attn_block_tokens(S, T, slot.window, causal=True, scheme=scheme)
    qkv = 2 * tok * D * (H * hd + 2 * K * hd) + 2 * tok * (H * hd) * D
    scores = 2 * B * H * S * kt * hd * 2             # QK^T and PV
    c.add(flops=(qkv + scores) * fwd_mult,
          hbm=(tok * (H + 2 * K) * hd * BF16 * 3
               + B * H * S * (kt / 512) * hd * BF16) * fwd_mult)
    attn_params = D * (H * hd) * 2 + D * (K * hd) * 2
    # TP partial-sum all-reduce on the residual (fwd [+bwd])
    tp_ar = tok * D * BF16 * (2 if kind == "train" else 1) * 2 * (
        (tp - 1) / tp if tp > 1 else 0)
    gather_mult = 3 if remat == "full" else 2   # re-fwd re-gathers
    if kind == "train":
        # FSDP param all-gather: fwd + bwd (+ remat re-fwd)
        c.add(coll=attn_params * BF16 * gather_mult + tp_ar)
    else:
        # serving: 2D weight-stationary sharding reduces activation
        # partial sums over the data axes instead of gathering weights
        dp_ar = tok * D * BF16 * 2 * ((dp - 1) / dp if dp > 1 else 0)
        c.add(coll=tp_ar + dp_ar)

    if slot.cross:
        cross_kt = cfg.n_frames
        c.add(flops=(2 * tok * D * (H * hd + 2 * K * hd)
                     + 2 * tok * H * hd * D
                     + 2 * B * H * S * cross_kt * hd * 2) * fwd_mult)

    # mlp / moe
    if slot.moe:
        E, k_top, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
        router = 2 * tok * D * E
        if kind == "decode":
            # dense one-hot dispatch: every local expert runs all B tokens
            routed = 2 * tok * E * 3 * D * F
        else:
            routed = 2 * (tok * k_top * cf) * 3 * D * F
        shared = 2 * tok * 3 * D * F * cfg.n_shared_experts
        c.add(flops=(router + routed + shared) * fwd_mult)
        moe_params = (E * 3 * D * F + cfg.n_shared_experts * 3 * D * F
                      + D * E) * BF16
        a2a = tok * k_top * cf * D * BF16 * 2 * (
            (tp - 1) / tp if tp > 1 else 0)
        if kind == "train":
            c.add(coll=moe_params * gather_mult + a2a * 2)
        else:
            c.add(coll=tok * D * BF16 * 2 * ((tp - 1) / tp
                                             if tp > 1 else 0))
    else:
        c.add(flops=2 * tok * 3 * D * F * fwd_mult)
        tp_ar = tok * D * BF16 * (2 if kind == "train" else 1) * (
            (tp - 1) / tp if tp > 1 else 0)
        if kind == "train":
            c.add(coll=3 * D * F * BF16 * gather_mult + tp_ar)
        else:
            dp_ar = tok * D * BF16 * ((dp - 1) / dp if dp > 1 else 0)
            c.add(coll=tp_ar + dp_ar)

    if slot.shared_attn:
        shared_slot = dataclasses.replace(slot, kind="attn",
                                          shared_attn=False, moe=False)
        _layer_cost(cfg, shared_slot, B, S, T, kind, c, n_chips, tp, dp,
                    opts)


def step_cost(cfg: ModelConfig, shape: ShapeSpec, n_chips: int = 256,
              tp: int = 16, accum: int = 1,
              opts: dict | None = None) -> Cost:
    """Whole-program cost of one train/prefill/decode step.

    opts: {"attn_scheme": "simple"|"zigzag", "remat": "full"|"dots"}
    """
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    c = Cost()
    dp = n_chips // tp
    V, D = cfg.padded_vocab, cfg.d_model

    if kind == "decode":
        S_eff, T = 1, S
        tok = B
    else:
        S_eff, T = S, S
        tok = B * S

    plans = [(layer_plan(cfg), B, S_eff, T)]
    if cfg.family == "encdec" and kind != "decode":
        plans.append((enc_plan(cfg), B, cfg.n_frames, cfg.n_frames))

    for plan, b_, s_, t_ in plans:
        for repeats, slots in plan:
            for slot in slots:
                unit = Cost()
                _layer_cost(cfg, slot, b_, s_, t_, kind, unit, n_chips,
                            tp, dp, opts)
                c.add(unit.flops * repeats, unit.hbm_bytes * repeats,
                      unit.coll_bytes * repeats)

    # embedding + unembed/loss
    fwd_mult = 4.0 if kind == "train" else 1.0
    unemb_mult = 3.0 if kind == "train" else 1.0   # loss chunk remat: +2
    if kind == "decode":
        c.add(flops=2 * B * D * V)
    else:
        c.add(flops=2 * tok * D * V * unemb_mult,
              hbm=tok * D * BF16 * 2 * unemb_mult)
    c.add(hbm=tok * 4 * 2)                          # token ids

    # params/optimizer HBM + gradient reduce-scatter
    n_params = cfg.param_count()
    if kind == "train":
        # optimizer: read p, mu, nu; write p, mu, nu (f32)
        c.add(hbm=n_params * F32 * 6)
        c.add(hbm=n_params * BF16 * 3)              # cast+AG buffers
        c.add(coll=n_params * F32)                  # grad reduce-scatter
    else:
        c.add(hbm=n_params * BF16)
    if kind == "decode":
        # cache read+write traffic; int8 KV halves
        # the attention-cache bytes (+ per-entry scales, ~1/hd overhead)
        kv_b = (1 + 4.0 / cfg.hd if (opts or {}).get("kv_cache_dtype")
                == "int8" else BF16) if cfg.n_heads else BF16
        kv = 0
        for repeats, slots in layer_plan(cfg):
            for slot in slots:
                if slot.kind == "ssm":
                    kv += repeats * B * cfg.ssm_heads * cfg.ssm_state * \
                        cfg.ssm_head_dim * F32 * 2
                else:
                    Cl = min(slot.window, S) if slot.window else S
                    kv += repeats * B * Cl * cfg.n_kv_heads * cfg.hd * \
                        kv_b * 2
                if slot.shared_attn:
                    kv += repeats * B * S * cfg.n_kv_heads * cfg.hd * \
                        kv_b * 2
        c.add(hbm=kv)
    return c


# hardware constants per card: NVIDIA H100 SXM data sheet, dense rates
# (no sparsity), at the full 700 W power limit
PEAK_FLOPS = 989e12      # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
LINK_BW = 450e9          # NVLink bytes/s per direction


def roofline_terms(cfg: ModelConfig, shape: ShapeSpec,
                   n_chips: int = 256, tp: int = 16,
                   opts: dict | None = None) -> dict:
    c = step_cost(cfg, shape, n_chips=n_chips, tp=tp, opts=opts)
    t_c = c.flops / n_chips / PEAK_FLOPS
    t_m = c.hbm_bytes / n_chips / HBM_BW
    t_l = c.coll_bytes / n_chips / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    bound = max(terms, key=terms.get)
    # mfu_bound: useful (6ND-convention) compute time over the step-time
    # lower bound
    n_act = cfg.active_param_count()
    tokens = shape.seq_len * shape.global_batch if shape.kind != "decode" \
        else shape.global_batch
    mult = 6.0 if shape.kind == "train" else 2.0
    useful_t = mult * n_act * tokens / n_chips / PEAK_FLOPS
    return {
        "flops": c.flops, "hbm_bytes": c.hbm_bytes,
        "coll_bytes": c.coll_bytes,
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_l,
        "bottleneck": bound,
        "step_time_lb": max(terms.values()),
        "roofline_frac": t_c / max(terms.values()),
        "mfu_bound": useful_t / max(terms.values()),
    }
