"""GQA attention (counterpart of ``repro.models.attention``): the chunked
lazy-softmax train/prefill path and the decode path.

  * The prefill never materializes (S × T) scores: the lazy-softmax block
    algorithm (running max / denominator) runs as nested Python loops
    over query and key blocks, with f32 scores and accumulators, as the
    reference's nested ``lax.scan`` does.  The matrix products are torch
    einsums; no fused attention call is used, so the port is held to the
    reference's arithmetic.
  * Sliding-window layers visit only the trailing kv blocks inside the
    window (a static count per query block); causal global layers visit
    every kv block with a mask, or the balanced ``zigzag`` schedule.
  * ``NEG_INF`` is finite on purpose: a fully masked block (a clipped
    window offset, a future block) gives p = 1 rows that the ``corr`` of
    a later real block multiplies by exactly 0.  With ``-inf`` the same
    path gives NaN.
  * GQA head order: q is viewed as (B, S, K, G, hd), so head h = k·G + g,
    in the prefill, the decode and the cross-attention decode.
  * Decode keeps a ring buffer of length ``window`` for local layers and
    the full length for global ones; it writes the new entry into the
    cache tensors in place and returns them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, full, \
    rms_norm, rope

NEG_INF = -1e30


# ------------------------------------------------------------------ params
def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   lead: tuple = ()) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, D, H * hd, lead=lead),
        "wk": dense_init(gen, D, K * hd, lead=lead),
        "wv": dense_init(gen, D, K * hd, lead=lead),
        "wo": dense_init(gen, H * hd, D, scale=1.0 / (H * hd) ** 0.5,
                         lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = full(lead, (H * hd,), 0.0, gen)
        p["bk"] = full(lead, (K * hd,), 0.0, gen)
        p["bv"] = full(lead, (K * hd,), 0.0, gen)
    if cfg.qk_norm:
        p["q_norm"] = full(lead, (hd,), 0.0, gen)
        p["k_norm"] = full(lead, (hd,), 0.0, gen)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 x_kv: torch.Tensor | None = None):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,T,K,hd).  H and K are the
    heads of the projections given: under tensor parallelism a rank's
    query heads and the KV heads they read (``train.tp``)."""
    hd = cfg.hd
    H, K = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    dt = x.dtype
    xkv = x if x_kv is None else x_kv
    q = x @ p["wq"].to(dt)
    k = xkv @ p["wk"].to(dt)
    v = xkv @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(q.shape[:-1] + (H, hd))
    k = k.reshape(k.shape[:-1] + (K, hd))
    v = v.reshape(v.shape[:-1] + (K, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


# ------------------------------------------------- chunked lazy-softmax core
class _Acc(NamedTuple):
    m: torch.Tensor     # (B, K, G, QB) running max (f32)
    l: torch.Tensor     # (B, K, G, QB) running denom (f32)
    o: torch.Tensor     # (B, K, G, QB, hd) running numerator (f32)


def _acc0(B, K, G, q_block, hd, device) -> _Acc:
    return _Acc(
        torch.full((B, K, G, q_block), NEG_INF, dtype=torch.float32,
                   device=device),
        torch.zeros((B, K, G, q_block), dtype=torch.float32, device=device),
        torch.zeros((B, K, G, q_block, hd), dtype=torch.float32,
                    device=device))


def _block_step(acc: _Acc, q, kb, vb, mask, scale) -> _Acc:
    """q: (B,K,G,QB,hd); kb/vb: (B,KB,K,hd); mask: (B,1,1,QB,KB) bool."""
    s = torch.einsum("bkgqh,btkh->bkgqt", q.float(), kb.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(acc.m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(acc.m - m_new)
    l_new = acc.l * corr + p.sum(dim=-1)
    o_new = acc.o * corr[..., None] + torch.einsum(
        "bkgqt,btkh->bkgqh", p, vb.float())
    return _Acc(m_new, l_new, o_new)


def _finish(acc: _Acc, dtype) -> torch.Tensor:
    return (acc.o / torch.clamp_min(acc.l, 1e-30)[..., None]).to(dtype)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool,
                      window: int, q_block: int = 512,
                      k_block: int = 512,
                      scheme: str = "simple") -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,K,hd), positions (B,S)/(B,T).

    Returns (B, S, H, hd).  window > 0 limits attention to keys with
    q_pos - k_pos < window (and >= 0 if causal).

    scheme="zigzag" (causal global layers only): pair query block i with
    block nq-1-i; each pair needs exactly nq+1 kv-block visits, so the
    lower-triangle work is covered with about half the block-steps of the
    simple schedule (which visits all nk blocks and masks the future).
    """
    B, S0, H, hd = q.shape
    T0, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / (hd ** 0.5)
    q_block = min(q_block, S0)
    k_block = min(k_block, T0)
    # pad sequence axes to block multiples; padded keys get position -1
    # and are masked out, padded query rows are sliced off at the end
    S = ((S0 + q_block - 1) // q_block) * q_block
    T = ((T0 + k_block - 1) // k_block) * k_block
    if S != S0:
        q = F.pad(q, (0, 0, 0, 0, 0, S - S0))
        q_pos = F.pad(q_pos, (0, S - S0))
    if T != T0:
        k = F.pad(k, (0, 0, 0, 0, 0, T - T0))
        v = F.pad(v, (0, 0, 0, 0, 0, T - T0))
        k_pos = F.pad(k_pos, (0, T - T0), value=-1)
    nq, nk = S // q_block, T // k_block
    qg = q.reshape(B, nq, q_block, K, G, hd).permute(1, 0, 3, 4, 2, 5)
    # (nq, B, K, G, QB, hd)
    kg = k.reshape(B, nk, k_block, K, hd).transpose(0, 1)
    vg = v.reshape(B, nk, k_block, K, hd).transpose(0, 1)
    qp = q_pos.reshape(B, nq, q_block).transpose(0, 1)      # (nq, B, QB)
    kp = k_pos.reshape(B, nk, k_block).transpose(0, 1)      # (nk, B, KB)

    if window > 0:
        w_blocks = min((window + k_block - 1) // k_block + 1, nk)
    else:
        w_blocks = nk

    if (scheme == "zigzag" and causal and window <= 0 and S == T
            and nq % 2 == 0 and nq == nk and nq >= 2):
        return _zigzag_causal(qg, kg, vg, qp, kp, B, K, G, hd, q_block,
                              nq, scale, q.dtype)[:, :S0]

    n_steps = w_blocks if (window > 0 and causal) else nk
    outs = []
    for qi in range(nq):
        acc = _acc0(B, K, G, q_block, hd, q.device)
        qp_b = qp[qi]
        for off in range(n_steps):
            # static offset -> kv block index (windowed: trailing blocks)
            raw_idx = qi - (w_blocks - 1) + off \
                if (window > 0 and causal) else off
            kb_idx = min(max(raw_idx, 0), nk - 1)
            kpb = kp[kb_idx]
            rel = qp_b[:, :, None] - kpb[:, None, :]        # (B, QB, KB)
            mask = kpb[:, None, :] >= 0                     # padded keys
            # clipped (out-of-range) offsets must not recount block 0
            mask = mask & (raw_idx == kb_idx)
            if causal:
                mask = mask & (rel >= 0)
            if window > 0:
                mask = mask & (rel < window)
            # blocks wholly in the future contribute nothing
            if causal and window <= 0:
                mask = mask & (kb_idx <= qi)
            acc = _block_step(acc, qg[qi], kg[kb_idx], vg[kb_idx],
                              mask[:, None, None, :, :], scale)
        outs.append(_finish(acc, q.dtype))
    # outs: nq × (B, K, G, QB, hd) -> (B, S, H, hd), drop query padding
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)
    return out[:, :S0]


def _zigzag_causal(qg, kg, vg, qp, kp, B, K, G, hd, q_block, nq, scale,
                   dtype):
    """Balanced causal schedule: pair (i, nq-1-i) shares one kv sweep of
    exactly nq+1 block-visits — no masked-future block waste."""
    npairs = nq // 2
    outs_lo, outs_hi = [], []
    for i in range(npairs):
        hi = nq - 1 - i
        acc_lo = _acc0(B, K, G, q_block, hd, qg.device)
        acc_hi = _acc0(B, K, G, q_block, hd, qg.device)
        for t in range(nq + 1):
            use_lo = t <= i
            kb_idx = min(t, i) if use_lo else max(t - (i + 1), 0)
            kpb = kp[kb_idx]
            qp_d = qp[i] if use_lo else qp[hi]
            rel = qp_d[:, :, None] - kpb[:, None, :]
            mask = ((rel >= 0) & (kpb[:, None, :] >= 0))[:, None, None]
            if use_lo:
                acc_lo = _block_step(acc_lo, qg[i], kg[kb_idx], vg[kb_idx],
                                     mask, scale)
            else:
                acc_hi = _block_step(acc_hi, qg[hi], kg[kb_idx],
                                     vg[kb_idx], mask, scale)
        outs_lo.append(_finish(acc_lo, dtype))
        outs_hi.append(_finish(acc_hi, dtype))
    # original q-block order: [lo_0..lo_{p-1}, hi reversed]
    outs = torch.stack(outs_lo + outs_hi[::-1])
    S = nq * q_block
    return outs.permute(1, 0, 4, 2, 3, 5).reshape(B, S, K * G, hd)


# ------------------------------------------------------------ full forward
def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, window: int, causal: bool = True,
                 enc_out: torch.Tensor | None = None,
                 enc_pos: torch.Tensor | None = None,
                 theta: float | None = None, scheme: str = "simple"):
    """Returns (out (B,S,D), (k, v)) — k/v returned for cache building.
    With a rank's heads (``train.tp``) ``wo`` holds their rows, and the
    output is the rank's part of the sum over heads."""
    theta = theta if theta is not None else cfg.rope_theta
    q, k, v = _project_qkv(p, x, cfg, x_kv=enc_out)
    if enc_out is None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
        k_pos = positions
    else:
        # cross-attention: no rope (whisper-style), encoder positions
        k_pos = enc_pos
    o = chunked_attention(q, k, v, positions, k_pos,
                          causal=causal and enc_out is None, window=window,
                          scheme=scheme)
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    return out, (k, v)


# ----------------------------------------------------------------- decode
def _kv_quantize(x: torch.Tensor, dtype):
    """x: (B, K, hd) -> (int8 values, per-(B,K) scales).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    s = torch.amax(torch.abs(x.float()), dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(x.float() / s[..., None]),
                    -127, 127).to(dtype)
    return q, s


def _attend_one(q, kf, vf, valid, tp=None, seq=None):
    """One new token's attention: query heads ``q`` (B, 1, Hq, hd)
    against float32 entries ``kf``/``vf`` (B, C, Kc, hd) where ``valid``
    (B, C) holds (all of them for ``None``); returns the heads' outputs
    as (B, 1, Hq·hd) float32.

    Under tensor parallelism (``tp``, ``train.tp``): where the rank's
    query heads read KV columns of a cache that holds every KV head, it
    reads those columns.  ``seq`` is the group whose ranks hold
    consecutive blocks of the cache's sequence axis (``None``: the rank
    holds all of it): each rank takes the softmax of its block against
    the max over every block (a float32 max all-reduce), and the
    weighted values and the sums are added over the ranks (one float32
    all-reduce); a block wholly masked gives exp(NEG_INF - max) = 0.
    When that group is 'model' and the heads are split, the rank first
    gathers every rank's query heads, which are tiny, and keeps its own
    heads' outputs."""
    B, _, Hq, hd = q.shape
    gather = tp is not None and seq is tp and tp.plan["attn"]
    if gather:
        q = tp.gather_heads(q)
    elif tp is not None and tp.plan["attn"] and not tp.plan["kv"]:
        lo, hi = (c // hd for c in tp.kv_columns())
        kf, vf = kf[:, :, lo:hi], vf[:, :, lo:hi]
    K = kf.shape[2]
    qf = q.reshape(B, 1, K, q.shape[2] // K, hd).float()
    s = torch.einsum("bqkgh,btkh->bkgqt", qf, kf) / (hd ** 0.5)
    if valid is not None:
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if seq is None:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkh->bqkgh", w, vf)
    else:
        import torch.distributed as dist
        m = seq.all_reduce(s.amax(dim=-1, keepdim=True),
                           op=dist.ReduceOp.MAX)
        p = torch.exp(s - m)
        o = torch.einsum("bkgqt,btkh->bqkgh", p, vf)
        both = seq.all_reduce(torch.cat([o.reshape(-1),
                                         p.sum(dim=-1).reshape(-1)]))
        n = o.numel()
        o = both[:n].view(o.shape) / both[n:].view(
            B, 1, K, o.shape[3], 1)
    o = o.reshape(B, 1, -1)
    return o.narrow(2, tp.rank * Hq * hd, Hq * hd) if gather else o


def attn_decode(p: dict, cache_k, cache_v, x1: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, *, window: int,
                theta: float | None = None, k_scale=None, v_scale=None,
                tp=None, seq=None):
    """Single-token decode.  x1: (B, 1, D); pos: (B,) current position.
    cache_k/v: (B, C, K, hd) with C = window (ring) or max seq (global).
    With int8 caches, k_scale/v_scale are (B, C, K) per-entry scales.
    The new entry is written into the cache tensors in place.
    Returns (out (B,1,D), cache_k, cache_v[, k_scale, v_scale]).

    Under tensor parallelism (``tp``) ``p`` holds the rank's serving
    leaves and the cache the rank's block of it; the output is the
    rank's part of the sum over heads where the heads are split.  With
    ``seq`` (see ``_attend_one``) the cache holds block ``seq.rank`` of
    C / ``seq.world`` entries of the sequence (or ring) axis: positions
    and the ring's slot ``pos % C`` are those of the whole axis, and only
    the rank that holds the slot writes the new entry; int8 scales that
    ``cache_specs`` keeps whole are written by every rank (each computes
    every KV head)."""
    theta = theta if theta is not None else cfg.rope_theta
    B, C, K, hd = cache_k.shape
    quant = cache_k.dtype == torch.int8
    q, k, v = _project_qkv(p, x1, cfg)
    q = rope(q, pos[:, None], theta)
    k = rope(k, pos[:, None], theta)
    bidx = torch.arange(B, device=pos.device)
    off = 0 if seq is None else seq.rank * C
    Cg = C if seq is None else C * seq.world
    slot = (pos % Cg) if window > 0 else pos                # (B,)
    if quant:
        kq, ks = _kv_quantize(k[:, 0], cache_k.dtype)
        vq, vs = _kv_quantize(v[:, 0], cache_v.dtype)
        news = [(cache_k, kq), (cache_v, vq), (k_scale, ks),
                (v_scale, vs)]
    else:
        news = [(cache_k, k[:, 0].to(cache_k.dtype)),
                (cache_v, v[:, 0].to(cache_v.dtype))]
    if seq is None:
        for cache, new in news:
            cache[bidx, slot] = new
    else:
        local = slot - off
        own = (local >= 0) & (local < C)
        li = local.clamp(0, C - 1)
        for cache, new in news:
            if cache.shape[1] == Cg:            # whole (int8 scales)
                cache[bidx, slot] = new
            else:
                keep = own.view((B,) + (1,) * (new.ndim - 1))
                cache[bidx, li] = torch.where(keep, new, cache[bidx, li])
    # key positions: the ring holds pos - age; global holds the index
    idx = torch.arange(C, device=pos.device)[None, :]
    if seq is not None:
        idx = idx + off
    if window > 0:
        kpos = torch.where(
            idx <= slot[:, None], pos[:, None] - (slot[:, None] - idx),
            pos[:, None] - (slot[:, None] + Cg - idx))
        valid = (kpos >= 0) & (pos[:, None] - kpos < window)
    else:
        valid = idx <= pos[:, None]
    kf = cache_k.float()
    vf = cache_v.float()
    if quant:
        ksc, vsc = k_scale, v_scale
        if ksc.shape[1] != C:
            ksc, vsc = ksc.narrow(1, off, C), vsc.narrow(1, off, C)
        kf = kf * ksc[..., None]
        vf = vf * vsc[..., None]
    o = _attend_one(q, kf, vf, valid, tp, seq)
    out = o.to(x1.dtype) @ p["wo"].to(x1.dtype)
    if quant:
        return out, cache_k, cache_v, k_scale, v_scale
    return out, cache_k, cache_v


def cross_attn_decode(p: dict, enc_k, enc_v, x1: torch.Tensor,
                      cfg: ModelConfig, tp=None, seq=None) -> torch.Tensor:
    """Decoder cross-attention against fixed encoder kv (B, T, K, hd);
    under tensor parallelism as ``attn_decode`` (``seq`` splits T)."""
    B = x1.shape[0]
    hd = cfg.hd
    dt = x1.dtype
    q = x1 @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q.reshape(B, 1, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    o = _attend_one(q, enc_k.float(), enc_v.float(), None, tp, seq)
    return o.to(dt) @ p["wo"].to(dt)
