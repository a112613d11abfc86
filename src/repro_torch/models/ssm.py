"""Mamba-2 (SSD — state-space duality) layer (counterpart of
``repro.models.ssm``): the chunked train/prefill path and the O(1)
decode step.  arXiv:2405.21060.

Chunked SSD: the sequence is split into chunks of Q tokens; quadratic
attention-like compute inside chunks, linear state passing between
chunks (a Python loop over chunks where the reference scans).  Decode
carries (conv_state, ssm_state): constant memory per token.

The depthwise causal conv is ``F.conv1d(groups=C)`` on the (B, C, L)
view with W-1 zeros on the left: a cross-correlation, like XLA's
``conv_general_dilated``, so the kernel is not flipped.  ``jnp.split``
takes split indices where ``torch.split`` takes sizes.

Single B/C group (G = 1), heads H = d_inner / head_dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, full, \
    normal, rms_norm


def init_ssm(cfg: ModelConfig, gen: torch.Generator, lead: tuple = ()) -> dict:
    D, Di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv_width)
    conv_ch = Di + 2 * N
    return {
        "in_proj": dense_init(gen, D, 2 * Di + 2 * N + H, lead=lead),
        "conv_w": normal(gen, tuple(lead) + (W, conv_ch)) / W ** 0.5,
        "conv_b": full(lead, (conv_ch,), 0.0, gen),
        "A_log": full(lead, (H,), 0.0, gen),        # a = -exp(A_log)
        "dt_bias": full(lead, (H,), -2.0, gen),     # softplus ~ 0.12
        "D": full(lead, (H,), 1.0, gen),
        "norm": full(lead, (Di,), 0.0, gen),
        "out_proj": dense_init(gen, Di, D, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv.  x: (B, L, C); w: (W, C)."""
    W = w.shape[0]
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))              # (B, C, W-1+L)
    out = F.conv1d(xt, w.to(x.dtype).t()[:, None, :], groups=x.shape[-1])
    return out.transpose(1, 2) + b.to(x.dtype)


def _split_proj(p, x, cfg: ModelConfig):
    Di, N = cfg.d_inner, cfg.ssm_state
    dt_x = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(
        dt_x, [Di, Di + 2 * N, dt_x.shape[-1] - 2 * Di - 2 * N], dim=-1)
    return z, xbc, dt


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D).  L is padded to a multiple of the chunk;
    the padded tail tokens are causally inert."""
    B, L0, D = x.shape
    Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, L0)
    L = ((L0 + Q - 1) // Q) * Q
    Cn = L // Q
    dt_c = x.dtype

    z, xbc, dt = _split_proj(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    if L != L0:
        xbc = F.pad(xbc, (0, 0, 0, L - L0))
        dt = F.pad(dt, (0, 0, 0, L - L0))
    xs, Bv, Cv = torch.split(xbc, [Di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,L,H) f32
    a = -torch.exp(p["A_log"])                             # (H,)
    dA = dt * a                                            # (B,L,H)

    # chunk views
    xs = xs.reshape(B, Cn, Q, H, P)
    Bc = Bv.reshape(B, Cn, Q, N).float()
    Cc = Cv.reshape(B, Cn, Q, N).float()
    dtc = dt.reshape(B, Cn, Q, H)
    dAc = dA.reshape(B, Cn, Q, H)
    cum = torch.cumsum(dAc, dim=2)                         # (B,Cn,Q,H)

    X = xs.float() * dtc[..., None]                        # dt-weighted x

    # intra-chunk (quadratic in Q)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,Cn,Q,K,H)
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), 0.0)
    y_intra = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", cb, decay, X)

    # chunk states
    w_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,Cn,Q,H)
    S_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bc, w_end, X)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,Cn,H)

    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(Cn):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(prevs, dim=1)                     # (B,Cn,H,N,P)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum),
                           S_prev)

    y = (y_intra + y_inter).reshape(B, L, H, P)
    y = y + p["D"][None, None, :, None] * xs.reshape(B, L, H, P).float()
    y = y.reshape(B, L, Di)[:, :L0].to(dt_c)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(dt_c)


# ---------------------------------------------------------------- decode
def ssm_init_cache(cfg: ModelConfig, batch: int, dtype,
                   device=None, lead: tuple = ()) -> dict:
    Di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim, cfg.ssm_conv_width)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, W - 1, Di + 2 * N), dtype=dtype,
                            device=device),
        "state": torch.zeros(lead + (batch, H, N, P), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(p: dict, cache: dict, x1: torch.Tensor, cfg: ModelConfig):
    """x1: (B, 1, D).  Returns (y (B,1,D), new cache)."""
    B = x1.shape[0]
    Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    dt_c = x1.dtype
    z, xbc, dt = _split_proj(p, x1, cfg)
    hist = torch.cat([cache["conv"], xbc], dim=1)          # (B, W, C)
    conv_out = (hist * p["conv_w"].to(dt_c)[None]).sum(
        dim=1, keepdim=True) + p["conv_b"].to(dt_c)
    xbc1 = F.silu(conv_out)                                # (B,1,C)
    xs, Bv, Cv = torch.split(xbc1, [Di, N, N], dim=-1)
    xs = xs.reshape(B, H, P).float()
    Bv = Bv.reshape(B, N).float()
    Cv = Cv.reshape(B, N).float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt1 * a)                               # (B,H)
    X = xs * dt1[..., None]                                # (B,H,P)
    s_new = cache["state"] * dec[..., None, None] + \
        torch.einsum("bn,bhp->bhnp", Bv, X)
    y = torch.einsum("bn,bhnp->bhp", Cv, s_new) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, Di).to(dt_c)
    y = rms_norm(y * F.silu(z), p["norm"])
    y = y @ p["out_proj"].to(dt_c)
    return y, {"conv": hist[:, 1:], "state": s_new}
