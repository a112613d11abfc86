"""SwiGLU MLP and capacity-based Mixture-of-Experts (counterpart of
``repro.models.mlp``).

MoE dispatch is the grouped GShard/Switch scheme of the reference:
  * groups = sequences (the position cumsum runs within each sequence),
  * per-group expert capacity = max(int(S * top_k / E *
    capacity_factor), 4), capped at S; overflow tokens are dropped: they
    are scattered with zero contribution at slot ``cap - 1`` and gathered
    back with weight 0,
  * scatter into a (B, E, cap, D) buffer + batched expert einsum + gather
    back.

The router's Switch load-balance loss (f·P) is returned to the caller.
Under tensor parallelism (``train.tp``) a rank runs its block of the
experts on the tokens routed to them; the routing is computed whole and
alike on every model rank, in the reference's order.
Under data parallelism its fractions are those of the whole batch: the
per-expert sums are all-reduced over the ranks (with autograd, since
P's gradient reaches every rank's router), then divided by the global
token count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, normal


def init_mlp(cfg: ModelConfig, gen: torch.Generator, lead: tuple = ()) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "wg": dense_init(gen, D, F_, lead=lead),
        "wu": dense_init(gen, D, F_, lead=lead),
        "wd": dense_init(gen, F_, D, lead=lead),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


def init_moe(cfg: ModelConfig, gen: torch.Generator, lead: tuple = ()) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)

    def experts(d_in, d_out):
        return normal(gen, lead + (E, d_in, d_out)) / (d_in ** 0.5)

    p = {
        "router": dense_init(gen, D, E, lead=lead),
        "wg": experts(D, F_),
        "wu": experts(D, F_),
        "wd": experts(F_, D),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, lead)
    return p


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, group=None,
                tp=None):
    """x: (B, S, D) -> (y, aux_loss); ``group`` is the data-parallel
    process group whose ranks hold the other rows of the batch.  With
    ``tp`` (``train.tp.TensorParallel``) whose plan splits the experts,
    ``p`` holds the rank's block of the experts (and of the shared
    experts' ``d_ff``): routing is computed whole, as on every model
    rank, each rank runs its experts, and ``y`` is its part of the sum
    over ranks."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    El = p["wg"].shape[-3]
    e0 = 0 if tp is None else tp.experts(El)
    dt = x.dtype
    cap = max(int(S * k / E * cfg.capacity_factor), 4)
    cap = min(cap, S)

    logits = (x @ p["router"].to(dt)).float()                  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1, sorted=True)      # (B,S,k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # position of each (token, slot) within its expert, group-local cumsum
    oh = F.one_hot(eidx, E).to(torch.int32)                     # (B,S,k,E)
    flat = oh.reshape(B, S * k, E)
    pos_all = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_all * flat).sum(-1).reshape(B, S, k)             # (B,S,k)
    keep = pos < cap

    # load-balance aux: Switch f·P (fraction routed × mean prob)
    if group is None:
        f_e = (oh.sum(dim=2) > 0).float().mean(dim=(0, 1))
        p_e = probs.mean(dim=(0, 1))
    else:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce
        f_e = (oh.sum(dim=2) > 0).float().sum(dim=(0, 1))
        dist.all_reduce(f_e, group=group)
        p_e = all_reduce(probs.sum(dim=(0, 1)), group=group)
        n = B * S * dist.get_world_size(group)
        f_e, p_e = f_e / n, p_e / n
    aux = E * torch.sum(f_e * p_e)
    if tp is not None and tp.plan["moe"]:
        # the aux is computed alike on every model rank: each carries
        # 1/T of its gradient (train.tp)
        aux = tp.scale_grad(aux, El / E)
        local = eidx - e0
        keep = keep & (local >= 0) & (local < El)
        eidx = local.clamp(0, El - 1)

    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S)
    buf = torch.zeros((B, El, cap, D), dtype=dt, device=x.device)
    slots = torch.where(keep, pos, cap - 1)                     # (B,S,k)
    for j in range(k):                                          # k scatters
        contrib = torch.where(keep[:, :, j, None], x, 0).to(dt)
        buf.index_put_((bidx, eidx[:, :, j], slots[:, :, j]), contrib,
                       accumulate=True)

    # batched expert swiglu: (B,E,cap,D) x (E,D,F)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"].to(dt))) * \
        torch.einsum("becd,edf->becf", buf, p["wu"].to(dt))
    out_buf = torch.einsum("becf,efd->becd", h, p["wd"].to(dt))

    y = torch.zeros_like(x)
    for j in range(k):
        gathered = out_buf[bidx, eidx[:, :, j], slots[:, :, j]]
        y = y + torch.where(keep[:, :, j, None],
                            gathered * gate[:, :, j, None].to(dt), 0)

    if cfg.n_shared_experts:
        y = y + mlp_forward(p["shared"], x)
    return y, aux
