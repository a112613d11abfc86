"""AdamW with global-norm clipping and a cosine schedule (counterpart of
``repro.optim.adamw``).

Plain functions over the parameter tree, run under ``torch.no_grad()``:
``apply_updates`` updates the float32 masters and both moments in place
and returns them.  The arithmetic keeps the reference's order: the clip
scale multiplies ``g`` before the moments, the bias corrections come
from a float32 ``step``, then ``delta = mhat / (sqrt(nhat) + eps) + wd *
p`` and ``p - lr * delta``; weight decay applies to every leaf.  This is
not ``torch.optim.AdamW``, which decays ``p`` by ``1 - lr * wd`` before
the step, folds the second bias correction into the denominator and
does not clip.

The global norm sums the leaves in ``jax.tree`` order (``repro_torch.
tree``), as the reference does, so the two sums round alike.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient compression: "bfloat16" differentiates w.r.t. a bf16 copy
    # of the parameters; error feedback keeps the rounding residual
    grad_dtype: str = "float32"
    error_feedback: bool = True


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), as a
    float32 tensor on the step's device."""
    step = torch.as_tensor(step)
    dev = step.device
    warm = torch.clamp(step.float() / _f32(max(cfg.warmup_steps, 1), dev),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> dict:
    step_dev = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def global_norm(tree, all_reduce=None) -> torch.Tensor:
    """The norm of every leaf together, squares summed in tree order.
    ``all_reduce`` sums the partial sum of squares over data-parallel
    ranks before the root (``train.dp``)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    if all_reduce is not None:
        sq = all_reduce(sq)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptConfig, gnorm=None):
    """One AdamW step, in place.  Returns (params, opt_state, metrics):
    the trees it was given, updated.  ``gnorm`` is the clip's global
    norm when the caller has it (data-parallel shards), else the norm
    of ``grads``."""
    opt_state["step"] += 1
    step = opt_state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm.device)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g.mul(1 - b2).mul_(g))
        den = torch.div(nu, bc2).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, bc1).div_(den).add_(p * cfg.weight_decay)
        p.sub_(delta.mul_(lr))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
