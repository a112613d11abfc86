"""Train and serve step builders (counterpart of ``repro.train.steps``).

Training: ``chunked_ce_loss``, ``make_loss_fn``, ``make_grad_step``,
``make_train_step`` and ``init_train_state``.
  * Chunked cross-entropy: the hidden states are projected V-wards
    ``chunk`` tokens at a time, and each chunk's (chunk, V) logits are
    recomputed in the backward pass (``torch.utils.checkpoint``,
    non-reentrant; the reference's ``jax.checkpoint`` scan body), so no
    (tokens, V) logits are kept.
  * Gradients are taken with respect to a compute-dtype copy of the
    float32 masters, made once per step as fresh leaves: ``bfloat16``
    with ``grad_dtype="bfloat16"`` (compressed gradients), else
    ``cfg.cdtype`` (a float32 leaf is aliased, not copied).
  * ``accum`` microbatches run in turn; their gradients add up in the
    leaves' ``.grad`` and are divided by ``accum``, as the reference's
    scan does.  With compression, ``ef-sim`` error feedback keeps the
    rounding residual in ``state["residual"]``.
  * The state (``{"params", "opt": {"mu", "nu", "step"}[, "residual"]}``,
    the reference's paths) is updated in place by
    ``optim.adamw.apply_updates`` and returned.

Serving: ``cast_tree``, ``make_prefill_step`` and ``make_decode_step``.
The reference casts the float32 parameters to the compute dtype inside
every jitted step, where XLA fuses the cast away.  Run eagerly, that
cast would read and write every weight on every decode step, so each
serve step casts once, the first time it sees a parameter tree, and
keeps the cast copy for as long as it is handed the same tree (the same
``LM`` or dict object).  The cast is deterministic, so the numbers are
those of a cast per call.  The train steps do not cache the cast: the
masters change every step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.tree import tree_leaves, tree_map


def _ce_chunk(xc, unembed, lc, vc, tp=None):
    logits = (xc @ unembed).float()
    if tp is not None and tp.plan["vocab"]:
        lse, ll = tp.vocab_ce(logits, lc)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, 1, lc[:, None])[:, 0]
    ce = ((lse - ll) * vc).sum()
    z = ((lse * lse) * vc).sum()
    return ce, z, vc.sum()


def chunked_ce_loss(x: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor,
                    chunk: int = 1024, z_coef: float = 1e-4, count=None,
                    tp=None):
    """x: (B,S,D) hidden; labels/valid: (B,S).  Mean CE over valid tokens
    (and the z-loss), computed ``chunk`` tokens at a time so that peak
    logits memory is (chunk, V).  Returns (loss, ce).  ``count`` is the
    number of valid tokens to divide by, where these rows are one rank's
    part of a microbatch (by default the valid tokens of ``valid``).
    With ``tp`` whose plan splits the vocabulary, ``unembed`` is the
    rank's (D, V/T) block and each chunk's logsumexp and label logit are
    taken over every rank's block (``train.tp.TensorParallel.vocab_ce``);
    every model rank then returns the same loss."""
    B, S, D = x.shape
    n = B * S
    chunk = min(chunk, n)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    xf = F.pad(x.reshape(n, D), (0, 0, 0, n_pad - n))
    lf = F.pad(labels.reshape(n).long(), (0, n_pad - n))
    vf = F.pad(valid.reshape(n).float(), (0, n_pad - n))
    body = _ce_chunk
    if torch.is_grad_enabled():
        def body(*args):
            return checkpoint(_ce_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ce, z, cnt = zero, zero, zero
    for i in range(0, n_pad, chunk):
        c_ce, c_z, c_cnt = body(xf[i:i + chunk], unembed,
                                lf[i:i + chunk], vf[i:i + chunk], tp)
        ce, z, cnt = ce + c_ce, z + c_z, cnt + c_cnt
    cnt = torch.clamp(cnt if count is None else count, min=1.0)
    return ce / cnt + z_coef * z / cnt, ce / cnt


def cast_tree(tree, dtype):
    """Floating leaves to ``dtype`` (a leaf already of ``dtype`` is kept,
    not copied); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class _CastOnce:
    """The compute-dtype copy of the last parameter tree handed in."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._src = None
        self._cast = None

    def __call__(self, params):
        if params is not self._src:
            self._src = params
            self._cast = cast_tree(tfm._as_tree(params), self.cfg.cdtype)
        return self._cast


def make_loss_fn(cfg: ModelConfig, aux_coef: float = 1e-2,
                 z_coef: float = 1e-4, loss_chunk: int = 1024,
                 remat="full", act_sharding=None,
                 attn_scheme: str = "simple", dp=None, tp=None):
    """loss_fn(params, tokens, labels, frames=None) -> (loss, {"ce",
    "aux"}); the forward casts floating leaves to ``cfg.cdtype`` at
    use.

    With ``dp`` (a ``train.dp.DataParallel``) the rows are this rank's
    part of a microbatch: CE and z-loss sums are divided by the
    microbatch's valid tokens over all ranks, the MoE load-balance
    statistics are summed over the ranks, and the loss carries 1/D of
    that global aux, so that the ranks' losses add up to the
    microbatch's loss; "ce" is this rank's part, "aux" the global
    value.  With ``tp`` (a ``train.tp.TensorParallel``) ``params`` are
    the rank's compute leaves, and every rank of a 'model' group has the
    same rows and returns the same loss; the valid tokens are counted
    over the data ranks only."""
    group = None if dp is None else dp.group

    def loss_fn(params, tokens, labels, frames=None):
        x, aux = tfm.forward(params, cfg, tokens, frames=frames,
                             remat=remat, return_hidden=True,
                             act_sharding=act_sharding,
                             attn_scheme=attn_scheme, dp_group=group,
                             tp=tp)
        unembed = tfm.unembed_matrix(params, cfg)
        valid = labels < cfg.vocab_size       # padded vocab ids are masked
        count = None
        if dp is not None:
            count = dp.all_reduce(valid.sum().float())
        loss, ce = chunked_ce_loss(x, unembed, labels, valid,
                                   chunk=loss_chunk, z_coef=z_coef,
                                   count=count, tp=tp)
        loss = loss + aux_coef * (aux if dp is None else aux / dp.world)
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def make_grad_step(cfg: ModelConfig, opt_cfg: OptConfig, accum: int = 1,
                   loss_chunk: int = 1024, remat="full",
                   aux_coef: float = 1e-2, act_sharding=None,
                   attn_scheme: str = "simple", dp=None, tp=None):
    """grad_step(params, batch) -> (loss, {"ce", "aux"}, grads): the
    train step's forward and backward over ``accum`` microbatches, before
    error feedback and the update.  ``grads`` has the tree of ``params``
    in the gradient dtype (``bfloat16`` with compression, else
    ``cfg.cdtype``).

    With ``dp``, ``params`` are this rank's blocks, gathered whole in the
    gradient dtype; ``batch`` holds this rank's rows of each microbatch
    (microbatch i is rows [i·mb, (i+1)·mb) of the global batch, and rank
    r holds the r-th 1/D of them); ``grads`` are whole leaves over this
    rank's rows, and the loss and "ce" are summed over the ranks.  With
    ``tp`` as well (``train.tp.TensorParallel``, the 'model' axis) the
    blocks gathered over 'data' are the rank's model blocks: a leaf split
    over 'model' only at rest is gathered over 'model' too, and the model
    reads the part of each leaf its math needs (``tp.view``); ``grads``
    are the gradients of those compute leaves."""
    loss_fn = make_loss_fn(cfg, aux_coef=aux_coef, loss_chunk=loss_chunk,
                           remat=remat, act_sharding=act_sharding,
                           attn_scheme=attn_scheme, dp=dp, tp=tp)
    gdt = (torch.bfloat16 if opt_cfg.grad_dtype == "bfloat16"
           else cfg.cdtype)

    def fresh_leaf(a, place=None, comp=None):
        if not a.is_floating_point():
            return a
        c = a.detach().to(gdt)
        if dp is not None:
            c = dp.gather_leaf(c, place[0])
        if tp is not None:
            c = tp.gather_leaf(c, place, comp)
        return c.requires_grad_()

    def grad_step(params, batch):
        params = tfm._as_tree(params)
        if dp is None:
            params_c = tree_map(fresh_leaf, params)
        elif tp is None:
            params_c = tree_map(fresh_leaf, params, dp.placements)
        else:
            params_c = tree_map(fresh_leaf, params, dp.placements,
                                tp.compute)
        view = params_c if tp is None else tree_map(
            tp.view, params_c, tp.placements, tp.compute)
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        mb = tokens.shape[0] // accum
        losses, ces, auxs = [], [], []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss, met = loss_fn(view, tokens[rows], labels[rows],
                                None if frames is None else frames[rows])
            loss.backward()
            losses.append(loss.detach())
            ces.append(met["ce"].detach())
            auxs.append(met["aux"].detach())
        grads = tree_map(lambda a: a.grad if a.grad is not None
                         else torch.zeros_like(a), params_c)
        if dp is not None:
            tot = dp.all_reduce(torch.stack(losses + ces))
            losses, ces = list(tot[:accum].unbind()), list(
                tot[accum:].unbind())
        if accum == 1:
            return losses[0], {"ce": ces[0], "aux": auxs[0]}, grads
        for g in tree_leaves(grads):
            g.div_(accum)
        met = {"ce": torch.stack(ces).mean(), "aux": torch.stack(auxs).mean()}
        return sum(losses) / accum, met, grads
    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    accum: int = 1, loss_chunk: int = 1024,
                    remat="full", aux_coef: float = 1e-2,
                    act_sharding=None, attn_scheme: str = "simple",
                    dp=None, tp=None):
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place.

    state = {"params": f32 tree, "opt": {...}, "residual": optional}
    batch = {"tokens": (B,S) integer, "labels": (B,S) integer
             [, "frames": ...]}, tensors on the state's device.

    With ``dp`` (``train.dp.DataParallel``) the state holds this rank's
    blocks and the batch its rows (see ``make_grad_step``): the gradients
    are reduce-scattered in float32, and error feedback and AdamW run on
    the blocks, clipped by the norm over every block.  With ``tp`` the
    blocks are on both axes: the compute leaves' gradients are first
    reduced over 'model' (``tp.reduce_grads``), then over 'data'.
    """
    grad_step = make_grad_step(cfg, opt_cfg, accum=accum,
                               loss_chunk=loss_chunk, remat=remat,
                               aux_coef=aux_coef, act_sharding=act_sharding,
                               attn_scheme=attn_scheme, dp=dp, tp=tp)
    compress = opt_cfg.grad_dtype == "bfloat16"

    def train_step(state, batch):
        loss, met, grads = grad_step(state["params"], batch)
        if tp is not None:
            grads = tp.reduce_grads(grads)
        if dp is not None:
            grads = dp.reduce_grads(grads)
        if compress and opt_cfg.error_feedback and "residual" in state:
            # ef-sim: quantize (grads + residual), carry the error
            with torch.no_grad():
                for g, r in zip(tree_leaves(grads),
                                tree_leaves(state["residual"])):
                    s = g.float() + r
                    gq = s.to(torch.bfloat16)
                    r.copy_(s - gq.float())
                    g.copy_(gq)
        _, _, omet = apply_updates(
            state["params"], grads, state["opt"], opt_cfg,
            gnorm=None if dp is None else dp.global_norm(grads))
        return state, {"loss": loss, **met, **omet}

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig,
                     seed: int = 0, error_feedback_state: bool = False,
                     device=None, keep=None) -> dict:
    """Fresh float32 parameters (``init_params``), zero moments and a
    zero step on ``device`` (CUDA unless given), and a float32 residual
    with ``error_feedback_state``.  With ``keep`` (see ``init_params``)
    every leaf holds only the part ``keep`` takes of it, drawn one leaf
    at a time (a data-parallel rank's blocks)."""
    params = tfm.init_params(cfg, seed=seed, device=device, keep=keep)
    state = {"params": params, "opt": init_opt_state(params)}
    if error_feedback_state:
        state["residual"] = tree_map(
            lambda a: torch.zeros(a.shape, dtype=torch.float32
                                  if a.is_floating_point() else a.dtype,
                                  device=a.device), params)
    return state


# ------------------------------------------------------------------ serve
def make_prefill_step(cfg: ModelConfig, attn_scheme: str = "simple",
                      tp=None):
    """prefill(params, tokens, frames=None) -> (B, S, V) logits.  With
    ``tp`` (``train.tp.TensorParallel``) ``params`` are the rank's
    serving leaves (``serve_leaf``) and ``tokens`` its rows: the forward
    runs split over 'model' and the logits are whole on every rank."""
    cast = _CastOnce(cfg)

    @torch.no_grad()
    def prefill(params, tokens, frames=None):
        p = cast(params)
        if tp is not None:
            p = tp.narrow_kv(p)
        logits, _ = tfm.forward(p, cfg, tokens, frames=frames,
                                remat=False, attn_scheme=attn_scheme,
                                tp=tp)
        return logits if tp is None else tp.gather_vocab(logits)
    return prefill


def make_decode_step(cfg: ModelConfig, tp=None):
    """decode(params, cache, token, pos) -> ((B, V) logits, cache), the
    cache updated in place; with ``tp`` as ``make_prefill_step`` (the
    cache from ``transformer.init_cache(tp=tp)``)."""
    cast = _CastOnce(cfg)

    @torch.no_grad()
    def decode(params, cache, token, pos):
        return tfm.decode_step(cast(params), cfg, cache, token, pos, tp=tp)
    return decode
