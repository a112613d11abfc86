"""Public kernel wrappers of the port (counterpart of
``repro.kernels.ops``).

Dispatch rule: a CUDA tensor launches the hand-written kernel, a CPU
tensor runs the plain PyTorch version of ``kernels.ref``, and any other
device raises.  There is no fallback from the kernel: a build or launch
error propagates.

Exactness envelopes, as in the reference: the f32 path is exact while
values stay below 2^24, the int32 path while the final counts stay below
2^31 (intermediates may wrap: two's-complement arithmetic is exact
modulo 2^32, and feasibility counts at n <= 15 fit).  The f64 zeta and
Moebius (the float64 tier's) are bitwise the plain butterflies on any
input, and exact on feasibility counts to n = 26.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.connmask import connmask_cuda
from repro_torch.kernels.ranked_conv import ranked_conv_cuda
from repro_torch.kernels.ref import (connmask_ref, mobius_ref,
                                     ranked_conv_ref, zeta_ref)
from repro_torch.kernels.zeta_cuda import zeta_cuda

F32_EXACT_LIMIT = float(1 << 24)
I32_EXACT_LIMIT = float(1 << 31)

launch_counts = build.launch_counts
reset_launch_counts = build.reset_launch_counts


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"no kernel route for device {x.device}")


def zeta_op(f: torch.Tensor, inverse: bool = False,
            out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Zeta (or Moebius) over the last axis; leading axes are batch.
    ``out`` (contiguous, same shape and dtype; may be ``f``) takes the
    result instead of a new tensor."""
    if _route(f) == "cuda":
        return zeta_cuda(f, inverse=inverse, out=out)
    return mobius_ref(f, out=out) if inverse else zeta_ref(f, out=out)


def mobius_op(f: torch.Tensor, out: "torch.Tensor | None" = None
              ) -> torch.Tensor:
    return zeta_op(f, inverse=True, out=out)


# The batched solver stacks B same-n feasibility tables as (B, 2^n) (and
# (G, B, 2^n), (n+1, B, 2^n)): the batch folds into the kernel's index,
# so one launch sequence covers the whole stack.
def zeta_batch_op(f: torch.Tensor, inverse: bool = False,
                  out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Batched zeta/Moebius over the last axis of a (..., 2^n) stack."""
    if f.ndim < 2:
        raise ValueError("zeta_batch_op expects a leading batch axis; "
                         "use zeta_op for flat tables")
    return zeta_op(f, inverse=inverse, out=out)


def mobius_batch_op(f: torch.Tensor, out: "torch.Tensor | None" = None
                    ) -> torch.Tensor:
    return zeta_batch_op(f, inverse=True, out=out)


def ranked_conv_op(Z: torch.Tensor, k: int) -> torch.Tensor:
    """Layer-k ranked convolution of a (n+1, ..., 2^n) ranked zeta table;
    the batch axes fold into one launch."""
    if _route(Z) == "cuda":
        return ranked_conv_cuda(Z, k)
    return ranked_conv_ref(Z, k)


def connmask_op(adj: torch.Tensor, n: int) -> torch.Tensor:
    """The (rows, 2^n) connected-subset masks of ``rows`` simple-edge
    graphs from their (rows, n) int32 adjacency bitmasks."""
    if _route(adj) == "cuda":
        return connmask_cuda(adj, n)
    return connmask_ref(adj, n)
