"""Plain PyTorch versions of the kernels (counterpart of
``repro.kernels.ref``).

They define what the CUDA kernels must reproduce bit for bit on int32,
and on float32 values that are integers below 2^24:

  zeta_ref        — (ζf)(S) = Σ_{T⊆S} f(T) over the last axis
  mobius_ref      — inverse of zeta_ref
  zeta_stages_ref — a range of butterfly stages (one kernel launch)
  ranked_conv_ref — layer-k ranked convolution of a ranked zeta table
                    (paper Eq. 11 with the Sec. 5.2 symmetry halving):
                    acc = Σ_{d=1}^{k-1} Z[d] * Z[k-d]
  connmask_ref    — connected-subset masks of simple-edge graphs from
                    their adjacency bitmasks

The kernel wrappers run these on CPU tensors; ``chip_smoke.py`` runs them
on the card to check the kernels.  int32 arithmetic wraps (two's
complement), as XLA's does.
"""
from __future__ import annotations

import torch

from repro_torch.core.zeta import butterfly


def zeta_ref(f: torch.Tensor, out: "torch.Tensor | None" = None
             ) -> torch.Tensor:
    return butterfly(f, 1, out=out)


def mobius_ref(f: torch.Tensor, out: "torch.Tensor | None" = None
               ) -> torch.Tensor:
    return butterfly(f, -1, out=out)


def zeta_stages_ref(f: torch.Tensor, sign: int, lo: int,
                    hi: int) -> torch.Tensor:
    """Butterfly stages ``lo..hi-1`` only: the plain version of one
    launch of ``zeta_cuda.launch_plan`` (``zeta_cluster``: ``lo = 0``,
    ``hi = min(n, LOW_BITS)``, 15 at 4 bytes an element and 14 at 8;
    ``zeta_high``: ``LOW_BITS <= lo < hi <= lo + HIGH_BITS``)."""
    return butterfly(f, sign, range(lo, hi))


def ranked_conv_ref(Z: torch.Tensor, k: int) -> torch.Tensor:
    """Z: (n+1, ..., 2^n) ranked zeta table.  Returns (..., 2^n)."""
    acc = torch.zeros_like(Z[0])
    for d in range(1, (k - 1) // 2 + 1):
        acc = acc + Z[d] * Z[k - d]
    acc = acc * 2
    if k % 2 == 0:
        acc = acc + Z[k // 2] * Z[k // 2]
    return acc


def connmask_ref(adj: torch.Tensor, n: int) -> torch.Tensor:
    """``adj`` (rows, n) integer neighbour bitmasks -> (rows, 2^n) bool,
    ``conn[S]`` = S induces a connected subgraph (``conn[0]`` false).

    The fixpoint ``reach = (reach | adj(reach)) & S`` from the lowest
    relation of S, run n - 1 times (no host read decides when to stop),
    ``adj(R)`` a gather of the table of neighbour unions of every set,
    built by bit doubling."""
    rows = adj.shape[0]
    size = 1 << n
    adj = adj.to(torch.int64)
    nbr = torch.zeros((rows, size), dtype=torch.int64, device=adj.device)
    for j in range(n):
        lo = 1 << j
        nbr[:, lo:2 * lo] = nbr[:, :lo] | adj[:, j:j + 1]
    S = torch.arange(size, dtype=torch.int64, device=adj.device)
    reach = (S & -S).expand(rows, size).contiguous()
    for _ in range(n - 1):
        reach = (reach | torch.gather(nbr, 1, reach)) & S
    conn = reach == S
    conn[:, 0] = False
    return conn
