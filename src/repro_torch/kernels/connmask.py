"""The connected-subset mask kernel for Hopper: wrapper of
``csrc/connmask.cu``.

From each row's adjacency, n int32 neighbour bitmasks of a simple-edge
query graph, one ``connmask`` launch builds the (rows, 2^n) bool table
``conn[S]`` = S induces a connected subgraph (``conn[0]`` false), bitwise
``QueryGraph.connected_mask``: the DPccp search space that the connected
(min,+) sweep reads.  One thread a (row, set) runs the reachability
fixpoint from the set's lowest relation.  ``kernels.ref.connmask_ref`` is
the plain version, which CPU tensors take.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_N = 30


def connmask_cuda(adj: torch.Tensor, n: int) -> torch.Tensor:
    """``adj`` (rows, n) int32 on a card -> (rows, 2^n) bool on it."""
    if adj.device.type != "cuda":
        raise ValueError("connmask_cuda takes a CUDA tensor")
    if adj.dtype != torch.int32 or adj.ndim != 2 or adj.shape[1] != n:
        raise ValueError(f"adjacency must be (rows, {n}) int32, not "
                         f"{tuple(adj.shape)} {adj.dtype}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n={n} outside [1, {MAX_N}]")
    adj = adj.contiguous()
    rows = adj.shape[0]
    conn = torch.empty((rows, 1 << n), dtype=torch.bool, device=adj.device)
    if rows == 0:
        return conn
    err = build.library().repro_connmask(
        conn.data_ptr(), adj.data_ptr(), rows, n, adj.get_device(),
        build.current_stream(adj))
    build.check(err, "connmask")
    build.count_launch("connmask")
    return conn
