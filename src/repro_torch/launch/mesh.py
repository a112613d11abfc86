"""The solve mesh of sharded lattice solves (counterpart of the
solve-mesh part of ``repro.launch.mesh``).

A mesh is a tuple of D ``torch.device``s; its first entry is the lead
device.  One Python process drives every device (a single controller, as
``shard_map`` is): the lead device runs every replicated part of a
solve, and each sharded layer sends its blocks of work to the mesh's
devices and writes what comes back into one layer on the lead device
(``core.lattice``).

By default a mesh takes the visible devices of its lead device's type:
every card for CUDA, starting at the lead's index; the one CPU device
otherwise.  ``force_device_count(k)`` is the counterpart of XLA's
``--xla_force_host_platform_device_count``: one device then fills k
mesh slots, so a D-way solve runs on one CPU or one card (a mesh that
repeats a device copies nothing between its slots).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

SOLVE_AXIS = "solve"

_FORCED = {"count": None}       # slots one device fills, or None


def force_device_count(k: "int | None") -> None:
    """Let the lead device fill ``k`` mesh slots (``None`` restores the
    visible devices).  Meshes built before the call keep their devices."""
    if k is not None and int(k) < 1:
        raise ValueError(f"a device count must be >= 1, not {k}")
    _FORCED["count"] = None if k is None else int(k)


def forced_device_count() -> "int | None":
    return _FORCED["count"]


def lead_device(device=None) -> torch.device:
    """The device a mesh led by ``device`` starts with (CUDA unless
    given), with its index spelled out, as tensors report theirs."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(device=None) -> tuple:
    """Every device a solve mesh led by ``device`` may use, lead first:
    the lead device ``k`` times under ``force_device_count(k)``; else
    every visible card from the lead's index on (wrapping), or the lead
    device alone for any other type."""
    lead = lead_device(device)
    k = _FORCED["count"]
    if k is not None:
        return (lead,) * k
    if lead.type == "cuda":
        count = torch.cuda.device_count()
        return tuple(torch.device("cuda", (lead.index + i) % count)
                     for i in range(count))
    return (lead,)


def make_solve_mesh(shards: "int | None" = None, device=None) -> tuple:
    """The 1-D solve mesh of ``shards`` devices led by ``device``:
    the sharded layer sweeps partition their per-layer subset blocks
    over it.  ``shards=None`` takes every device
    ``mesh_devices`` offers; more than it offers raises."""
    devs = mesh_devices(device)
    d = len(devs) if shards is None else int(shards)
    if not 1 <= d <= len(devs):
        raise ValueError(f"solve mesh wants {d} devices, have {len(devs)}")
    return devs[:d]


def mesh_fingerprint(mesh) -> tuple:
    """Stable identity of a mesh's device assignment, one device name
    per slot: it extends the engine's program-cache keys, so programs of
    different meshes never alias, and dispatch records say which devices
    a solve ran on."""
    return tuple(str(torch.device(d)) for d in mesh)
