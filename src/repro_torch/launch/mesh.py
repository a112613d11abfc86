"""The port's meshes (counterpart of ``repro.launch.mesh``): the LM
meshes of training and of the dry-run cells, and the solve mesh of
sharded lattice solves.

**LM meshes** are ``torch.distributed`` ``DeviceMesh``es with the
reference's axis names, over the ranks of a process group (one process
per card; gloo processes on the CPU).

``make_production_mesh`` keeps the reference's world sizes, 256 cards
for a pod and 512 for two (the dry-run cells' ``n_chips``), but not its
v5e layout.  The reference's (16, 16) puts 'model' on a pod's ICI torus,
where every card has fast links to its neighbours.  An H100 node holds 8
cards joined all to all by NVLink (450 GB/s a direction a card), and
nodes talk over InfiniBand at about a tenth of that.  Tensor
parallelism all-reduces activations in every layer, so 'model' must stay
inside a node: 'model' = 8, one HGX node, and the data axes cross nodes,
where FSDP's all-gathers and reduce-scatters (once per layer, and
overlappable) bear the slower links.  So a pod is (32, 8) as ('data',
'model'), and two pods are (2, 32, 8) as ('pod', 'data', 'model'), with
'pod' the outermost axis as in the reference.

``make_host_mesh(data, model)`` is the small mesh of one run: the
``launch.train`` workers build it over their process group (NCCL on
cards, gloo on the CPU) and train over its 'data' and 'model' groups.  Unlike the reference, which takes the first
``data * model`` devices, it covers the whole group: the trainer starts
exactly as many ranks as the mesh has slots.

A ``DeviceMesh`` has no axis types, so the reference's mesh fault
(``jax.make_mesh`` gives Explicit axes in JAX 0.9.0, which its sharding
constraints refuse; ROADMAP queue 3) has no counterpart here.

**The solve mesh** is a tuple of D ``torch.device``s; its first entry is
the lead device.  One Python process drives every device (a single
controller, as ``shard_map`` is): the lead device runs every replicated
part of a solve, and each sharded layer sends its blocks of work to the
mesh's devices and writes what comes back into one layer on the lead
device (``core.lattice``).

By default a solve mesh takes the visible devices of its lead device's
type: every card for CUDA, starting at the lead's index; the one CPU
device otherwise.  ``force_device_count(k)`` is the counterpart of
XLA's ``--xla_force_host_platform_device_count``: one device then fills
k mesh slots, so a D-way solve runs on one CPU or one card (a mesh that
repeats a device copies nothing between its slots).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh of 256 cards, or of 512 with ``multi_pod``
    (see the module docstring for the shapes).  Needs a process group of
    that world size; one on the fake backend (``torch.testing._internal.
    distributed.fake_pg``) builds it in one process."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int, model: int):
    """A ('data', 'model') mesh over the ranks of this run's process
    group, which must hold ``data * model`` of them: on cards under
    NCCL, on the CPU under gloo.  Rank r sits at (r // model, r % model),
    row-major as in the reference's mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


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
