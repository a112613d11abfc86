"""Tensor parallelism over 'model' in LM training (``repro_torch.train.
tp``, ``launch.train`` on a ('data', 'model') = (D, T) mesh) on the CPU:
spawned gloo ranks, each holding its block of the train state on both
axes, against one process and against ``repro``'s ``make_train_step``.

  * The ten reduced configs at (1, 2), and qwen3-0.6b reduced with a
    d_model of 127 (no 'model' axis divides it: the copy / all-reduce
    pair at the layer boundaries), from one train state (the port's
    seeded draw) in both packages, two steps of batch 4 ×
    seq 32 in one pair of spawned ranks that builds each rank's layout
    as the trainer does (``train.tp.mesh_layout``; enc-dec needs frames,
    which the CLI's data has not): loss and gradient norm within
    ``RTOL`` relative of one process and of the reference, each
    first-step gradient leaf within ``LEAF_RTOL`` of its largest |value|
    against one process, and each first-step AdamW first moment
    (``(1 - b1)`` times the clipped gradient) within ``LEAF_RTOL``
    against the reference's.  A leaf whose gradient is below 1e-6 of
    the tree's largest is zero in exact arithmetic (the enc-dec
    cross-attention key bias) and must stay below it.  Only the order
    of the sums over heads, ``d_ff``, experts and the vocabulary
    differs from one process: at most 1.6e-7 relative is seen on loss
    and norm (2.8e-7 against the reference), and 3.3e-6 of a leaf's
    largest |value| (6.4e-6 on the reference's first moments).
  * The CLI (``--device cpu``, ``launch.mesh.force_device_count`` for
    the device count) at (2, 2) and (1, 4) for qwen3-0.6b reduced (at
    (1, 4) its 2 KV heads do not split, and ``wk``/``wv`` are gathered),
    (1, 2) and (1, 4) for olmoe-1b-7b reduced (experts over 'model') and
    (1, 2) for mamba2-130m reduced (the SSM's leaves gathered), three
    steps of batch 4 in two microbatches, against the one-process CLI:
    loss, ce, aux and gradient norm within ``RTOL``.
  * (1, 1) through the spawned-rank path equals one process bitwise.
  * A fresh state drawn sharded equals the blocks of the whole draw on
    both axes, at (2, 2) and (1, 4), for every reduced config.
  * The restart contract at (1, 2) (fail at step 9, resume, the final
    loss within 1e-4 of the uninterrupted run's), and the port's
    counterpart of ``tests/test_integration_extra.py::
    test_elastic_reshard_across_meshes``: a state written at (2, 2)
    resumes at (4, 1) and at (1, 1) and is saved back bitwise.
  * On cards (``cuda``): (1, 2) on two cards against one card.
"""
import concurrent.futures
import dataclasses
import importlib.util
import multiprocessing
import os
import pickle
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_cli
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import dp as dp_mod
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map

RTOL, LEAF_RTOL = 1e-5, 1e-4
KEYS = ("loss", "ce", "aux", "grad_norm")
ARCHS = sorted(PORT_ARCHS)
# and one config whose d_model (127) no 'model' axis above 1 divides: the
# boundary layout falls back to the copy / all-reduce pair
JOBS = ARCHS + ["qwen3-0.6b@d127"]
B, SEQ, CHUNK = 4, 32, 64
OPT = dict(warmup_steps=5, total_steps=3)
CLI = ["--reduced", "--steps", "3", "--batch", "4", "--accum", "2",
       "--seq", "32", "--log-every", "1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): np.asarray(a) for p, a in
            tree_items(tree)}


def _cfg(name: str, get=get_config, red=reduced):
    """The reduced config of a job name ("arch" or "arch@dN": d_model N),
    from ``get``/``red`` (the port's, or the reference's)."""
    arch, _, d = name.partition("@d")
    cfg = red(get(arch))
    return dataclasses.replace(cfg, d_model=int(d)) if d else cfg


def _batches(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = {k: rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(
                size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _ten_worker(rank, tmp, jobs):
    """One rank of the (1, 2) mesh: each job's two steps as the trainer
    runs them, on its layout; rank 0 writes what it saw."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.tp import mesh_layout
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                            rank=rank, world_size=2)
    mesh = make_host_mesh(1, 2)
    for arch, state_np, batches in jobs:
        cfg = _cfg(arch)
        opt = OptConfig(**OPT)
        dp, tp = mesh_layout(cfg, mesh, "cpu")
        state = dp.shard_state(convert.train_state_from_reference(
            cfg, state_np, device="cpu"))
        bt = [{k: torch.as_tensor(v) for k, v in b.items()}
              for b in batches]
        grad = steps.make_grad_step(cfg, opt, loss_chunk=CHUNK, dp=dp,
                                    tp=tp)
        _, _, g = grad(state["params"], bt[0])
        g = dp.gather_tree(dp.reduce_grads(tp.reduce_grads(g)))
        step = steps.make_train_step(cfg, opt, loss_chunk=CHUNK, dp=dp,
                                     tp=tp)
        hist = []
        for i, b in enumerate(bt):
            state, m = step(state, b)
            hist.append({k: float(m[k]) for k in KEYS})
            if i == 0:
                mu = dp.gather_tree(state["opt"]["mu"])
        if rank == 0:
            with open(os.path.join(tmp, arch + ".pkl"), "wb") as f:
                pickle.dump({"hist": hist, "grads": _flat(g),
                             "mu": _flat(mu), "gathered": tp.gathered,
                             "plan": tp.plan}, f)
    dist.destroy_process_group()


def _ref_job(jobs) -> dict:
    """The reference's two steps per job (one process, jitted)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.optim import adamw as ref_adamw
    from repro.train import steps as ref_steps
    out = {}
    for arch, state_np, batches in jobs:
        rcfg = _cfg(arch, ref_get_config, ref_reduced)
        rstep = jax.jit(ref_steps.make_train_step(
            rcfg, ref_adamw.OptConfig(**OPT), loss_chunk=CHUNK))
        rstate = jax.tree.map(jnp.asarray, state_np)
        ref = {"hist": []}
        for b in batches:
            rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            ref["hist"].append({k: float(rm[k]) for k in KEYS})
            ref.setdefault("mu", _ref_flat(rstate["opt"]["mu"]))
        out[arch] = ref
    return out


@pytest.fixture(scope="module")
def jobs():
    """Per reduced config: a train state (the port's seeded draw, as
    numpy) and two batches."""
    out = []
    for i, arch in enumerate(JOBS):
        cfg = _cfg(arch)
        state = steps.init_train_state(cfg, OptConfig(**OPT), seed=0,
                                       device="cpu")
        out.append((arch, tree_map(lambda a: a.numpy(), state),
                    _batches(cfg, i)))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference(jobs):
    """The reference's steps, compiled and run in a spawned process
    while the module's other tests run (the ten-config test comes
    last); ``None`` where JAX is not installed (a card's host)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    fut = pool.submit(_ref_job, jobs)
    yield fut
    pool.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def ten(jobs, reference):
    """Per reduced config: the (1, 2) ranks' results, one process's and
    the reference's."""
    if reference is None:
        pytest.skip("needs jax for the reference")
    tmp = tempfile.mkdtemp(prefix="tp_ten-")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ten_worker, args=(r, tmp, jobs))
             for r in range(2)]
    for p in procs:
        p.start()
    one = {}
    try:
        for arch, state_np, batches in jobs:
            cfg = _cfg(arch)
            opt = OptConfig(**OPT)
            # a copy: the port's state shares its arrays and is updated
            # in place
            state = convert.train_state_from_reference(
                cfg, tree_map(np.copy, state_np), device="cpu")
            bt = [{k: torch.as_tensor(v) for k, v in b.items()}
                  for b in batches]
            _, _, g = steps.make_grad_step(cfg, opt, loss_chunk=CHUNK)(
                state["params"], bt[0])
            step = steps.make_train_step(cfg, opt, loss_chunk=CHUNK)
            one[arch] = {"grads": _flat(tree_map(lambda a: a.detach(), g)),
                         "hist": []}
            for b in bt:
                state, m = step(state, b)
                one[arch]["hist"].append({k: float(m[k]) for k in KEYS})
    finally:
        for p in procs:
            p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = {}
    for arch in JOBS:
        with open(os.path.join(tmp, arch + ".pkl"), "rb") as f:
            got[arch] = pickle.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    ref = reference.result(timeout=900)
    return got, {arch: (one[arch], ref[arch]) for arch in JOBS}


def _ref_flat(tree) -> dict:
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in p): np.asarray(a) for p, a in flat}


def _close_hist(got, want, rtol) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            assert abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1e-30), \
                (k, g, w)


def _close_leaves(got: dict, want: dict, rtol: float) -> None:
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:          # zero in exact arithmetic
            assert float(np.abs(got[k]).max()) < 1e-6 * top, k
            continue
        assert float(np.abs(got[k] - w).max()) <= rtol * scale, k


@pytest.mark.parametrize("shape,d", [((1, 16, 8), 2), ((1, 6, 4, 2), 2),
                                     ((3, 4, 6), 2), ((4, 6), 0)],
                         ids=["row-last", "lead1-mid", "rows-last", "dim0"])
def test_collective_buffers_are_contiguous(monkeypatch, shape, d):
    """The tensors the 'data' and 'model' collectives hand to the
    process group are contiguous: NCCL reads a strided view as if it
    were contiguous, where gloo copies it (a leading dimension of 1
    makes the reduce-scatter's layout a strided view).  Two ranks that
    hold the same tensor are simulated."""
    def reduce_scatter(out, x, group=None):
        assert x.is_contiguous() and out.is_contiguous()
        out.copy_(2 * x.view((2,) + tuple(out.shape))[0])

    def all_gather(out, x, group=None):
        assert x.is_contiguous() and out.is_contiguous()
        out.copy_(torch.cat([x, x]))

    monkeypatch.setattr(dp_mod.dist, "reduce_scatter_tensor",
                        reduce_scatter)
    monkeypatch.setattr(dp_mod.dist, "all_gather_into_tensor", all_gather)
    c = dp_mod.Collectives.__new__(dp_mod.Collectives)
    c.group, c.rank, c.world = None, 0, 2
    c.device, c._times = torch.device("cpu"), []
    g = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c._reduce_scatter(g, d),
                       2 * dp_mod.block_of(g, d, 0, 2))
    half = dp_mod.block_of(g, d, 0, 2).contiguous()
    assert torch.equal(c._gather(half, d), torch.cat([half, half], d))


# ------------------------------------------------------------- the CLI
def _run(argv, devices=None) -> dict:
    mesh_mod.force_device_count(devices)
    try:
        rec = {}
        assert train_cli.main(argv, record=rec) == 0
        return rec
    finally:
        mesh_mod.force_device_count(None)


@pytest.fixture(scope="module")
def one_process():
    return {arch: _run(["--arch", arch] + CLI)
            for arch in ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-130m")}


@pytest.fixture(scope="module")
def qwen3_2x2(tmp_path_factory):
    ck = tmp_path_factory.mktemp("tp2x2")
    rec = _run(["--arch", "qwen3-0.6b"] + CLI + [
        "--data-mesh", "2", "--ckpt-dir", str(ck), "--ckpt-every", "100"],
        devices=4)
    return rec, ck


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-0.6b", (2, 2)), ("qwen3-0.6b", (1, 4)),
    ("olmoe-1b-7b", (1, 2)), ("olmoe-1b-7b", (1, 4)),
    ("mamba2-130m", (1, 2))],
    ids=["qwen3-2x2", "qwen3-1x4", "olmoe-1x2", "olmoe-1x4", "mamba2-1x2"])
def test_cli_tp_matches_one_process(arch, shape, one_process, qwen3_2x2):
    if (arch, shape) == ("qwen3-0.6b", (2, 2)):
        rec = qwen3_2x2[0]
    else:
        rec = _run(["--arch", arch] + CLI + ["--data-mesh", str(shape[0])],
                   devices=shape[0] * shape[1])
    assert (rec["data_mesh"], rec["model_mesh"]) == shape
    _close_hist(rec["history"], one_process[arch]["history"], RTOL)
    ranks = rec["ranks"]
    assert [r["coord"] for r in ranks] == [
        (d, m) for d in range(shape[0]) for m in range(shape[1])]
    whole = one_process[arch]["state_bytes"]
    assert all(r["state_bytes"] < 0.6 * whole for r in ranks)
    assert sum(r["state_bytes"] for r in ranks) >= whole
    assert all(not any(r["launches"].values()) for r in ranks)
    assert all(0 < h["model_collective_s"] <= h["model_collective_rank0_s"]
               for h in rec["history"])
    assert all(r["collective_s"]["model"] > 0 for r in ranks)
    names = {k.rsplit("/", 1)[-1] for k in rec["gathered"]}
    if arch == "qwen3-0.6b":
        assert ({"wk", "wv"} <= names) == (shape[1] == 4)
    if arch == "olmoe-1b-7b":
        assert min(h["aux"] for h in rec["history"]) > 0
        assert not any("/mlp/w" in k for k in rec["gathered"])
    if arch == "mamba2-130m":
        assert {"in_proj", "conv_w", "out_proj"} <= names


def test_mesh_1x1_equals_one_process_bitwise(one_process):
    rec = _run(["--arch", "qwen3-0.6b"] + CLI + ["--data-mesh", "1"])
    assert (rec["data_mesh"], rec["model_mesh"]) == (1, 1)
    assert [{k: h[k] for k in KEYS} for h in rec["history"]] == \
        [{k: h[k] for k in KEYS} for h in one_process["qwen3-0.6b"]["history"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_equals_blocks_of_whole_draw(arch):
    cfg = reduced(get_config(arch))
    shapes = T.init_params(cfg, device="meta")
    whole = dict(tree_items(T.init_params(cfg, seed=5, device="cpu")))
    for shape in ((2, 2), (1, 4)):
        mesh = type("Mesh", (), {"axis_names": ("data", "model"),
                                 "shape": dict(zip(("data", "model"),
                                                   shape))})
        places = shd.param_placements(mesh, shapes)
        pairs = dict(zip(whole, dp_mod.leaves_like(shapes, places)))
        assert any(p[1] is not None for p in pairs.values())
        for coord in ((d, m) for d in range(shape[0])
                      for m in range(shape[1])):
            part = dict(tree_items(T.init_params(
                cfg, seed=5, device="cpu",
                keep=dp_mod.keep_blocks(shapes, places, coord, shape))))
            assert part.keys() == whole.keys()
            for p, a in whole.items():
                want = dp_mod.block_of(dp_mod.block_of(
                    a, pairs[p][1], coord[1], shape[1]), pairs[p][0],
                    coord[0], shape[0])
                assert torch.equal(part[p], want), (shape, coord, p)


def test_restart_at_1x2_reproduces_run(tmp_path):
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "14", "--batch",
            "2", "--seq", "32", "--ckpt-every", "5", "--log-every", "1",
            "--device", "cpu", "--data-mesh", "1"]
    full = _run(argv + ["--ckpt-dir", str(tmp_path / "a")], devices=2)
    ck = str(tmp_path / "b")
    mesh_mod.force_device_count(2)
    try:
        with pytest.raises(SystemExit) as e:
            train_cli.main(argv + ["--ckpt-dir", ck, "--fail-at-step", "9"])
    finally:
        mesh_mod.force_device_count(None)
    assert e.value.code == 42
    resumed = _run(argv + ["--ckpt-dir", ck, "--resume"], devices=2)
    assert [h["step"] for h in resumed["history"]] == list(range(5, 14))
    want = full["history"][-1]["loss"]
    assert np.isclose(resumed["history"][-1]["loss"], want, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 1), (1, 1)], ids=["4x1", "1x1"])
def test_elastic_reshard_across_meshes(shape, qwen3_2x2, tmp_path):
    """The (2, 2) run's final state, resumed at ``shape`` with no step
    left to run and saved again, comes back bitwise."""
    src, ck = qwen3_2x2[1], tmp_path / "ck"
    shutil.copytree(src, ck)
    name = "step-00000003.npz"
    with np.load(os.path.join(src, name)) as z:
        want = {k: z[k] for k in z.files}
    rec = _run(["--arch", "qwen3-0.6b"] + CLI + [
        "--batch", "8", "--data-mesh", str(shape[0]), "--ckpt-dir",
        str(ck), "--resume"], devices=shape[0] * shape[1])
    assert rec["history"] == []
    assert (rec["data_mesh"], rec["model_mesh"]) == shape
    with np.load(os.path.join(ck, name)) as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


@pytest.mark.cuda
def test_tp_on_two_cards_matches_one_card(two_cards):
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "3", "--batch",
            "4", "--accum", "2", "--seq", "32", "--log-every", "1"]
    one = _run(argv + ["--device", "cuda:0"])
    rec = {}        # the (1, 2) mesh on cards 0 and 1 of any host
    args = train_cli._parser().parse_args(argv + ["--data-mesh", "1"])
    assert train_cli._launch(args, (1, 2), torch.device("cuda"), rec) == 0
    assert (rec["data_mesh"], rec["model_mesh"]) == (1, 2)
    _close_hist(rec["history"], one["history"], 1e-4)


# ten configs last: the reference compiles meanwhile
@pytest.mark.parametrize("arch", JOBS)
def test_tp_1x2_matches_one_process_and_reference(arch, ten):
    got, want = ten
    g, (one, ref) = got[arch], want[arch]
    _close_hist(g["hist"], one["hist"], RTOL)
    _close_hist(g["hist"], ref["hist"], RTOL)
    _close_leaves(g["grads"], one["grads"], LEAF_RTOL)
    _close_leaves(g["mu"], ref["mu"], LEAF_RTOL)
    if arch == "mamba2-130m":
        assert any(k.endswith("ssm/in_proj") for k in g["gathered"])
    assert g["plan"]["layout"] == ("@d" not in arch)
    if arch.startswith(("olmoe", "llama4")):
        assert g["plan"]["moe"] and min(h["aux"] for h in g["hist"]) > 0
