"""Data-parallel training through the port's CLI (``repro_torch.launch.
train --data-mesh D --device cpu``): D gloo processes, each holding its
block of the train state (``train.dp``), against the one-process run.

  * D = 2 against one process, per step, over 14 steps: loss, ce, aux
    and grad norm within ``RTOL`` relative (float32; only the order of
    the reductions differs: each rank sums its own rows, the ranks' sums
    are added, the global norm adds per-rank partial sums; about 3e-7 is
    seen): qwen3-0.6b reduced at ``--batch 2`` (the restart contract's
    run) and ``--batch 4 --accum 2``, and olmoe-1b-7b reduced, whose
    MoE load-balance aux is the global batch's;
  * ``--data-mesh 1`` (one spawned rank, a process group of one) equals
    the one-process run bitwise;
  * a reference train state (``convert.train_state_from_reference``, its
    moments and ef-sim residual filled from a seed), resumed at D = 2 and
    saved again, comes back bitwise (sharded on load, gathered on save),
    each rank holding half of every leaf the rules shard;
  * the restart contract at D = 2 (fail at step 9 with exit 42, resume,
    the final loss equal to the uninterrupted run's), and the elastic
    resume: a checkpoint written at D = 2 resumes at D = 1, and one
    written at D = 1 at D = 2, within ``RTOL``;
  * D = 2 against ``repro``'s own ``make_train_step``: from a reference
    train state (``convert.train_state_from_reference``), two steps at
    ``--batch 4 --accum 2`` of qwen3-0.6b and olmoe-1b-7b reduced (the
    global CE count and the global aux): loss, ce, aux and grad norm
    within ``REF_RTOL`` relative, as ``test_torch_train_track`` holds the
    one-process step, and the parameters of the final checkpoint within
    ``REF_RTOL`` of each leaf's largest |value|; each leaf's update
    (new minus old) within ``UPDATE_RTOL`` of the reference's in norm
    (about 1e-4 is seen: where a gradient entry is rounding noise,
    AdamW's ``mhat / sqrt(nhat)`` moves it by the learning rate with
    the noise's sign, see ``test_torch_train_track``);
  * a fresh state drawn sharded (``train.dp.keep_blocks``: one leaf at a
    time, each rank keeping its block) equals the blocks of the whole
    draw bitwise, for every reduced config;
  * on a card, ``--data-mesh 2`` without two cards raises (``cuda``).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.launch import train as train_cli
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.train import dp as dp_mod
from repro_torch.tree import subtree, tree_items

RTOL = 1e-5
REF_RTOL, UPDATE_RTOL = 1e-4, 1e-3
BASE = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "14", "--seq",
        "32", "--log-every", "1", "--device", "cpu"]
KEYS = ("loss", "ce", "aux", "grad_norm")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(argv) -> dict:
    rec = {}
    assert train_cli.main(argv, record=rec) == 0
    return rec


def _close(got: dict, want: dict, rtol: float = RTOL) -> None:
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["step"] == w["step"]
        for k in KEYS:
            assert abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1e-30), \
                (k, g, w)


@pytest.fixture(scope="module")
def restart_runs(tmp_path_factory):
    """The restart contract's uninterrupted run (batch 2, a checkpoint
    every 5 steps) in one process and at D = 2."""
    root = tmp_path_factory.mktemp("dp")
    argv = BASE + ["--batch", "2", "--ckpt-every", "5"]
    return {d: (_run(argv + ["--ckpt-dir", str(root / f"d{d}"),
                             "--data-mesh", str(d)]), root / f"d{d}")
            for d in (0, 2)}


@pytest.mark.parametrize("case", ["qwen3-b2", "qwen3-b4-accum2",
                                  "olmoe-b4-accum2"])
def test_data_parallel_matches_one_process(case, restart_runs):
    if case == "qwen3-b2":
        one, two = restart_runs[0][0], restart_runs[2][0]
    else:
        arch = case.split("-")[0]
        argv = [a if a != "qwen3-0.6b" else
                {"qwen3": "qwen3-0.6b", "olmoe": "olmoe-1b-7b"}[arch]
                for a in BASE] + ["--batch", "4", "--accum", "2"]
        one, two = _run(argv), _run(argv + ["--data-mesh", "2"])
    assert one["data_mesh"] == 1 and two["data_mesh"] == 2
    _close(two, one)
    if case.startswith("olmoe"):
        assert min(h["aux"] for h in two["history"]) > 0
    assert len(two["ranks"]) == 2 and two["ranks"][0]["peak_bytes"] is None
    assert all(not any(r["launches"].values()) for r in two["ranks"])
    assert all(0 < h["collective_s"] <= h["collective_rank0_s"]
               for h in two["history"])


def test_data_mesh_1_equals_one_process_bitwise(restart_runs):
    one = restart_runs[0][0]
    got = _run(BASE + ["--batch", "2", "--data-mesh", "1"])
    assert got["data_mesh"] == 1
    assert [{k: h[k] for k in KEYS} for h in got["history"]] == \
        [{k: h[k] for k in KEYS} for h in one["history"]]


def test_sharded_state_gathers_back_bitwise(tmp_path):
    rcfg = ref_reduced(ref_get_config("qwen3-0.6b"))
    cfg = reduced(get_config("qwen3-0.6b"))
    rstate = jax.tree.map(np.asarray, ref_steps.init_train_state(
        rcfg, ref_adamw.OptConfig(), seed=0, error_feedback_state=True))
    rng = np.random.default_rng(0)
    for key in ("mu", "nu"):
        rstate["opt"][key] = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(a.dtype),
            rstate["opt"][key])
    rstate["residual"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(a.dtype),
        rstate["residual"])
    state = convert.train_state_from_reference(cfg, rstate, device="cpu")
    state["opt"]["step"] += 3
    ckpt_lib.save(state, str(tmp_path), 3)
    want = {"/".join(map(str, p)): a.numpy().copy()
            for p, a in tree_items(state)}
    rec = _run(BASE + ["--batch", "2", "--steps", "3", "--resume",
                       "--grad-dtype", "bfloat16", "--ckpt-dir",
                       str(tmp_path), "--data-mesh", "2"])
    assert rec["history"] == []
    with np.load(os.path.join(tmp_path, "step-00000003.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys() and "residual/embed" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # each rank held half of every leaf the rules shard, the rest whole
    mesh = type("Mesh", (), {"axis_names": ("data", "model"),
                             "shape": {"data": 2, "model": 1}})
    params = T.init_params(cfg, device="meta")
    places = shd.param_placements(mesh, params)
    data_dim = {p: subtree(places, p)[0] for p, _ in tree_items(params)}
    held = sum(a.numel() * 4 // (1 if data_dim[p] is None else 2)
               for p, a in tree_items(params))
    assert sum(v is not None for v in data_dim.values()) >= 5
    assert [r["state_bytes"] for r in rec["ranks"]] == [3 * held] * 2


def _step_5_of(src, dst) -> str:
    os.makedirs(dst)
    for ext in ("npz", "json"):
        shutil.copy(os.path.join(src, f"step-00000005.{ext}"), dst)
    return str(dst)


def test_restart_at_data_mesh_2_reproduces_run(tmp_path, restart_runs):
    argv = BASE + ["--batch", "2", "--ckpt-every", "5", "--ckpt-dir",
                   str(tmp_path), "--data-mesh", "2"]
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv + ["--fail-at-step", "9"])
    assert e.value.code == 42
    assert ckpt_lib.available_steps(str(tmp_path)) == [5]
    resumed = _run(argv + ["--resume"])
    assert [h["step"] for h in resumed["history"]] == list(range(5, 14))
    want = restart_runs[2][0]["history"][-1]["loss"]
    assert np.isclose(resumed["history"][-1]["loss"], want, rtol=1e-4)


@pytest.mark.parametrize("written,resumed", [(2, 0), (0, 2)],
                         ids=["d2-to-d1", "d1-to-d2"])
def test_elastic_resume(tmp_path, restart_runs, written, resumed):
    ck = _step_5_of(restart_runs[written][1], tmp_path / "ck")
    got = _run(BASE + ["--batch", "2", "--ckpt-dir", ck, "--resume",
                       "--ckpt-every", "100", "--data-mesh", str(resumed)])
    assert got["data_mesh"] == max(resumed, 1)
    want = restart_runs[resumed][0]
    tail = {"history": want["history"][5:]}
    _close(got, tail)


def _ref_key(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_data_parallel_steps_match_reference(arch, tmp_path):
    start, steps, batch, accum, seq = 1, 3, 4, 2, 32
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    # the CLI's optimizer for --steps 3 (warm-up max(3 // 20, 5))
    ropt = ref_adamw.OptConfig(warmup_steps=5, total_steps=steps)
    rstate = ref_steps.init_train_state(rcfg, ropt, seed=0)
    rstate["opt"]["step"] = rstate["opt"]["step"] + start
    state = convert.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    ckpt_lib.save(state, str(tmp_path), start)
    with np.load(os.path.join(tmp_path, f"step-{start:08d}.npz")) as z:
        before = {k: z[k] for k in z.files}
    rec = _run(["--arch", arch, "--reduced", "--steps", str(steps),
                "--batch", str(batch), "--accum", str(accum), "--seq",
                str(seq), "--resume", "--ckpt-dir", str(tmp_path),
                "--data-mesh", "2", "--device", "cpu"])
    assert [h["step"] for h in rec["history"]] == list(range(start, steps))
    rstep = jax.jit(ref_steps.make_train_step(
        rcfg, ropt, accum=accum, loss_chunk=min(2048, batch * seq)))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=0)
    for h in rec["history"]:
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in
                                      batch_at(dcfg, h["step"]).items()})
        for k in KEYS:
            want = float(rmet[k])
            assert abs(h[k] - want) <= REF_RTOL * max(abs(want), 1e-30), \
                (h["step"], k, h[k], want)
    if arch.startswith("olmoe"):
        assert min(h["aux"] for h in rec["history"]) > 0
    with np.load(os.path.join(tmp_path, f"step-{steps:08d}.npz")) as z:
        got = {k: z[k] for k in z.files}
    for path, w in jtu.tree_flatten_with_path(rstate["params"])[0]:
        key = "params/" + _ref_key(path)
        w = np.asarray(w)
        g, upd = got[key], w - before[key]
        assert np.abs(g - w).max() <= REF_RTOL * np.abs(w).max(), key
        assert np.linalg.norm(g - w) <= UPDATE_RTOL * np.linalg.norm(upd), \
            key


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_sharded_init_equals_blocks_of_whole_draw(arch):
    cfg = reduced(get_config(arch))
    mesh = type("Mesh", (), {"axis_names": ("data", "model"),
                             "shape": {"data": 2, "model": 1}})
    shapes = T.init_params(cfg, device="meta")
    places = shd.param_placements(mesh, shapes)
    whole = dict(tree_items(T.init_params(cfg, seed=5, device="cpu")))
    dims = {p: subtree(places, p)[0] for p in whole}
    assert any(d is not None for d in dims.values())
    for rank in range(2):
        part = T.init_params(cfg, seed=5, device="cpu",
                             keep=dp_mod.keep_blocks(shapes, places,
                                                     (rank, 0), (2, 1)))
        got = dict(tree_items(part))
        assert got.keys() == whole.keys()
        for p, a in whole.items():
            assert torch.equal(got[p], dp_mod.block_of(a, dims[p], rank, 2)), p


@pytest.fixture
def fewer_than_two_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards or more")


@pytest.mark.cuda
def test_data_mesh_2_without_two_cards_raises(fewer_than_two_cards):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-0.6b", "--reduced", "--steps",
                        "1", "--batch", "2", "--seq", "8", "--data-mesh",
                        "2"])
    assert e.value.code == 2
