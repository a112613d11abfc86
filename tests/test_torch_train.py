"""The port's training path (``repro_torch.{data,optim,train,checkpoint,
launch.train}``): the reference's ``tests/test_train.py`` contracts run
on the port, and the port held to ``repro`` on the same inputs.

  * ``batch_at`` is a numpy copy: bitwise, both patterns, two mixtures
    of source weights;
  * ``lr_at`` at every step of a schedule, and ``apply_updates`` on the
    same parameters, gradients and moments (three steps, clipped and
    unclipped): within 1e-6 of each leaf's largest |value| (float32; the
    two frameworks reduce the global norm and evaluate ``cos``/``pow``
    in their own ways, about 1e-7 apart);
  * ``chunked_ce_loss`` within 1e-6 relative;
  * a checkpoint written by either package loads into the other,
    bitwise;
  * the restart contract through the port's CLI with ``--device cpu``
    (its data-parallel runs are in ``tests/test_torch_train_dp.py``)
    (the reference's own CLI cannot run it in this JAX: its embedding
    gather under the host mesh's shardings raises
    ``DuplicateSpecError``).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as ref_data
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import DataConfig, batch_at, host_slice
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig, lr_at
from repro_torch.train.steps import (chunked_ce_loss, init_train_state,
                                     make_train_step)
from repro_torch.tree import tree_items, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI processes run beside other test workers: two threads each, as
# the test modules cap torch at
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "OMP_NUM_THREADS": "2"}
MINI = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, n_kv_heads=1,
            head_dim=32, vocab_size=64, vocab_pad_multiple=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mini_cfg():
    return dataclasses.replace(reduced(get_config("qwen3-0.6b")), **MINI)


def _batch(dcfg, step):
    return {k: torch.as_tensor(v) for k, v in batch_at(dcfg, step).items()}


def _flat(tree) -> dict:
    """Path -> numpy copy of each leaf, under the checkpoint's keys."""
    return {"/".join(map(str, p)): (v.detach().numpy().copy() if
                                    isinstance(v, torch.Tensor)
                                    else np.asarray(v))
            for p, v in tree_items(tree)}


def _close(got: dict, want: dict, rtol: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rtol * scale, k


# --------------------------------------- the reference's contracts, ported
def test_loss_decreases_on_learnable_data():
    cfg = _mini_cfg()
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, opt, loss_chunk=256)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      global_batch=8, pattern="cyclic")
    first = last = None
    for i in range(60):
        state, m = step(state, _batch(dcfg, i))
        if i == 0:
            first = float(m["ce"])
        last = float(m["ce"])
    assert first > 3.0                       # ~ln(64) at init
    assert last < first * 0.5, (first, last)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accumulation_equivalent(accum):
    cfg = _mini_cfg()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=8)
    outs = {}
    for a in (1, accum):
        state = init_train_state(cfg, opt, seed=0, device="cpu")
        state, _ = make_train_step(cfg, opt, accum=a, loss_chunk=256)(
            state, _batch(dcfg, 0))
        outs[a] = _flat(state["params"])
    diff = max(float(np.abs(outs[1][k] - outs[accum][k]).max())
               for k in outs[1])
    assert diff < 5e-3, accum


@pytest.mark.parametrize("ef", [False, True], ids=["no_ef", "ef"])
def test_bf16_compressed_gradients(ef):
    cfg = _mini_cfg()
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=40,
                    grad_dtype="bfloat16", error_feedback=ef)
    state = init_train_state(cfg, opt, seed=0, error_feedback_state=ef,
                             device="cpu")
    step = make_train_step(cfg, opt, loss_chunk=256)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      global_batch=8, pattern="cyclic")
    first = last = None
    for i in range(40):
        state, m = step(state, _batch(dcfg, i))
        if i == 0:
            first = float(m["ce"])
        last = float(m["ce"])
    # compressed training still converges
    assert last < first * 0.7, (first, last)
    if ef:
        # the gradients are bfloat16 already, so (grads + residual)
        # rounds to bfloat16 exactly and the residual stays 0, as in the
        # reference's ef-sim
        res = [r for _, r in tree_items(state["residual"])]
        assert all(r.dtype == torch.float32 for r in res)
        assert not any(bool(r.abs().max() > 0) for r in res)


def test_chunked_ce_matches_dense():
    rng = np.random.default_rng(0)
    B, S, D, V = 2, 24, 16, 40
    x = torch.tensor(rng.normal(size=(B, S, D)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(D, V)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, V, (B, S)))
    valid = torch.ones((B, S), dtype=torch.bool)
    _, ce_c = chunked_ce_loss(x, w, labels, valid, chunk=7, z_coef=0.0)
    logits = (x @ w).float()
    dense = (torch.logsumexp(logits, -1)
             - torch.gather(logits, -1, labels[..., None])[..., 0]).mean()
    assert np.isclose(float(ce_c), float(dense), rtol=1e-5)


def test_lr_schedule():
    opt = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1)
    assert float(lr_at(opt, 0)) == 0.0
    assert np.isclose(float(lr_at(opt, 10)), 1.0)
    assert float(lr_at(opt, 110)) <= 0.11


def test_checkpoint_roundtrip(tmp_path):
    cfg = _mini_cfg()
    state = init_train_state(cfg, OptConfig(), seed=0, device="cpu")
    ckpt_lib.save(state, str(tmp_path), 7)
    restored, step = ckpt_lib.load(state, str(tmp_path))
    assert step == 7
    a, b = _flat(state), _flat(restored)
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in a)


def test_checkpoint_async_save_is_a_snapshot(tmp_path):
    """A background save writes the state as it was when ``save`` was
    called, though the trainer updates it in place meanwhile."""
    cfg = _mini_cfg()
    state = init_train_state(cfg, OptConfig(), seed=0, device="cpu")
    want = _flat(state)
    t = ckpt_lib.save(state, str(tmp_path), 3, blocking=False)
    for _, leaf in tree_items(state):
        leaf.add_(1)
    t.join(timeout=60)
    assert not t.is_alive()
    restored, _ = ckpt_lib.load(state, str(tmp_path))
    got = _flat(restored)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_checkpoint_skips_incomplete(tmp_path):
    cfg = _mini_cfg()
    state = init_train_state(cfg, OptConfig(), seed=0, device="cpu")
    ckpt_lib.save(state, str(tmp_path), 5)
    # simulate a crash mid-save of step 9: manifest without npz
    open(os.path.join(tmp_path, "step-00000009.json"), "w").write("{}")
    assert ckpt_lib.available_steps(str(tmp_path)) == [5]


def test_checkpoint_load_checks_shapes_and_leaves(tmp_path):
    cfg = _mini_cfg()
    state = init_train_state(cfg, OptConfig(), seed=0, device="cpu")
    ckpt_lib.save(state, str(tmp_path), 1)
    other = init_train_state(dataclasses.replace(cfg, d_model=32),
                             OptConfig(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_lib.load(other, str(tmp_path))
    state["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        ckpt_lib.load(state, str(tmp_path))


def test_failure_restart_reproduces_run(tmp_path):
    """Kill training mid-run; the resumed run lands on the same final
    loss as an uninterrupted one (determinism end to end)."""
    ck1, ck2 = str(tmp_path / "a"), str(tmp_path / "b")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--reduced", "--steps", "14", "--batch", "2",
            "--seq", "32", "--ckpt-every", "5", "--log-every", "1",
            "--device", "cpu"]
    run = dict(env=ENV, cwd=REPO, capture_output=True, text=True,
               timeout=300)
    r1 = subprocess.run(base + ["--ckpt-dir", ck1], **run)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2 = subprocess.run(base + ["--ckpt-dir", ck2, "--fail-at-step", "9"],
                        **run)
    assert r2.returncode == 42, r2.stdout + r2.stderr
    r3 = subprocess.run(base + ["--ckpt-dir", ck2, "--resume"], **run)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert "resumed from step 5" in r3.stdout

    def final_loss(out):
        lines = [ln for ln in out.splitlines() if "step    13" in ln]
        return float(lines[-1].split("loss")[1].split()[0])
    assert np.isclose(final_loss(r1.stdout), final_loss(r3.stdout),
                      rtol=1e-4), (r1.stdout, r3.stdout)


def test_data_determinism_and_slicing():
    dcfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                      source_weights=(0.5, 0.5))
    a = batch_at(dcfg, 3)
    b = batch_at(dcfg, 3)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = batch_at(dcfg, 4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    parts = [host_slice(a, i, 4) for i in range(4)]
    glued = np.concatenate([p["tokens"] for p in parts], axis=0)
    assert np.array_equal(glued, a["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# --------------------------------------------------- held to the reference
@pytest.mark.parametrize("weights", [(1.0,), (0.2, 0.3, 0.5)],
                         ids=["one_source", "three_sources"])
@pytest.mark.parametrize("pattern", ["random", "cyclic"])
def test_batch_at_matches_reference(pattern, weights):
    kw = dict(vocab_size=151936, seq_len=33, global_batch=10, seed=7,
              source_weights=weights, pattern=pattern)
    for step in (0, 1, 17):
        got = batch_at(DataConfig(**kw), step)
        want = ref_data.batch_at(ref_data.DataConfig(**kw), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("sched", [(100, 10_000), (5, 14), (0, 3)],
                         ids=["default", "cli_14", "no_warmup"])
def test_lr_at_matches_reference(sched):
    warm, total = sched
    kw = dict(lr=3e-4, warmup_steps=warm, total_steps=total)
    ref_cfg, cfg = ref_adamw.OptConfig(**kw), OptConfig(**kw)
    steps_ = np.unique(np.linspace(0, total + 5, 400).astype(np.int32))
    want = np.asarray(jax.vmap(lambda s: ref_adamw.lr_at(ref_cfg, s))(
        jnp.asarray(steps_)))
    got = np.array([float(lr_at(cfg, torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps_])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0],
                         ids=["unclipped", "clipped"])
def test_apply_updates_matches_reference(grad_scale):
    """Three AdamW steps from the same reduced qwen3 state and the same
    gradients through both packages (the port in place)."""
    rcfg, cfg = ref_reduced(ref_get_config("qwen3-0.6b")), \
        reduced(get_config("qwen3-0.6b"))
    opt_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_opt, opt = ref_adamw.OptConfig(**opt_kw), OptConfig(**opt_kw)
    rstate = ref_steps.init_train_state(rcfg, ref_opt, seed=0)
    state = convert.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    rng = np.random.default_rng(3)
    upd = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s, ref_opt))
    for _ in range(3):
        g_np = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * grad_scale
                       / np.sqrt(a.size)).astype(np.float32),
            jax.tree.map(np.asarray, rstate["params"]))
        rp, ropt, rmet = upd(rstate["params"], g_np, rstate["opt"])
        rstate = {"params": rp, "opt": ropt}
        _, _, met = adamw.apply_updates(
            state["params"], tree_map(torch.from_numpy, g_np),
            state["opt"], opt)
        assert (float(rmet["grad_norm"]) > 1.0) == (grad_scale == 1.0)
        for k in ("grad_norm", "lr"):
            assert np.isclose(float(met[k]), float(rmet[k]), rtol=1e-6,
                              atol=0), k
        _close(_flat(state), _flat(jax.tree.map(np.asarray, rstate)),
               rtol=1e-6)
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("chunk", [7, 48, 1024])
def test_chunked_ce_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    B, S, D, V = 2, 24, 16, 40
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    valid = rng.random((B, S)) < 0.8
    want = ref_steps.chunked_ce_loss(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(labels),
                                     jnp.asarray(valid), chunk=chunk)
    got = chunked_ce_loss(torch.tensor(x), torch.tensor(w),
                          torch.tensor(labels), torch.tensor(valid),
                          chunk=chunk)
    for g, r in zip(got, want):
        assert np.isclose(float(g), float(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    rcfg, cfg = ref_reduced(ref_get_config("zamba2-1.2b")), \
        reduced(get_config("zamba2-1.2b"))
    rstate = ref_steps.init_train_state(rcfg, ref_adamw.OptConfig(),
                                        seed=0, error_feedback_state=True)
    state = init_train_state(cfg, OptConfig(), seed=1,
                             error_feedback_state=True, device="cpu")
    state["opt"]["step"] += 4
    if direction == "reference_to_port":
        ref_ckpt.save(rstate, str(tmp_path), 4)
        got, step = ckpt_lib.load(state, str(tmp_path))
        want = _flat(jax.tree.map(np.asarray, rstate))
        got = _flat(got)
    else:
        ckpt_lib.save(state, str(tmp_path), 4)
        got, step = ref_ckpt.load(rstate, str(tmp_path))
        want = _flat(state)
        got = _flat(jax.tree.map(np.asarray, got))
    assert step == 4
    assert got.keys() == want.keys()
    assert "opt/step" in want and "params/segments/0/slot0/ssm/A_log" in want
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_train_state_from_reference_refuses_another_config():
    rstate = ref_steps.init_train_state(
        ref_reduced(ref_get_config("qwen3-0.6b")), ref_adamw.OptConfig())
    with pytest.raises(ValueError, match="do not fit"):
        convert.train_state_from_reference(
            reduced(get_config("gemma3-1b")),
            jax.tree.map(np.asarray, rstate), device="cpu")


# ------------------------------------------------------------- the CLI
def test_train_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(_mini_cfg(), OptConfig())
    rec = {}
    assert train_cli.main(argv + ["--device", "cpu"], record=rec) == 0
    assert rec["state"]["params"]["embed"].device.type == "cpu"
    assert len(rec["history"]) == 1 and rec["peak_bytes"] is None


def test_train_cli_refuses_a_data_mesh(capsys, monkeypatch):
    """The data mesh the port cannot run, D not dividing batch / accum,
    is refused; on four (mocked) cards ``--data-mesh 2`` resolves to the
    (2, 2) mesh, as the reference's (D, devices // D), and nothing is
    launched here."""
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "4",
            "--accum", "2"]
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv + ["--device", "cpu", "--data-mesh", "4"])
    assert e.value.code == 2
    assert "divide batch / accum = 2" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    launched = []
    monkeypatch.setattr(train_cli, "_launch",
                        lambda args, shape, dev, record:
                        launched.append((shape, dev.type)) or 0)
    assert train_cli.main(argv + ["--data-mesh", "2"]) == 0
    assert launched == [((2, 2), "cuda")]


def test_example_trains_on_the_cpu():
    r = subprocess.run([sys.executable, "examples/torch_train_lm.py",
                        "--device", "cpu", "--steps", "20"], cwd=REPO,
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in r.stdout.splitlines() if ln.startswith("[train] step")]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "[train] done" in r.stdout
