"""Five train steps of the port against five of ``repro``, for every
architecture.

Each of the ten reduced configs in float32 starts from the reference's
train state (``convert.train_state_from_reference``) and takes five
``make_train_step`` steps in each package on the same batches (B = 2,
S = 40, ``loss_chunk = 32``; the random pattern of ``data.synthetic``,
seeded frames for the enc-dec config): each step's loss and grad norm
within ``RTOL = 1e-4`` relative (float32 gradients agree to about 1e-5
of their scale, and AdamW's normalised updates carry that into the
next losses).  The parameters are not compared entry by entry: where a
gradient entry is rounding noise (a near-zero entry, or one that is zero
in exact arithmetic), AdamW's ``mhat / sqrt(nhat)`` turns it into a step
of the full learning rate whose sign is the noise's, so single entries
part by up to twice the learning rate per step while the losses agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import steps

ALL_ARCHS = sorted(REF_ARCHS)
RTOL = 1e-4
B, S, CHUNK, STEPS = 2, 40, 32, 5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(cfg) -> list:
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=3)
    rng = np.random.default_rng(3)
    out = []
    for i in range(STEPS):
        b = batch_at(dcfg, i)
        if cfg.family == "encdec":
            b["frames"] = rng.normal(
                size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_steps_track_reference(arch):
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    rstate = ref_steps.init_train_state(rcfg, ref_adamw.OptConfig(**OPT),
                                        seed=0)
    state = convert.train_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    rstep = jax.jit(ref_steps.make_train_step(
        rcfg, ref_adamw.OptConfig(**OPT), loss_chunk=CHUNK))
    step = steps.make_train_step(cfg, OptConfig(**OPT), loss_chunk=CHUNK)
    for i, b in enumerate(_batches(cfg)):
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            want, got = float(rmet[k]), float(met[k])
            assert abs(got - want) <= RTOL * abs(want), (i, k, got, want)
