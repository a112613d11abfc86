"""The port's cost model (``repro_torch.launch.costmodel``) against
``repro``'s, and its FLOP count against ``torch.utils.flop_counter``.

  * ``step_cost`` equals the reference's, field for field (``==``: the
    same arithmetic on the same configs), for every arch and every shape
    of ``SHAPES``, at ``(n_chips, tp)`` of (256, 16) and (1, 1);
  * the analytic FLOPs lie within 25% (forward) and 35% (train step) of
    what ``FlopCounterMode`` counts on the port's own forward and
    backward for reduced configs at S = 512 — the counterparts of the
    reference's bounds against XLA's cost analysis
    (``tests/test_costmodel.py``);
  * ``roofline_terms`` divides by one H100 SXM's data-sheet peaks.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import costmodel as ref_costmodel
from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import costmodel
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.steps import init_train_state, make_loss_fn
from repro_torch.tree import tree_map

ALL_ARCHS = sorted(REF_ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mesh", [(256, 16), (1, 1)], ids=["256x16", "1x1"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_step_cost_matches_reference(arch, mesh):
    n_chips, tp = mesh
    for name in sorted(REF_SHAPES):
        for opts in (None, {"remat": "dots", "attn_scheme": "zigzag",
                            "kv_cache_dtype": "int8"}):
            want = ref_costmodel.step_cost(ref_get_config(arch),
                                           REF_SHAPES[name], n_chips=n_chips,
                                           tp=tp, opts=opts)
            got = costmodel.step_cost(get_config(arch), SHAPES[name],
                                      n_chips=n_chips, tp=tp, opts=opts)
            assert (got.flops, got.hbm_bytes, got.coll_bytes) == \
                (want.flops, want.hbm_bytes, want.coll_bytes), (name, opts)


def _forward_flops_case(cfg, B: int, S: int) -> tuple:
    """(analytic forward FLOPs, counted forward FLOPs)."""
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((B, S), dtype=torch.int64)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.forward(params, cfg, tokens, remat=False)
    ana = costmodel.step_cost(cfg, ShapeSpec("case", S, B, "prefill"),
                              n_chips=1, tp=1).flops
    return ana, fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m",
                                  "gemma3-1b"])
def test_costmodel_forward_within_25pct(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), ssm_chunk=128)
    # S = 512: one q block and one k block, as in the reference's case
    ana, counted = _forward_flops_case(cfg, B=2, S=512)
    ratio = ana / counted
    assert 0.75 < ratio < 1.35, (arch, ana, counted, ratio)


def test_costmodel_train_within_35pct():
    cfg = reduced(get_config("qwen3-0.6b"))
    B, S = 2, 512
    state = init_train_state(cfg, OptConfig(), seed=0, device="cpu")
    params = tree_map(lambda a: a.requires_grad_(), state["params"])
    tokens = torch.zeros((B, S), dtype=torch.int64)
    loss_fn = make_loss_fn(cfg, loss_chunk=B * S, remat=True)
    with FlopCounterMode(display=False) as fc:
        loss, _ = loss_fn(params, tokens, tokens)
        loss.backward()
    ana = costmodel.step_cost(cfg, ShapeSpec("case", S, B, "train"),
                              n_chips=1, tp=1).flops
    # analytic includes the optimizer (tiny); the counter counts only
    # matrix products
    ratio = ana / fc.get_total_flops()
    assert 0.65 < ratio < 1.5, (ana, fc.get_total_flops(), ratio)


def test_roofline_terms_are_h100_terms():
    cfg = get_config("chameleon-34b")
    r = costmodel.roofline_terms(cfg, SHAPES["train_4k"])
    c = costmodel.step_cost(cfg, SHAPES["train_4k"])
    assert (costmodel.PEAK_FLOPS, costmodel.HBM_BW, costmodel.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert r["t_compute"] == c.flops / 256 / 989e12
    assert r["t_memory"] == c.hbm_bytes / 256 / 3.35e12
    assert r["t_collective"] == c.coll_bytes / 256 / 450e9
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < r["roofline_frac"] <= 1.0
    # training a 34B dense model at 1M tokens/step must be compute-bound
    assert r["bottleneck"] == "compute"


def test_decode_is_not_compute_bound():
    r = costmodel.roofline_terms(get_config("qwen3-0.6b"),
                                 SHAPES["decode_32k"])
    assert r["bottleneck"] in ("memory", "collective")


def test_qwen2_train_step_on_one_card():
    """The cost of smoke phase 18's step (qwen2-0.5b, 8 × 4096 tokens,
    one card): compute-bound, and its FLOPs above 6·N·tokens (remat
    replays the forward; attention and the loss are not in 6·N)."""
    cfg = get_config("qwen2-0.5b")
    shape = ShapeSpec("train_4k_b8", 4096, 8, "train")
    r = costmodel.roofline_terms(cfg, shape, n_chips=1, tp=1)
    assert r["bottleneck"] == "compute"
    assert r["flops"] > 6 * cfg.param_count() * 8 * 4096
    assert r["t_compute"] == r["flops"] / 989e12
