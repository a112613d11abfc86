"""The paper's host-loop searches in the port against ``repro``, bitwise:
the early-exit feasibility pass (the dyadic-window abort of
``core.layered``) and the single-query host loop's binary, early-exit
and (G+1)-ary searches of ``core.dpconv_max``.

The same gates and cardinality tables (numpy, fixed seeds) go through
both packages on the CPU.  Booleans and ``direct_layer_feasible`` tables
must be equal, optima equal by ``float.hex``, trees by ``str``, and the
feasibility-pass counts equal to the reference's.  The ``cuda`` case
holds the early-exit search on the card against the CPU.
"""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpconv_max as ref_dm
from repro.core import layered as ref_layered
from repro.core.bitset import popcounts
from repro.core.dpconv import optimize as ref_optimize
from repro.core.querygraph import clique, make_cardinalities
from repro_torch.core import layered
from repro_torch.core import querygraph as qg
from repro_torch.core.dpconv import optimize
from repro_torch.core.dpconv_max import (dpconv_max, dpconv_max_batch,
                                         dpconv_max_ref, feasible)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _gate(n: int, density: float, seed: int) -> np.ndarray:
    """A random f64 gate: sets of size >= 2 pass with ``density``."""
    rng = np.random.default_rng(seed)
    pc = popcounts(n)
    return np.where(pc >= 2, (rng.random(1 << n) < density)
                    .astype(np.float64), 1.0)


def _key(r):
    return (float(r.optimum).hex(), str(r.tree), r.feasibility_passes,
            r.engine)


# ------------------------------------------------ the early-exit pass
@pytest.mark.parametrize("direct_layers", [0, 4])
@pytest.mark.parametrize("density", [0.3, 0.6, 0.9])
@pytest.mark.parametrize("n", [2, 3, 6, 9])
def test_early_exit_pass_matches_reference(n, density, direct_layers):
    """The abort's boolean equals the reference's and the full pass's on
    random gates (dense ones are feasible, sparse ones die early)."""
    for seed in range(3):
        g = _gate(n, density, seed)
        want = ref_layered.layered_feasibility_early_exit(
            jnp.asarray(g), n, direct_layers)
        got = layered.layered_feasibility_early_exit(
            torch.as_tensor(g), n, direct_layers)
        full = layered.layered_feasibility_dp(torch.as_tensor(g), n,
                                              direct_layers)
        assert got is want
        assert got == bool(full[-1] > 0.5) == \
            bool(ref_layered.feasibility_dp_ref(g, n)[-1] > 0.5)


@pytest.mark.parametrize("n", [4, 7])
def test_direct_layer_feasible_matches_reference(n):
    for seed in range(2):
        g = _gate(n, 0.7, 10 + seed)
        dp = ref_layered.feasibility_dp_ref(g, n)
        for k in range(2, n + 1):
            want = np.asarray(ref_layered.direct_layer_feasible(
                jnp.asarray(dp), n, k))
            got = layered.direct_layer_feasible(torch.as_tensor(dp), n, k)
            assert got.dtype == torch.float64
            assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_feasible_probe_matches_reference(seed):
    n = 7
    card = make_cardinalities(clique(n), seed=seed)
    for gamma in np.quantile(card, [0.1, 0.5, 0.9, 1.0]):
        assert feasible(card, float(gamma), n, device=CPU) is \
            ref_dm.feasible(card, float(gamma), n)


# ------------------------------------------------------ the searches
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_early_exit_consistent(seed):
    """``tests/test_dpconv.py::test_early_exit_consistent`` against the
    port: the early-exit search is exact, with the reference's optimum,
    tree and pass count."""
    n = 8
    card = make_cardinalities(clique(n), seed=seed)
    want = ref_dm.dpconv_max(clique(n), card, early_exit=True)
    got = dpconv_max(qg.clique(n), card, early_exit=True, device=CPU)
    assert _key(got) == _key(want)
    assert got.optimum == dpconv_max_ref(card, n)
    a = dpconv_max(qg.clique(n), card, extract_tree=False,
                   early_exit=True, device=CPU)
    assert a.optimum == got.optimum and a.tree is None


@pytest.mark.parametrize("gamma_batch", [2, 4, 8])
def test_dpconv_max_batched_gamma(gamma_batch):
    """``tests/test_dpconv.py::test_dpconv_max_batched_gamma``: the fused
    (G+1)-ary search and the host loop's both equal the reference's
    optima and passes, and take no more passes than binary search."""
    q, card = qg.clique(8), make_cardinalities(clique(8), seed=3)
    for engine in ("auto", "host"):
        want = ref_dm.dpconv_max(clique(8), card, gamma_batch=gamma_batch,
                                 extract_tree=False, engine=engine)
        got = dpconv_max(q, card, gamma_batch=gamma_batch,
                         extract_tree=False, engine=engine, device=CPU)
        assert _key(got) == _key(want)
        assert got.optimum == dpconv_max_ref(card, 8)
        binary = dpconv_max(q, card, extract_tree=False, engine=engine,
                            device=CPU)
        assert got.feasibility_passes <= binary.feasibility_passes


@pytest.mark.parametrize("gamma_batch", [2, 3, 4])
def test_gamma_batch_runs_fused(gamma_batch):
    """``tests/test_engine.py::test_gamma_batch_runs_fused``: the fused
    engine folds the probes into one program; the host loop's (G+1)-ary
    search is its parity reference, and the host BATCH loop refuses the
    knob with ``ValueError``, as the reference does."""
    q, card = qg.clique(7), make_cardinalities(clique(7), seed=3)
    res = dpconv_max(q, card, gamma_batch=gamma_batch, device=CPU)
    assert res.engine == "fused" and res.dispatches == 1
    assert res.optimum == dpconv_max_ref(card, 7)
    assert res.tree.cost_max(card) == res.optimum
    for extract in (False, True):
        want = ref_dm.dpconv_max(clique(7), card, gamma_batch=gamma_batch,
                                 engine="host", extract_tree=extract)
        host = dpconv_max(q, card, gamma_batch=gamma_batch, engine="host",
                          extract_tree=extract, device=CPU)
        assert _key(host) == _key(want)
        assert host.engine == "host" and host.optimum == res.optimum
    with pytest.raises(ValueError):
        ref_dm.dpconv_max_batch(np.stack([card, card]), 7, engine="host",
                                gamma_batch=gamma_batch)
    with pytest.raises(ValueError):
        dpconv_max_batch(np.stack([card, card]), 7, engine="host",
                         gamma_batch=gamma_batch, device=CPU)


def test_early_exit_still_host_path():
    """``tests/test_engine.py::test_early_exit_still_host_path``:
    ``auto`` + ``early_exit`` runs the host loop; ``fused`` refuses."""
    q, card = qg.clique(7), make_cardinalities(clique(7), seed=1)
    res = dpconv_max(q, card, early_exit=True, extract_tree=False,
                     device=CPU)
    want = ref_dm.dpconv_max(clique(7), card, early_exit=True,
                             extract_tree=False)
    assert res.engine == want.engine == "host"
    assert _key(res) == _key(want)
    assert res.optimum == dpconv_max_ref(card, 7)
    with pytest.raises(ValueError):
        dpconv_max(q, card, early_exit=True, engine="fused", device=CPU)
    with pytest.raises(ValueError):
        dpconv_max(q, card, engine="host", shards=2, device=CPU)


@pytest.mark.parametrize("kw", [{"early_exit": True},
                                {"engine": "host", "gamma_batch": 3},
                                {"engine": "host"}],
                         ids=["early_exit", "host_g3", "host_binary"])
def test_optimize_passes_host_variants_through(kw):
    """``optimize(cost="max")`` hands ``early_exit``/``gamma_batch`` to
    the host loop: answers and meta equal the reference's."""
    n = 9
    q, card = qg.paper_clique_instance(n, seed=4)
    want = ref_optimize(clique(n), card, cost="max", **kw)
    got = optimize(q, card, cost="max", device=CPU, **kw)
    assert float(got.cost).hex() == float(want.cost).hex()
    assert str(got.tree) == str(want.tree)
    assert got.meta == want.meta


@pytest.mark.cuda
def test_early_exit_on_card_matches_cpu(cuda_device):
    n = 12
    q, card = qg.paper_clique_instance(n, seed=2)
    for kw in ({"early_exit": True}, {"engine": "host", "gamma_batch": 3}):
        a = dpconv_max(q, card, device=cuda_device, **kw)
        b = dpconv_max(q, card, device=CPU, **kw)
        assert _key(a) == _key(b)
