"""The port's lattice layer against ``repro.core.lattice``, bitwise.

Same gates (made with numpy from fixed seeds) through both packages: the
port's one layered feasibility DP against the reference's unrolled and
scan forms on both transform tiers (``f64`` / ``"xla"`` and the int32
kernel tier ``cuda`` / ``"pallas"``, whose kernels run as plain versions
here and in interpret mode in the reference), the calls the recursion
makes to its tier's convolution, the probe pivots and bracket updates of
the (G+1)-ary search, and the on-device extraction scan.
"""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as ref_lattice
from repro.core.querygraph import chain, clique, make_cardinalities
from repro_torch.core import engine, layered, lattice
from repro_torch.kernels import ops, ref

TIERS = {"f64": ("xla", np.float64), "cuda": ("pallas", np.int32)}

# the reference recursion, jitted as its programs run it
ref_feasibility_layers = jax.jit(
    ref_lattice.feasibility_layers,
    static_argnames=("n", "direct_layers", "tfm", "final_shortcut",
                     "scan_middle"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gate(n: int, dtype, seed: int) -> np.ndarray:
    """(2, 2^n) gates at a mid-range threshold: some sets cut, some not."""
    pc = np.array([bin(s).count("1") for s in range(1 << n)])
    rows = []
    for i, maker in enumerate((clique, chain)):
        card = make_cardinalities(maker(n), seed=seed + i)
        gamma = np.quantile(card[pc >= 2], 0.6 + 0.2 * i)
        rows.append(np.where(pc >= 2, card <= gamma, True))
    return np.stack(rows).astype(dtype)


def _cards(n: int, B: int) -> np.ndarray:
    """(B, 2^n) cardinalities of clique and chain queries in turn."""
    return np.stack([make_cardinalities((clique, chain)[b % 2](n),
                                        seed=n + b) for b in range(B)])


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("tier", ["f64", "cuda"])
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
@pytest.mark.parametrize("n", [5, 8, 11])
def test_feasibility_layers_bitwise(n, scan, tier):
    """The port's one recursion against each of the reference's two
    middle-layer forms (``scan``: the reference's scan form)."""
    ref_name, dtype = TIERS[tier]
    gate = _gate(n, dtype, seed=n)
    rtfm = ref_lattice.transforms(ref_name)
    ptfm = lattice.transforms(tier)
    for shortcut in (True, False):
        want = ref_feasibility_layers(
            jnp.asarray(gate), n=n, direct_layers=4, tfm=rtfm,
            final_shortcut=shortcut, scan_middle=scan)
        got = lattice.feasibility_layers(
            torch.from_numpy(gate), n, 4, ptfm, shortcut)
        for w, g in zip(want, got):
            assert np.array_equal(_np(g), _np(w))
            assert _np(g).dtype == _np(w).dtype
    # the full-table run decides V the same way the shortcut does
    assert np.array_equal(_np(got[2]), _np(want[2]))


def _counting_conv(monkeypatch, tier: str) -> list:
    """Route ``tier``'s ranked convolution through a wrapper that logs
    each call's layer; returns the log.  ``lattice.transforms`` reads
    the op at each call, so programs built afterwards take the wrapper."""
    mod, name = ((ops, "ranked_conv_op") if tier == "cuda"
                 else (ref, "ranked_conv_ref"))
    inner, ks = getattr(mod, name), []

    def conv(Z, k):
        ks.append(k)
        return inner(Z, k)
    monkeypatch.setattr(mod, name, conv)
    return ks


@pytest.mark.parametrize("case", ["fused-max-cuda", "host-cuda",
                                  "host-f64"])
def test_recursion_calls_its_tiers_convolution_once_per_layer(
        monkeypatch, case):
    """Every pass, fused or host loop, takes its tier's convolution once
    at each middle layer and once at the final layer, and nothing else
    does: layers 5..n with four direct layers."""
    where, tier = case.rsplit("-", 1)
    n = 8
    ks = _counting_conv(monkeypatch, tier)
    per_pass = list(range(5, n + 1))
    if where == "fused-max":
        cards, cand, hi0, B, _ = engine._pad_candidates(_cards(n, 2), n)
        prog = lattice.build_max_program(n, 4, tier, True)
        *_, rounds, _ = prog(torch.from_numpy(cards),
                             torch.from_numpy(cand),
                             torch.zeros(B, dtype=torch.int64),
                             torch.from_numpy(hi0))
        assert rounds > 0
        assert ks == per_pass * (rounds + 1)       # search + extraction
    else:
        gate = torch.from_numpy(_gate(n, np.float64, seed=7))
        for shortcut in (True, False):
            ks.clear()
            layered.layered_feasibility_dp(gate, n, 4, shortcut, tier=tier)
            assert ks == per_pass


@pytest.mark.parametrize("G", [1, 3])
def test_probe_pivots_and_bracket_update(G):
    rng = np.random.default_rng(G)
    B = 16
    lo = rng.integers(0, 50, B)
    hi = lo + rng.integers(0, 40, B)
    ntrue = rng.integers(0, G + 1, B)
    ok = np.arange(G)[:, None] >= (G - ntrue)[None, :]   # [F..F, T..T]
    active = lo < hi
    rp = ref_lattice.probe_pivots(jnp.asarray(lo, jnp.int32),
                                  jnp.asarray(hi, jnp.int32), G)
    pp = lattice.probe_pivots(torch.from_numpy(lo), torch.from_numpy(hi), G)
    assert np.array_equal(_np(pp), _np(rp))
    rlo, rhi = ref_lattice.bracket_update(
        jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32), rp,
        jnp.asarray(ok), jnp.asarray(active))
    plo, phi = lattice.bracket_update(
        torch.from_numpy(lo), torch.from_numpy(hi), pp,
        torch.from_numpy(ok), torch.from_numpy(active))
    assert np.array_equal(_np(plo), _np(rlo))
    assert np.array_equal(_np(phi), _np(rhi))


@pytest.mark.parametrize("n", [5, 8, 11])
def test_extract_scan_bitwise(n):
    gate = _gate(n, np.float64, seed=3 * n)
    full = np.ones_like(gate)
    for g in (gate, full):
        dp, _, feas = lattice.feasibility_layers(
            torch.from_numpy(g), n, 4, None, False)
        dpf = dp.to(torch.float64)
        want_nodes, want_lidx = ref_lattice.extract_scan(
            jnp.asarray(dpf.numpy()), n)
        nodes, lidx = lattice.extract_scan(dpf, n)
        assert np.array_equal(nodes.numpy(), np.asarray(want_nodes))
        assert np.array_equal(lidx.numpy(), np.asarray(want_lidx))
    assert bool(feas.all())                  # the ungated run is feasible


def test_search_state_and_direct_tables():
    n = 6
    for tier, (ref_name, _) in TIERS.items():
        want = ref_lattice._search_state(
            jnp.zeros((3, 1 << n)), n, ref_lattice.transforms(ref_name), 2)
        got = lattice._search_state(3, n, lattice.transforms(tier), 2,
                                    "cpu")
        assert np.array_equal(got.numpy(), np.asarray(want))
    for k in range(2, n + 1):
        for a, b in zip(lattice.direct_layer_indices(n, k),
                        ref_lattice.direct_layer_indices(n, k)):
            assert np.array_equal(a, b)


def test_transform_tiers():
    assert lattice.transforms("f64").dtype == torch.float64
    assert lattice.transforms("cuda").dtype == torch.int32
    assert lattice.transforms("cuda").ranked_conv is ops.ranked_conv_op
    assert lattice.transforms("f64").ranked_conv is ref.ranked_conv_ref
    # both tiers' transforms launch the kernels on a card
    assert lattice.transforms("f64").zeta is ops.zeta_op
    assert lattice.transforms("f64").mobius is ops.mobius_op
    assert lattice.transforms("cuda").zeta is ops.zeta_batch_op
    with pytest.raises(ValueError):
        lattice.transforms("xla")          # the reference's names only


@pytest.mark.parametrize("tier", ["f64", "cuda"])
def test_transforms_write_into_the_ranked_slot(tier):
    """``tfm.zeta(f, out=Z[k])`` fills slot k of the ranked buffer in
    place, with the bits of a fresh transform, and leaves the other
    slots alone: what ``feasibility_layers`` relies on."""
    ref_name, dtype = TIERS[tier]
    tfm = lattice.transforms(tier)
    layer = torch.from_numpy(_gate(6, dtype, seed=11))
    Z = torch.zeros((7,) + tuple(layer.shape), dtype=tfm.dtype)
    got = tfm.zeta(layer, out=Z[3])
    assert got.data_ptr() == Z[3].data_ptr()
    assert torch.equal(Z[3], tfm.zeta(layer))
    want = np.asarray(ref_lattice.transforms(ref_name).zeta(
        jnp.asarray(layer.numpy())))
    assert np.array_equal(Z[3].numpy(), want)
    assert not Z[:3].any() and not Z[4:].any()
    h = Z[3].clone()
    tfm.mobius(h, out=h)                     # in place
    assert torch.equal(h, layer)
