"""Kernels of the port against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in interpret mode, as the reference's own tests run
them.  int32 is bitwise (wraparound included: the inputs span the whole
int32 range).  f32 is bitwise on integer values below 2^24, where every
sum is exact.  On random floats the reference sums the low 8 bits with a
256x256 subset-matrix product, in another order than the butterflies:
zeta (positive terms) holds to rtol = 1e-6; Moebius cancels, so it holds
to the sum's error bound, n * 2^-24 * Σ|f|, per table.

The launch plan of a transform (one ``zeta_cluster`` launch for the low
15 bits, 14 at 8 bytes an element, then ``zeta_high`` launches of at most
``HIGH_BITS`` higher bits each) is plain Python and is checked here.  The ``cuda`` cases hold each
CUDA kernel against its plain version on the card, bitwise: int32, f32
and f64 (the float64 tier's transforms; bits run in increasing order
with each add rounded alone, so random floats are bitwise too); they
skip without one.
"""
import re
from pathlib import Path

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ranked_conv import ranked_conv_pallas
from repro.kernels.ops import zeta_op as ref_zeta_op
from repro_torch.core import engine, lattice
from repro_torch.core.querygraph import paper_clique_instance
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.ranked_conv import ranked_conv_cuda
from repro_torch.kernels.zeta_cuda import (CLUSTER_BITS, HIGH_BITS,
                                           LOW_BITS, TILE_BITS,
                                           cluster_size, launch_cluster,
                                           launch_high, launch_plan)

SHAPES = ["flat", "batch", "batch2"]


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


def _shape(kind: str, n: int) -> tuple:
    return {"flat": (1 << n,), "batch": (3, 1 << n),
            "batch2": (2, 3, 1 << n)}[kind]


def _reference(x: np.ndarray, inverse: bool) -> np.ndarray:
    # zeta_op is the reference's jitted zeta_pallas, in interpret mode
    return np.asarray(ref_zeta_op(jnp.asarray(x), inverse=inverse,
                                  interpret=True))


def _port(x: np.ndarray, inverse: bool) -> np.ndarray:
    return ops.zeta_op(torch.from_numpy(x), inverse=inverse).numpy()


@pytest.mark.parametrize("kind", SHAPES)
@pytest.mark.parametrize("n", [4, 11, 12, 16])
def test_zeta_int32_bitwise(n, kind):
    rng = np.random.default_rng(100 * n + len(kind))
    x = rng.integers(-2**31, 2**31, _shape(kind, n),
                     dtype=np.int64).astype(np.int32)
    for inverse in (False, True):
        assert np.array_equal(_port(x, inverse), _reference(x, inverse))


@pytest.mark.parametrize("kind", SHAPES)
@pytest.mark.parametrize("n", [4, 11, 12, 16])
def test_zeta_f32(n, kind):
    rng = np.random.default_rng(200 * n + len(kind))
    # integer values: every partial sum stays below 2^24, so bitwise
    xi = rng.integers(-100, 101, _shape(kind, n)).astype(np.float32)
    for inverse in (False, True):
        assert np.array_equal(_port(xi, inverse), _reference(xi, inverse))
    # random floats: the stated tolerances (module docstring)
    xf = rng.random(_shape(kind, n)).astype(np.float32)
    np.testing.assert_allclose(_port(xf, False), _reference(xf, False),
                               rtol=1e-6, atol=0)
    bound = n * 2.0**-24 * np.abs(xf).sum(axis=-1, keepdims=True)
    got, want = _port(xf, True), _reference(xf, True)
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + bound)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_zeta_high_chunks_against_reference(dtype):
    """At n = 15 + HIGH_BITS + 1 the port's plan takes two ``zeta_high``
    chunks after the cluster launch; the reference runs one
    ``_pair_pass`` per block bit.  Bitwise: full-range int32, and f32 of
    small integers (every partial sum below 2^24)."""
    n = LOW_BITS[4] + HIGH_BITS + 1
    rng = np.random.default_rng(n)
    if dtype == np.int32:
        x = rng.integers(-2**31, 2**31, 1 << n,
                         dtype=np.int64).astype(np.int32)
    else:
        x = rng.integers(-3, 4, 1 << n).astype(np.float32)
    for inverse in (False, True):
        assert np.array_equal(_port(x, inverse), _reference(x, inverse))


@pytest.mark.parametrize("n,k", [(12, 2), (12, 5), (12, 12)])
def test_ranked_conv_bitwise(n, k):
    rng = np.random.default_rng(n * 100 + k)
    Z = rng.integers(-2**31, 2**31, (n + 1, 2, 1 << n),
                     dtype=np.int64).astype(np.int32)
    want = np.asarray(ranked_conv_pallas(jnp.asarray(Z), k,
                                         interpret=True))
    assert np.array_equal(ops.ranked_conv_op(torch.from_numpy(Z), k)
                          .numpy(), want)
    Zf = rng.integers(0, 50, (n + 1, 1 << n)).astype(np.float32)
    want = np.asarray(ranked_conv_pallas(jnp.asarray(Zf), k,
                                         interpret=True))
    assert np.array_equal(ops.ranked_conv_op(torch.from_numpy(Zf), k)
                          .numpy(), want)


def test_ops_on_cpu_launch_no_kernel():
    ops.reset_launch_counts()
    x = torch.arange(3 << 12, dtype=torch.int32).reshape(3, 1 << 12)
    ops.mobius_batch_op(ops.zeta_batch_op(x))
    ops.mobius_op(ops.zeta_op(x[0].double()))      # the float64 tier's
    ops.ranked_conv_op(torch.ones((13, 1 << 12), dtype=torch.int32), 7)
    ops.connmask_op(torch.full((2, 5), 31, dtype=torch.int32), 5)
    assert ops.launch_counts() == {"zeta_cluster": 0, "zeta_high": 0,
                                   "ranked_conv": 0, "minplus_layer": 0,
                                   "connmask": 0}
    with pytest.raises(ValueError):
        ops.zeta_batch_op(x[0])


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("n", [17, LOW_BITS[4] + HIGH_BITS + 1])
def test_stage_plain_versions_compose_to_the_transform(n, dtype):
    """The per-launch plain versions of the launch plan (one cluster
    launch for the low 15 bits, 14 in float64, + ``zeta_high`` chunks of
    at most ``HIGH_BITS`` higher bits) compose to the whole transform:
    what the card checks launch by launch is the function the reference
    computes.  At n = 15 + HIGH_BITS + 1 the plan crosses a chunk
    boundary."""
    rng = np.random.default_rng(5 + n)
    x = torch.from_numpy(rng.integers(-9, 10, (2, 1 << n)).astype(dtype))
    low = LOW_BITS[x.element_size()]
    plan = launch_plan(n, x.element_size())
    assert [k for k, _, _ in plan] == (
        ["zeta_cluster"] + ["zeta_high"] * -(-(n - low) // HIGH_BITS))
    for sign in (1, -1):
        y = x
        for _, lo, hi in plan:
            y = ref.zeta_stages_ref(y, sign, lo, hi)
        full = ref.zeta_ref(x) if sign > 0 else ref.mobius_ref(x)
        assert torch.equal(y, full)


@pytest.mark.parametrize("itemsize,low", [(4, 15), (8, 14)])
@pytest.mark.parametrize("n", range(25))
def test_launch_plan_covers_each_bit_once(n, itemsize, low):
    plan = launch_plan(n, itemsize)
    bits = [j for _, lo, hi in plan for j in range(lo, hi)]
    assert bits == list(range(n))          # each bit once, increasing
    assert plan[0] == ("zeta_cluster", 0, min(n, low))
    assert all(k == "zeta_high" and lo < hi <= lo + HIGH_BITS
               for k, lo, hi in plan[1:])
    assert len(plan) == 1 + -(-max(n - low, 0) // HIGH_BITS)
    if itemsize == 8 and 15 <= n <= 19:    # the float64 tier's cliques
        assert len(plan) == 2


def test_high_bits_match_the_kernel_source():
    """``HIGH_BITS`` is the CUDA source's ``kHighMaxBits`` and
    ``TILE_BITS`` its ``Tile<T>::kBits``: the plan never asks a launch
    for more bits than the kernel takes."""
    src = (Path(build.CSRC) / "zeta.cu").read_text()
    assert re.search(rf"constexpr int kHighMaxBits = {HIGH_BITS};", src)
    assert re.search(rf"kBits = sizeof\(T\) == 4 \? {TILE_BITS[4]} : "
                     rf"{TILE_BITS[8]};", src)
    assert re.search(rf"constexpr int kMaxClusterBits = {CLUSTER_BITS};",
                     src)


@pytest.mark.parametrize("dtype,code", [(torch.int32, 0), (torch.float32, 1),
                                        (torch.float64, 2)])
def test_dtype_code_matches_the_kernel_source(dtype, code):
    """``build.dtype_code`` takes int32, float32 and float64 (the float64
    tier's zeta and Moebius), with the codes of ``csrc/common.cuh``'s
    enum; any other dtype is refused before a launch."""
    assert build.dtype_code(torch.zeros(1, dtype=dtype)) == code
    src = (Path(build.CSRC) / "common.cuh").read_text()
    name = {0: "kInt32", 1: "kFloat32", 2: "kFloat64"}[code]
    assert re.search(rf"\b{name} = {code}\b", src)
    with pytest.raises(TypeError):
        build.dtype_code(torch.zeros(1, dtype=torch.int64))


def test_cluster_size():
    assert [cluster_size(n) for n in range(19)] == (
        [1] * 13 + [2, 4, 8, 8, 8, 8])
    assert [cluster_size(n, 8) for n in range(19)] == (
        [1] * 12 + [2, 4, 8, 8, 8, 8, 8])
    for n in range(19):
        assert cluster_size(n) == 2 ** max(min(n, 15) - 12, 0)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("inverse", [False, True], ids=["zeta", "mobius"])
@pytest.mark.parametrize("where", ["fresh", "other", "self"])
def test_zeta_op_out_on_cpu(where, inverse, dtype):
    """``out=`` on CPU tensors: a given tensor or the input itself takes
    the plain version's result, bitwise."""
    rng = np.random.default_rng(7)
    if dtype == np.int32:
        a = rng.integers(-2**31, 2**31, (3, 1 << 9), dtype=np.int64)
    else:
        a = rng.integers(-100, 101, (3, 1 << 9))
    x = torch.from_numpy(a.astype(dtype))
    want = ref.mobius_ref(x) if inverse else ref.zeta_ref(x)
    keep = x.clone()
    out = {"fresh": None, "other": torch.empty_like(x), "self": x}[where]
    got = ops.zeta_batch_op(x, inverse=inverse, out=out)
    assert torch.equal(got, want)
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    if where != "self":
        assert torch.equal(x, keep)          # the input is left alone
    with pytest.raises(ValueError):
        ops.zeta_op(x, out=torch.empty((3, 1 << 8), dtype=x.dtype))


# ------------------------------------------------------ on the card only
CARD_SHAPES = {"flat": lambda n: (1 << n,), "batch": lambda n: (16, 1 << n),
               "batch2": lambda n: (2, 16, 1 << n)}


def _card_inputs(shape, seed, device, dtype=None):
    """Full-range int32, integer and random f32, integer and random f64,
    on the card; only those of ``dtype`` if given.  The integer inputs
    are exact (mobius(zeta(x)) == x)."""
    rng = np.random.default_rng(seed)
    xi = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    xf = rng.integers(-8, 9, shape).astype(np.float32)
    xr = rng.random(shape, dtype=np.float32)
    xd = rng.integers(-2**20, 2**20, shape).astype(np.float64)
    xdr = rng.standard_normal(shape)
    inputs = [(xi, True), (xf, True), (xr, False), (xd, True), (xdr, False)]
    return [(torch.from_numpy(a).to(device), exact) for a, exact in inputs
            if dtype is None or a.dtype == dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("kind", sorted(CARD_SHAPES))
@pytest.mark.parametrize("n", range(22))
def test_zeta_cluster_kernel_matches_plain_on_card(cuda_device, n, kind,
                                                   dtype):
    """Each launch of the plan against its plain version (``zeta_high``
    in place and into another tensor), the whole transform (fresh output
    and in place), and mobius(zeta(x)) == x.  Bits run in increasing
    order with each add rounded alone, so random f32 and f64 are bitwise
    too."""
    inputs = _card_inputs(CARD_SHAPES[kind](n), 10 * n + len(kind),
                          cuda_device, dtype)
    for x, exact in inputs:
        for sign in (1, -1):
            plan = launch_plan(n, x.element_size())
            out = torch.empty_like(x)
            launch_cluster(x, out, plan[0][2], sign)
            assert torch.equal(out,
                               ref.zeta_stages_ref(x, sign, 0, plan[0][2]))
            for _, lo, hi in plan[1:]:
                want = ref.zeta_stages_ref(x, sign, lo, hi)
                y = x.clone()
                launch_high(y, lo, hi, sign)
                assert torch.equal(y, want)
                y = torch.empty_like(x)
                launch_high(x, lo, hi, sign, out=y)
                assert torch.equal(y, want)
            want = ref.zeta_ref(x) if sign > 0 else ref.mobius_ref(x)
            assert torch.equal(ops.zeta_op(x, inverse=sign < 0), want)
            y = x.clone()
            assert ops.zeta_op(y, inverse=sign < 0, out=y) is y
            assert torch.equal(y, want)
        if exact:
            assert torch.equal(ops.mobius_op(ops.zeta_op(x)), x)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 1 << 15), (16, 1 << 13),
                                   (1, 1 << 16), (1, 1 << 19),
                                   (17, 1, 1 << 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_zeta_cluster_kernel_main_shape_on_card(cuda_device, shape):
    """The main path's stacks: the int32 lane's largest, (16, 16, 2^15),
    and the float64 tier's, (B, 2^n) at n = 13, 16 and 19 and a ranked
    buffer's (n+1, B, 2^n), each into a slot of a ranked buffer, as
    ``launch_plan`` says: one ``zeta_cluster`` launch a transform and
    one ``zeta_high`` launch past 15 bits (14 in float64)."""
    n = shape[-1].bit_length() - 1
    dtypes = [np.int32, np.float32] if n == 15 else [np.float64]
    for dtype in dtypes:
        per = {"zeta_cluster": 1, "zeta_high":
               len(launch_plan(n, np.dtype(dtype).itemsize)) - 1}
        ops.reset_launch_counts()
        inputs = _card_inputs(shape, n, cuda_device, dtype)
        for x, _ in inputs:
            Z = torch.zeros((3,) + tuple(x.shape), dtype=x.dtype,
                            device=cuda_device)
            for sign in (1, -1):
                want = ref.zeta_ref(x) if sign > 0 else ref.mobius_ref(x)
                got = ops.zeta_batch_op(x, inverse=sign < 0, out=Z[1])
                assert got.data_ptr() == Z[1].data_ptr()
                assert torch.equal(Z[1], want)
                assert torch.equal(Z[0], torch.zeros_like(x))
                assert torch.equal(Z[2], torch.zeros_like(x))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert {k: counts[k] for k in per} == \
            {k: 2 * len(inputs) * v for k, v in per.items()}


@pytest.mark.cuda
def test_fused_f64_program_launches_the_zeta_kernels(cuda_device,
                                                     monkeypatch):
    """A fused float64 C_max program at n = 16, eager on the card: every
    transform is one ``zeta_cluster`` and one ``zeta_high`` launch, no
    other kernel runs (the tier's convolution is the plain one), and
    the optima, trees and rounds are the CPU program's, bitwise."""
    n, B = 16, 2
    cards = np.stack([paper_clique_instance(n, seed)[1]
                      for seed in range(B)])
    cpu = engine.fused_dpconv_max(cards, n, backend="f64", device="cpu")
    transforms = [0]
    zeta_cuda = ops.zeta_cuda

    def counted(*args, **kw):
        transforms[0] += 1
        return zeta_cuda(*args, **kw)

    engine.clear_executable_cache()
    monkeypatch.setattr(lattice, "uses_graphs", lambda device, mesh: False)
    monkeypatch.setattr(ops, "zeta_cuda", counted)
    try:
        ops.reset_launch_counts()
        got = engine.fused_dpconv_max(cards, n, backend="f64",
                                      device=cuda_device)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        engine.clear_executable_cache()
    assert counts == {"zeta_cluster": transforms[0],
                      "zeta_high": transforms[0], "ranked_conv": 0,
                      "minplus_layer": 0, "connmask": 0}
    assert transforms[0] > 0
    assert [o.hex() for o in got.optima] == [o.hex() for o in cpu.optima]
    assert [str(t) for t in got.trees] == [str(t) for t in cpu.trees]
    assert (got.rounds, got.passes) == (cpu.rounds, cpu.passes)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 7, 15])
def test_ranked_conv_kernel_matches_plain_on_card(cuda_device, k):
    rng = np.random.default_rng(k)
    for shape in [(16, 4, 1 << 15), (16, 3, 33)]:
        Z = torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                          dtype=np.int64).astype(np.int32))
        Z = Z.to(cuda_device)
        got = ranked_conv_cuda(Z, k)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.ranked_conv_ref(Z, k))
