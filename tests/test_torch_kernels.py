"""Kernels of the port against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in interpret mode, as the reference's own tests run
them.  int32 is bitwise (wraparound included: the inputs span the whole
int32 range).  f32 is bitwise on integer values below 2^24, where every
sum is exact.  On random floats the reference sums the low 8 bits with a
256x256 subset-matrix product, in another order than the butterflies:
zeta (positive terms) holds to rtol = 1e-6; Moebius cancels, so it holds
to the sum's error bound, n * 2^-24 * Σ|f|, per table.

The ``cuda`` cases hold each CUDA kernel against its plain version on the
card; they skip without one.
"""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ranked_conv import ranked_conv_pallas
from repro.kernels.ops import zeta_op as ref_zeta_op
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ranked_conv import ranked_conv_cuda
from repro_torch.kernels.zeta_cuda import launch_local, launch_pair

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
@pytest.mark.parametrize("n", [4, 11, 12])
def test_zeta_int32_bitwise(n, kind):
    rng = np.random.default_rng(100 * n + len(kind))
    x = rng.integers(-2**31, 2**31, _shape(kind, n),
                     dtype=np.int64).astype(np.int32)
    for inverse in (False, True):
        assert np.array_equal(_port(x, inverse), _reference(x, inverse))


@pytest.mark.parametrize("kind", SHAPES)
@pytest.mark.parametrize("n", [4, 11, 12])
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
    ops.ranked_conv_op(torch.ones((13, 1 << 12), dtype=torch.int32), 7)
    assert ops.launch_counts() == {"zeta_local": 0, "zeta_pair": 0,
                                   "ranked_conv": 0}
    with pytest.raises(ValueError):
        ops.zeta_batch_op(x[0])


def test_stage_plain_versions_compose_to_the_transform():
    """The per-launch plain versions (one local tile pass + one stage per
    higher bit) compose to the whole transform: what the card checks
    launch by launch is the function the reference computes."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-9, 10, (2, 1 << 14))
                         .astype(np.int32))
    for sign in (1, -1):
        y = ref.zeta_stages_ref(x, sign, 0, 12)
        for j in (12, 13):
            y = ref.zeta_stages_ref(y, sign, j, j + 1)
        full = ref.zeta_ref(x) if sign > 0 else ref.mobius_ref(x)
        assert torch.equal(y, full)


# ------------------------------------------------------ on the card only
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 12, 15])
def test_zeta_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 1 << n),
                                      dtype=np.int64).astype(np.int32))
    x = x.to(cuda_device)
    for sign in (1, -1):
        b = min(n, 12)
        out = torch.empty_like(x)
        launch_local(x, out, b, sign)
        assert torch.equal(out, ref.zeta_stages_ref(x, sign, 0, b))
        for j in range(b, n):
            y = x.clone()
            launch_pair(y, j, sign)
            assert torch.equal(y, ref.zeta_stages_ref(x, sign, j, j + 1))
        full = ops.zeta_op(x, inverse=sign < 0)
        torch.cuda.synchronize()
        assert torch.equal(full, ref.zeta_ref(x) if sign > 0
                           else ref.mobius_ref(x))


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
