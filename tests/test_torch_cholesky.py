"""The port's blocked Cholesky (B5) and fused assemble-and-factor (B6) on
the CPU: the plain versions in ``repro_torch.kernels.ref`` and the routing
in ``repro_torch.kernels.ops``, against the JAX package's jitted oracles
(``repro.kernels.ref.chol_blocked_ref`` / ``gp_chol_blocked_ref``, which
``tests/test_cholesky.py`` holds bitwise to the Pallas kernels in interpret
mode) and, once, against ``repro.kernels.ops.gp_chol``, which runs the Pallas
kernel in interpret mode. Inputs come from numpy with a seed.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import cholesky, ops, ref  # noqa: E402

# The two sides factor through the same tile schedule but XLA and PyTorch
# take their tile products in other summation orders (and XLA may contract
# into FMAs): the reference's own tolerance between its oracle and LAPACK.
TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _spd(n, seed):
    """A B^T / n + I: eigenvalues in about [1, 5]."""
    b = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return (b @ b.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def _points(n, n_p, d, seed):
    x = np.zeros((n_p, d), np.float32)
    x[:n] = np.random.default_rng(seed).random((n, d)).astype(np.float32)
    return x


@functools.lru_cache(maxsize=None)
def _jax_chol(block):
    return jax.jit(lambda a: jref.chol_blocked_ref(a, block=block))


@functools.lru_cache(maxsize=None)
def _jax_gp_chol(n, kind, lengthscale, nugget, block):
    return jax.jit(lambda x: jref.gp_chol_blocked_ref(
        x, n, kind=kind, lengthscale=lengthscale, nugget=nugget, block=block))


# ---------------------------------------------------------------------------
# the tile helpers
# ---------------------------------------------------------------------------
def test_chol_base_and_tile_match_the_reference():
    a = _spd(128, 1)
    np.testing.assert_allclose(
        ref.chol_base_ref(_t(a[:64, :64])).numpy(),
        np.asarray(jax.jit(jref.chol_base_ref)(jnp.asarray(a[:64, :64]))),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        ref.chol_tile_ref(_t(a)).numpy(),
        np.asarray(jax.jit(jref.chol_tile_ref)(jnp.asarray(a))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_gp_tile_matches_the_reference(kind):
    """A tile that straddles the true size: nugget on the true diagonal,
    identity past n (exact), the covariance within 2e-6 (XLA may contract
    the distance's multiply-adds into FMAs; the port rounds each)."""
    x = _points(50, 64, 3, 7)
    args = (64, 0, 50)
    kw = dict(kind=kind, lengthscale=0.3, nugget=1e-4)
    got = ref.gp_tile_ref(_t(x), _t(x[:64]), *args, **kw).numpy()
    expect = np.asarray(jref.gp_tile_ref(jnp.asarray(x), jnp.asarray(x[:64]),
                                         *args, **kw))
    np.testing.assert_allclose(got, expect, rtol=2e-6, atol=2e-6)
    square = ref.gp_tile_ref(_t(x), _t(x), 0, 0, 50, **kw).numpy()
    np.testing.assert_array_equal(square[50:, 50:], np.eye(14))
    np.testing.assert_array_equal(square[50:, :50], 0.0)
    assert (np.diag(square)[:50] > 1.0).all()


# ---------------------------------------------------------------------------
# B5: blocked Cholesky
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_p,block", [(128, 64), (256, 64), (256, 128),
                                       (512, 256)])
def test_chol_blocked_matches_the_jax_oracle(n_p, block):
    a = _spd(n_p, n_p + block)
    got = ref.chol_blocked_ref(_t(a), block=block).numpy()
    expect = np.asarray(_jax_chol(block)(jnp.asarray(a)))
    np.testing.assert_allclose(got, expect, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


@pytest.mark.parametrize("case", ["zero-row", "negative-pivot"])
def test_chol_blocked_zero_pivot_does_not_raise(case):
    """A zero pivot (a zero row and column in the second tile) or a
    negative one: the guard sqrt(max(a_jj, 1e-30)) takes it as 1e-30, as
    the reference does; no error, the same entries finite, the rest of the
    factor as the reference's."""
    a = _spd(128, 3)
    if case == "zero-row":
        a[70, :] = 0.0
        a[:, 70] = 0.0
    else:
        a[3, :] = 0.0
        a[:, 3] = 0.0
        a[3, 3] = -1.0
    got = ref.chol_blocked_ref(_t(a), block=64).numpy()
    expect = np.asarray(_jax_chol(64)(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(expect))
    np.testing.assert_allclose(got, expect, rtol=TOL, atol=TOL)
    p = 70 if case == "zero-row" else 3
    assert got[p, p] == np.float32(1e-15)


# ---------------------------------------------------------------------------
# B6: fused assembly + blocked Cholesky
# ---------------------------------------------------------------------------
# XLA contracts the reference's distance multiply-adds into FMAs, so its K
# keeps a few ulps of |x|^2 where the port's distance of a point to itself
# is exactly 0: up to 1e-5 apart in K at lengthscale 0.2 (|dk/dd2| <=
# 5 / (6 ls^2) = 21 near 0). The matrices here have condition numbers up to
# 2e4, which turns that into up to 2.4e-4 between the two fused factors.
# So the test holds the assembly, and the factorization on the reference's
# own K, each within TOL, and the padding exactly; and it holds the gap
# between the fused factors to what the witness below explains: the float64
# factor of the exactly assembled K, from which each side must be about as
# far as the other.
WITNESS_TOL = 2.5e-4    # each fused factor from the float64 one: 1.6e-4 read
GAP_TOL = 4e-4          # the two fused factors apart: 2.4e-4 read
K_EXACT_TOL = 1e-5      # each f32 K from the float64 one: 7.4e-6 read


def _gp_matrix_f64(x, n, kind, lengthscale, nugget):
    """K(x, x) + nugget I of the first n points, in float64 from the
    differences of the coordinates: the matrix both f32 sides round."""
    p = x[:n].astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        k = np.exp(-0.5 * d2 / lengthscale ** 2)
    else:
        r = np.sqrt(d2) / lengthscale
        k = (1.0 + np.sqrt(5.0) * r + 5.0 / 3.0 * r * r) \
            * np.exp(-np.sqrt(5.0) * r)
    return k + nugget * np.eye(n)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("n", [83, 96, 128])      # prime, in a tile, full
def test_gp_chol_blocked_matches_the_jax_oracle(n, kind):
    n_p, block = 128, 64
    x = _points(n, n_p, 3, n)
    kw = dict(kind=kind, lengthscale=0.2, nugget=1e-4)
    k_jax = np.asarray(jax.jit(lambda xx: jref.gp_tile_ref(
        xx, xx, 0, 0, n, **kw))(jnp.asarray(x)))
    k_port = ref.gp_tile_ref(_t(x), _t(x), 0, 0, n, **kw).numpy()
    np.testing.assert_allclose(k_port, k_jax, rtol=TOL, atol=TOL)
    expect = np.asarray(_jax_gp_chol(n, kind, 0.2, 1e-4, block)(
        jnp.asarray(x)))
    # fed the reference's own K, the port's factor closes the gap
    np.testing.assert_allclose(
        ref.chol_blocked_ref(_t(k_jax), block=block).numpy(), expect,
        rtol=TOL, atol=TOL)
    got = ref.gp_chol_blocked_ref(_t(x), n, block=block, **kw).numpy()
    # the pad factors as exactly I, and nothing couples it to the points
    np.testing.assert_array_equal(got[n:, n:], np.eye(n_p - n))
    np.testing.assert_array_equal(got[n:, :n], 0.0)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)
    np.testing.assert_allclose(got[:n, :n] @ got[:n, :n].T, k_port[:n, :n],
                               rtol=TOL, atol=TOL)
    # the witness: both K round the same float64 matrix; both fused factors
    # are near its float64 factor, neither twice as far as the other, and
    # within GAP_TOL of each other
    k64 = _gp_matrix_f64(x, n, **kw)
    l64 = np.linalg.cholesky(k64)
    for k in (k_port, k_jax):
        np.testing.assert_allclose(k[:n, :n], k64, rtol=0, atol=K_EXACT_TOL)
    err_port = np.abs(got[:n, :n] - l64).max()
    err_jax = np.abs(expect[:n, :n] - l64).max()
    assert err_port < WITNESS_TOL and err_jax < WITNESS_TOL, \
        (err_port, err_jax)
    assert err_port <= 2 * err_jax and err_jax <= 2 * err_port, \
        (err_port, err_jax)
    np.testing.assert_allclose(got, expect, rtol=GAP_TOL, atol=GAP_TOL)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
def test_gp_chol_blocked_is_the_factor_of_the_assembled_matrix(kind):
    """Fusing the assembly into the factorization changes no bit: the fused
    plain version equals the plain factor of the plainly assembled K."""
    n, n_p, block = 150, 256, 64
    x = _t(_points(n, n_p, 4, 11))
    kw = dict(kind=kind, lengthscale=0.25, nugget=1e-4)
    fused = ref.gp_chol_blocked_ref(x, n, block=block, **kw)
    k = ref.gp_tile_ref(x, x, 0, 0, n, **kw)
    assert torch.equal(fused, ref.chol_blocked_ref(k, block=block))


def test_gp_chol_matches_the_reference_kernel_in_interpret_mode():
    """repro.kernels.ops.gp_chol at n = 83, block 64 runs the Pallas kernel
    (interpret mode); the port's ops.gp_chol on the same points."""
    x = _points(83, 83, 8, 5)
    expect = np.asarray(jops.gp_chol(jnp.asarray(x), kind="matern52",
                                     lengthscale=0.2, nugget=1e-4, block=64))
    got = ops.gp_chol(_t(x), kind="matern52", lengthscale=0.2, nugget=1e-4,
                      block=64).numpy()
    assert got.shape == (83, 83)
    np.testing.assert_allclose(got, expect, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the entry points: padding, block contract, routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,block", [(100, 64), (200, 128), (64, 256)])
def test_ops_factor_ragged_sizes(n, block):
    a = _spd(n, n)
    l = ops.chol_factor(_t(a), block=block).numpy()
    assert l.shape == (n, n)
    np.testing.assert_allclose(l @ l.T, a, rtol=3e-5, atol=3e-5)
    x = _points(n, n, 5, n + 1)
    lg = ops.gp_chol(_t(x), kind="rbf", lengthscale=0.3, nugget=1e-4,
                     block=block).numpy()
    k = ref.gp_matrix_ref(_t(x), _t(x), kind="rbf",
                          lengthscale=0.3).numpy() + 1e-4 * np.eye(n)
    np.testing.assert_allclose(lg @ lg.T, k, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("block", [32, 96, 192])
def test_ops_refuse_a_block_that_is_not_64_times_a_power_of_two(block):
    with pytest.raises(ValueError, match="64"):
        ops.chol_factor(torch.eye(8), block=block)
    with pytest.raises(ValueError, match="64"):
        ops.gp_chol(torch.zeros((8, 2)), block=block)


def test_cpu_tensors_never_reach_a_kernel():
    ops.reset_kernel_launch_counts()
    ops.chol_factor(torch.eye(70), block=64)
    ops.gp_chol(torch.rand((70, 2)), block=64)
    counts = ops.kernel_launch_counts()
    assert counts["chol_blocked"] == 0 and counts["gp_chol_blocked"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        cholesky.chol_blocked(torch.eye(64))
    with pytest.raises(ValueError, match="CUDA"):
        cholesky.gp_chol_blocked(torch.zeros((64, 2)), 64, kind="rbf",
                                 lengthscale=0.2, nugget=1e-4)
