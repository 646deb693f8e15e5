"""The port's kernel routing and plain versions on the CPU, against the JAX
package's Pallas kernels run in interpret mode on the same numpy inputs.

The CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.diffusion import diffuse_evaporate as jax_diffuse  # noqa: E402
from repro.kernels.dominance import dominance_pass as jax_dom_pass  # noqa: E402
from repro.kernels.dominance import dominated_counts as jax_dom_counts  # noqa: E402
from repro_torch.kernels import diffusion, dominance, ops, ref  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# diffusion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,w", [(3, 8), (8, 32), (5, 72)])
def test_diffusion_matches_pallas(n, w):
    rng = np.random.default_rng(n * w)
    chem = (rng.random((n, w, w)) * 10).astype(np.float32)
    rate = rng.random(n).astype(np.float32)
    evap = (rng.random(n) * 0.5).astype(np.float32)
    expect = np.asarray(jax_diffuse(jnp.asarray(chem), jnp.asarray(rate),
                                    jnp.asarray(evap), interpret=True))
    got = ops.diffuse_evaporate(_t(chem), _t(rate), _t(evap)).numpy()
    # Same float order on both sides, but XLA may contract a multiply and
    # an add into one FMA (kept - share*ncount) where eager torch rounds
    # twice: a few ulps.
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)


def test_diffusion_conserves_mass_without_evaporation():
    rng = np.random.default_rng(5)
    chem = _t(rng.random((4, 24, 24)).astype(np.float32))
    out = ops.diffuse_evaporate(chem, torch.full((4,), 0.7),
                                torch.zeros((4,)))
    np.testing.assert_allclose(out.sum((1, 2)).numpy(),
                               chem.sum((1, 2)).numpy(), rtol=1e-5)


def test_diffusion_nonnegative():
    rng = np.random.default_rng(6)
    chem = _t(rng.random((2, 16, 16)).astype(np.float32))
    out = ops.diffuse_evaporate(chem, torch.full((2,), 0.99),
                                torch.full((2,), 0.99))
    assert (out.numpy() >= -1e-6).all()


def test_neighbor_counts():
    c = ref.neighbor_counts(5).numpy()
    assert c[0, 0] == 3 and c[0, 2] == 5 and c[2, 2] == 8
    assert c.sum() == 4 * 3 + 4 * 3 * 5 + 9 * 8


# ---------------------------------------------------------------------------
# dominance
# ---------------------------------------------------------------------------
def _objectives(rng, n, m, levels=5):
    # few distinct levels: many ties and duplicate rows
    return rng.integers(0, levels, (n, m)).astype(np.float32)


DOM_CASES = {
    "square": dict(ni=64, nj=None, m=3, groups=False, masked=0),
    "prime": dict(ni=37, nj=None, m=3, groups=False, masked=0),
    "rectangular": dict(ni=37, nj=70, m=2, groups=False, masked=0),
    "grouped": dict(ni=101, nj=None, m=3, groups=True, masked=0),
    "grouped-rect": dict(ni=40, nj=33, m=4, groups=True, masked=0),
    "masked": dict(ni=50, nj=None, m=3, groups=True, masked=9),
}


@pytest.mark.parametrize("case", sorted(DOM_CASES))
def test_dominance_pass_matches_pallas(case):
    c = DOM_CASES[case]
    rng = np.random.default_rng(len(case))
    rows = _objectives(rng, c["ni"], c["m"])
    rows[:c["masked"]] = 1.0e30          # masked lanes, as nsga2 writes them
    cols = None if c["nj"] is None else _objectives(rng, c["nj"], c["m"])
    nj = c["ni"] if cols is None else c["nj"]
    gi = rng.integers(0, 3, c["ni"]).astype(np.int32) if c["groups"] else None
    gj = (rng.integers(0, 3, nj).astype(np.int32)
          if c["groups"] and cols is not None else None)
    jarg = [None if a is None else jnp.asarray(a) for a in (cols, gi, gj)]
    jc, jb = jax_dom_pass(jnp.asarray(rows), *jarg, interpret=True)
    targ = [None if a is None else _t(a) for a in (cols, gi, gj)]
    tc, tb = ops.dominance_pass(_t(rows), *targ)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))


@pytest.mark.parametrize("n,m", [(8, 2), (64, 3), (33, 5)])
def test_dominated_counts_matches_pallas(n, m):
    rng = np.random.default_rng(n + m)
    f = _objectives(rng, n, m)
    expect = np.asarray(jax_dom_counts(jnp.asarray(f), block=32,
                                       interpret=True))
    np.testing.assert_array_equal(ops.dominated_counts(_t(f)).numpy(),
                                  expect)


def test_duplicates_do_not_dominate():
    counts, bitmap = ops.dominance_pass(torch.ones((16, 3)))
    assert not counts.any() and not bitmap.any()


def test_pack_words_and_popcount_match_numpy():
    rng = np.random.default_rng(3)
    bits = rng.random((5, 3, 32)) < 0.4
    words = ref.pack_words_u32(_t(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        words, np.asarray(jref.pack_words_u32(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        ref.popcount_rows(_t(words.view(np.int32))).numpy(),
        bits.reshape(5, -1).sum(1))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        diffusion.diffuse_evaporate(x, torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        dominance.dominance_pass(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        dominance.dominated_counts(torch.zeros((4, 3)))


def test_cpu_routing_leaves_kernel_counts_alone():
    ops.reset_kernel_launch_counts()
    ops.diffuse_evaporate(torch.zeros((2, 8, 8)), torch.zeros(2),
                          torch.zeros(2))
    ops.dominance_pass(torch.zeros((4, 3)))
    ops.dominated_counts(torch.zeros((4, 3)))
    assert ops.kernel_launch_counts() == {
        "diffuse_evaporate": 0, "dominance_pass": 0, "dominated_counts": 0}
