"""The port's kernel routing and plain versions on the CPU, against the JAX
package's Pallas kernels run in interpret mode on the same numpy inputs;
and the thread safety of the kernel build and launch counters.

The CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cholesky import tri_solve_blocked as jax_tri_solve  # noqa: E402
from repro.kernels.diffusion import diffuse_evaporate as jax_diffuse  # noqa: E402
from repro.kernels.dominance import dominance_pass as jax_dom_pass  # noqa: E402
from repro.kernels.dominance import dominated_counts as jax_dom_counts  # noqa: E402
from repro.kernels.gp import gp_matrix as jax_gp_matrix  # noqa: E402
from repro.kernels.gp import gp_sqdist as jax_gp_sqdist  # noqa: E402
from repro_torch.kernels import (build, cholesky, diffusion, dominance,  # noqa: E402
                                 gp, ops, ref)


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
def _objectives(rng, n, m, levels=5, special=False):
    # few distinct levels: many ties and duplicate rows; ``special`` puts
    # -0.0, NaN and +-inf in a tenth of the entries
    x = rng.integers(0, levels, (n, m)).astype(np.float32)
    if special:
        values = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf], np.float32)
        at = rng.random((n, m)) < 0.1
        x[at] = rng.choice(values, at.sum())
    return x


DOM_CASES = {
    "square": dict(ni=64, nj=None, m=3, groups=False, masked=0),
    "prime": dict(ni=37, nj=None, m=3, groups=False, masked=0),
    "rectangular": dict(ni=37, nj=70, m=2, groups=False, masked=0),
    "grouped": dict(ni=101, nj=None, m=3, groups=True, masked=0),
    "grouped-rect": dict(ni=40, nj=33, m=4, groups=True, masked=0),
    "masked": dict(ni=50, nj=None, m=3, groups=True, masked=9),
    "special": dict(ni=70, nj=None, m=3, groups=False, masked=5,
                    special=True),
    "special-m8": dict(ni=45, nj=66, m=8, groups=True, masked=0,
                       special=True, levels=3),
}


@pytest.mark.parametrize("case", sorted(DOM_CASES))
def test_dominance_pass_matches_pallas(case):
    c = DOM_CASES[case]
    rng = np.random.default_rng(len(case))
    kw = dict(levels=c.get("levels", 5), special=c.get("special", False))
    rows = _objectives(rng, c["ni"], c["m"], **kw)
    rows[:c["masked"]] = 1.0e30          # masked lanes, as nsga2 writes them
    cols = None if c["nj"] is None else _objectives(rng, c["nj"], c["m"],
                                                    **kw)
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


def test_special_cases_hold_ieee_compares():
    """-0.0 equals +0.0, NaN neither dominates nor is dominated, +-inf
    compare as IEEE says (the semantics the CUDA kernels' keys keep)."""
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([[0.0, 1.0], [-0.0, 1.0], [nan, 0.0], [-inf, 2.0],
                         [inf, inf], [inf, 5.0]])
    counts, bitmap = ops.dominance_pass(rows)
    # row 3 (-inf, 2) dominates none of rows 0/1 (2 > 1); rows 0..1 and 3
    # dominate (inf, inf) and (inf, 5); (inf, 5) dominates (inf, inf)
    assert counts.tolist() == [0, 0, 0, 0, 4, 3]
    assert bitmap[:, 0].tolist() == [0, 0, 0, 0, 0b101011, 0b001011]


@pytest.mark.parametrize("ni,nj", [
    (1, 1), (256, 256), (2048, 2048), (8192, 8192), (50000, 50000),
    (100, 33), (40, 300), (320, 320), (129, 2048), (50000, 64), (20, 0)])
def test_dominance_launch_config_covers_each_row_word_once(ni, nj):
    """Every (row, word) pair falls in exactly one block: row tiles of
    TILE_ROWS cover the rows once, splits of whole passes cover the words
    once, none empty; the grid within CUDA's limits for 132 SMs."""
    cfg = dominance.launch_config(ni, nj, 3, 132)
    words = -(-nj // 32)
    assert cfg.words == words and cfg.threads == dominance.THREADS
    assert 1 <= cfg.grid[0] <= 2**31 - 1 and 1 <= cfg.grid[1] <= 65535
    rows = np.zeros(ni, int)
    for x in range(cfg.grid[0]):
        rows[x * dominance.TILE_ROWS:(x + 1) * dominance.TILE_ROWS] += 1
    assert (rows == 1).all() and (cfg.grid[0] - 1) * dominance.TILE_ROWS < ni
    assert cfg.split_words % dominance.PASS_WORDS == 0
    covered = np.zeros(words, int)
    for y in range(cfg.splits):
        span = covered[y * cfg.split_words:(y + 1) * cfg.split_words]
        assert span.size > 0 or words == 0     # no empty split
        span += 1
    assert (covered == 1).all()
    assert cfg.col_stride == 4


def test_dominance_launch_config_fills_the_card():
    """The splits put about two blocks on each of the SMs where the rows
    alone do not, and one split where they do or where the columns are
    one pass; M past 8 takes the generic kernel (no staging)."""
    lc = dominance.launch_config
    assert lc(8192, 8192, 3, 132).splits == 4      # 64 tiles x 4
    assert lc(2048, 2048, 3, 132).splits == 8      # 16 tiles x 8
    assert lc(256, 256, 3, 132).splits == 1        # one pass of words
    assert lc(50000, 50000, 3, 132).grid[0] == 391
    assert [lc(64, 64, m, 132).col_stride for m in (1, 2, 3, 4, 5, 8, 9, 0)] \
        == [1, 2, 4, 4, 8, 8, 0, 0]


def _fake_dominance_build(extra=()):
    """A stand-in for ``build`` whose dominance library holds the 29
    kernels of ``csrc/dominance.cu`` (plus ``extra``), mangled as nvcc
    names them in the file's anonymous namespace."""
    import types
    names = [f"_ZN12_GLOBAL__N_116dominance_kernelILi{m}ELb{g}ELb{b}EEEvNS_"
             f"4ArgsE" for m in range(9) for g, b in ((0, 1), (1, 1), (0, 0))]
    names += [f"_ZN12_GLOBAL__N_122dominance_probe_kernelILb{b}EEEvPKfiPxPi"
              for b in (0, 1)] + list(extra)
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {40 + i} registers, used 1 barriers, "
        f"{1000 + i} bytes smem, 400 bytes cmem[0]"
        for i, name in enumerate(names))
    sass = "\n".join(
        f"\t\tFunction : {name}\n"
        f"        /*0000*/                   FADD R2, R4, -R6 ;\n"
        f"        /*0010*/              @P0  LOP3.LUT R1, R2, R3, R5, 0xfe, !PT ;"
        for name in names)
    return types.SimpleNamespace(
        build_log=lambda name: log, sass=lambda name: sass,
        kernel_resources=build.kernel_resources,
        sass_counts=build.sass_counts)


def test_dominance_build_report_names_every_kernel():
    """chip_smoke's build line for dominance.cu: each instantiation (M,
    groups, bitmap) and both probes, with registers, spills, static shared
    memory and SASS opcode counts; an unknown kernel fails the phase."""
    smoke = _chip_smoke()
    rows = smoke.dominance_build_report(_fake_dominance_build())
    assert len(rows) == 29
    row = rows["dominance_kernel<0,0,1>"]
    assert row["registers"] == 40 and row["static_smem_bytes"] == 1000
    assert row["FADD"] == 1 and row["LOP3"] == 1 and row["FSETP"] == 0
    assert "dominance_probe_kernel<subtract>" in rows
    assert "dominance_kernel<8,1,1>" in rows
    with pytest.raises(RuntimeError, match="unknown kernel"):
        smoke.dominance_build_report(_fake_dominance_build(
            ["_ZN12_GLOBAL__N_118dominance_old_kernelEPKfi"]))


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
    with pytest.raises(ValueError, match="CUDA"):
        dominance.pass_phase_cycles(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        gp.gp_sqdist(torch.zeros((4, 2)), torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        gp.gp_matrix(torch.zeros((4, 2)), torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        cholesky.tri_solve_blocked(torch.eye(64), torch.zeros((64, 64)))


def test_cpu_routing_leaves_kernel_counts_alone():
    ops.reset_kernel_launch_counts()
    ops.diffuse_evaporate(torch.zeros((2, 8, 8)), torch.zeros(2),
                          torch.zeros(2))
    ops.dominance_pass(torch.zeros((4, 3)))
    ops.dominated_counts(torch.zeros((4, 3)))
    ops.gp_sqdist(torch.zeros((4, 2)), torch.zeros((3, 2)))
    ops.gp_matrix(torch.zeros((4, 2)), torch.zeros((3, 2)))
    ops.tri_solve(torch.eye(5), torch.zeros((5, 2)))
    ops.chol_factor(torch.eye(5), block=64)
    ops.gp_chol(torch.zeros((5, 2)), block=64)
    q = torch.zeros((1, 8, 2, 16))
    ops.flash_attention_gqa(q, q, q)
    ops.flash_attention_or_ref(q, q, q)
    ops.flash_attention_gqa_diff(q.requires_grad_(), q, q).sum().backward()
    assert ops.kernel_launch_counts() == {
        "diffuse_evaporate": 0, "dominance_pass": 0, "dominated_counts": 0,
        "gp_sqdist": 0, "gp_matrix": 0, "tri_solve": 0,
        "tri_solve_backward": 0, "chol_blocked": 0,
        "gp_chol_blocked": 0, "flash_attention": 0, "flash_attention_fwd": 0,
        "flash_attention_dq": 0, "flash_attention_dkv": 0}


# ---------------------------------------------------------------------------
# GP covariance assembly (B4)
# ---------------------------------------------------------------------------
GP_CASES = {
    "square-d2": dict(n1=64, n2=None, d=2, dup=0),
    "prime-d2": dict(n1=37, n2=53, d=2, dup=0),
    "prime-d5": dict(n1=41, n2=29, d=5, dup=0),
    "duplicates-d5": dict(n1=31, n2=None, d=5, dup=8),
}


def _gp_inputs(case):
    c = GP_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + c["d"])
    x1 = rng.random((c["n1"], c["d"])).astype(np.float32)
    x1[1:1 + c["dup"]] = x1[0]            # duplicate rows: d2 = 0 exactly
    x2 = x1 if c["n2"] is None else rng.random(
        (c["n2"], c["d"])).astype(np.float32)
    return x1, x2


# The port sums over D in a fixed column order without FMA; XLA contracts
# the reference's multiply-adds into FMAs, so where the expanded form
# cancels (a point against itself) the reference keeps a few ulps of
# ||x||^2 <= D, up to ~1e-6, where the port gets exactly 0. Tolerance: atol
# 2e-6 (squared norms of unit-cube points are at most 5 here).
@pytest.mark.parametrize("case", sorted(GP_CASES))
def test_gp_sqdist_matches_pallas(case):
    x1, x2 = _gp_inputs(case)
    expect = np.asarray(jax_gp_sqdist(jnp.asarray(x1), jnp.asarray(x2),
                                      interpret=True))
    got = ops.gp_sqdist(_t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(got, expect, rtol=0, atol=2e-6)
    if GP_CASES[case]["dup"]:
        assert (got[:9, :9] == 0).all()


# The covariance maps carry the distances' differences through: RBF moves
# by variance * 0.5 / lengthscale^2 ~ 8.3 times a d2 difference, so the
# reference's ~1e-6 diagonal residue (above) allows ~1e-5: atol 1e-5.
# Matérn takes sqrt(d2): that residue becomes r ~ 3e-3 at lengthscale 0.3
# and lowers k(x, x) by ~1.3e-5 of the variance, where the port keeps
# exactly the variance: atol 3e-5.
GP_MATRIX_ATOL = {"matern52": 3e-5, "rbf": 1e-5}


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("case", sorted(GP_CASES))
def test_gp_matrix_matches_pallas(case, kind):
    x1, x2 = _gp_inputs(case)
    expect = np.asarray(jax_gp_matrix(jnp.asarray(x1), jnp.asarray(x2),
                                      kind=kind, lengthscale=0.3,
                                      variance=1.5, interpret=True))
    got = ops.gp_matrix(_t(x1), _t(x2), kind=kind, lengthscale=0.3,
                        variance=1.5).numpy()
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=GP_MATRIX_ATOL[kind])
    if x2 is x1:
        assert (np.diagonal(got) == np.float32(1.5)).all()


def test_gp_kernel_fn_gradient_is_finite_at_zero_distance():
    x = torch.tensor([[0.2, 0.4], [0.2, 0.4], [0.7, 0.1]], requires_grad=True)
    k = ref.gp_kernel_fn("matern52", ref.gp_sqdist_ref(x, x), 0.2, 1.0)
    (g,) = torch.autograd.grad(k.sum(), x)
    assert torch.isfinite(g).all()
    assert torch.equal(torch.diagonal(k), torch.ones(3))


# ---------------------------------------------------------------------------
# blocked triangular solve (B7)
# ---------------------------------------------------------------------------
def _lower(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    k = a @ a.T / n + np.eye(n, dtype=np.float32)
    return np.linalg.cholesky(k.astype(np.float64)).astype(np.float32)


# Both sides substitute tile by tile through explicit inverses of the
# diagonal tiles, but sum their tile products in other orders (matmul
# order is the library's on each side): L is well conditioned here
# (K = A A^T / n + I), so X agrees to rtol/atol 1e-5.
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m_p", [64, 128])
def test_tri_solve_blocked_matches_pallas(trans, m_p):
    n_p, block = 192, 64
    l = _lower(n_p, 5)
    b = np.random.default_rng(11).standard_normal((n_p, m_p)).astype(
        np.float32)
    expect = np.asarray(jax_tri_solve(jnp.asarray(l), jnp.asarray(b),
                                      trans=trans, block=block,
                                      rhs_block=64, interpret=True))
    got = ref.tri_solve_blocked_ref(_t(l), _t(b), trans=trans,
                                    block=block).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("shape", [(100, 37), (70, None)])
def test_ops_tri_solve_pads_ragged_and_vector_rhs(trans, shape):
    """``ops.tri_solve`` identity-pads a ragged L and zero-pads B (also a
    vector b) to tile multiples like the reference's, then slices back."""
    from repro.kernels import ops as jops
    n, m = shape
    l = _lower(n, 2)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)
    expect = np.asarray(jops.tri_solve(jnp.asarray(l), jnp.asarray(b),
                                       trans=trans, block=64, rhs_block=64))
    got = ops.tri_solve(_t(l), _t(b), trans=trans, block=64,
                        rhs_block=64).numpy()
    assert got.shape == b.shape
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    lt = l.T if trans else l
    np.testing.assert_allclose(lt.astype(np.float64) @ got, b, atol=1e-4)


# The solve kernel's launch shape (csrc/trisolve.cu), chosen in Python: a
# strip width that divides m_p, gives every SM a strip where m_p allows,
# and keeps the whole solved panel in shared memory where it can.
@pytest.mark.parametrize("n_p,m_p,sms,want", [
    (512, 50176, 132, 64), (512, 2048, 132, 16), (1024, 50176, 132, 16),
    (2048, 50176, 132, 16), (4096, 64, 132, 16), (64, 64, 132, 16),
    (512, 320, 132, 16), (512, 8448, 132, 64), (512, 8384, 132, 16),
    (256, 128, 2, 64), (256, 64, 2, 16), (64, 64, 1, 64)])
def test_solve_strip_fills_the_card_and_fits(n_p, m_p, sms, want):
    strip = cholesky.solve_strip(n_p, m_p, sms)
    assert strip == want
    assert m_p % strip == 0 and strip in cholesky.STRIPS
    resident = cholesky.solve_resident(n_p, strip)
    assert 1 <= resident <= n_p // 64
    assert cholesky.solve_smem_bytes(strip, resident) <= build.SMEM_PER_BLOCK
    if m_p // 16 >= sms:        # m_p allows one strip per SM
        assert m_p // strip >= sms
    if strip != 16:             # a wider strip only with the whole panel
        assert resident == n_p // 64
    # the widest strip that meets both: no wider one would
    for wider in cholesky.STRIPS[:cholesky.STRIPS.index(strip)]:
        assert m_p // wider < sms \
            or cholesky.solve_resident(n_p, wider) < n_p // 64


@pytest.mark.parametrize("n_p,resident", [(64, 1), (512, 8), (2048, 32),
                                          (4096, 42), (65536, 42)])
def test_solve_resident_holds_what_fits(n_p, resident):
    assert cholesky.solve_resident(n_p, 16) == resident
    assert cholesky.pack_tiles(n_p) == (n_p // 64) * (n_p // 64 + 1) // 2


# The diffusion kernel's persistent launch (csrc/diffusion.cu), chosen in
# Python from the world's size and the SM count.
@pytest.mark.parametrize("n,w,sms,ring,per_sm,grid", [
    (20480, 72, 132, True, 3, 396), (640, 72, 132, True, 3, 396),
    (131, 72, 132, True, 3, 131), (1, 72, 132, True, 3, 1),
    (7, 33, 132, True, 7, 7), (5000, 33, 132, True, 7, 924),
    (3, 120, 132, True, 1, 3), (500, 139, 132, True, 1, 132),
    (500, 140, 132, False, 2, 264), (500, 238, 132, False, 1, 132),
    (9000, 8, 132, True, 32, 4224), (20480, 72, 114, True, 3, 342)])
def test_diffusion_launch_config(n, w, sms, ring, per_sm, grid):
    cfg = diffusion.launch_config(n, w, sms)
    assert (cfg.ring, cfg.blocks_per_sm, cfg.grid) == (ring, per_sm, grid)
    assert cfg.grid == min(n, sms * cfg.blocks_per_sm)
    assert cfg.smem_bytes == diffusion.BAR_BYTES \
        + (3 if cfg.ring else 1) * w * w * 4
    assert cfg.smem_bytes <= build.SMEM_PER_BLOCK
    assert cfg.blocks_per_sm * (cfg.smem_bytes + build.SMEM_RESERVED) \
        <= build.SMEM_PER_SM
    assert cfg.threads % 32 == 0 and w * cfg.bands <= cfg.threads <= 512
    assert 1 <= cfg.bands <= w
    # one world only where two and a share buffer do not fit
    assert cfg.ring == (diffusion.BAR_BYTES + 3 * w * w * 4
                        <= build.SMEM_PER_BLOCK)


def test_diffusion_launch_config_refuses_worlds_it_cannot_hold():
    with pytest.raises(ValueError, match="world"):
        diffusion.launch_config(4, diffusion.MAX_WORLD + 1, 132)


@pytest.mark.parametrize("w,offset,want", [
    (72, 0, "bulk"), (8, 0, "bulk"), (2, 0, "bulk"), (238, 0, "bulk"),
    (33, 0, "cp_async"), (1, 0, "cp_async"), (72, 1, "cp_async"),
    (72, 4, "bulk")])
def test_diffusion_route(w, offset, want):
    """Bulk copies need each lane's world a whole number of 16-byte chunks
    and the field on a 16-byte boundary; anything else takes cp.async."""
    base = torch.zeros(2 * w * w + offset + 4)
    chem = base[offset:offset + 2 * w * w].view(2, w, w)
    assert diffusion.route(chem) == want


def test_tri_solve_refuses_a_block_that_is_not_64_times_a_power_of_two():
    with pytest.raises(ValueError, match="64"):
        ops.tri_solve(torch.eye(4), torch.zeros(4), block=96)


def test_tri_inv_tile_matches_reference():
    l = _lower(128, 9)
    expect = np.asarray(jax.jit(jref.tri_inv_tile_ref)(jnp.asarray(l)))
    np.testing.assert_allclose(ref.tri_inv_tile_ref(_t(l)).numpy(), expect,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# thread safety of the build and the launch counters
# ---------------------------------------------------------------------------
def test_load_from_eight_threads_builds_once(monkeypatch, tmp_path):
    builds = []

    def fake_build(names):
        builds.append(tuple(names))
        for name in names:
            build.library_path(name).write_bytes(b"")
        return {}

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            build.load("gp"))) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("gp",)]
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counter_is_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(wrapper) for _ in range(1000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 8 * 1000


def test_build_names_its_temporary_file_per_thread(monkeypatch, tmp_path):
    seen = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])

        def wait(self):
            return 1

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakePopen)
    with pytest.raises(RuntimeError, match="build failed"):
        build.build(["gp"])
    assert f"{threading.get_ident()}" in seen[0]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiif
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 412 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a10*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0a20*/              @P0  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0a30*/                   HGMMA.64x64x16.F32.BF16 R88, R56, gdesc[UR8], R88 ;
\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_iiiif
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   HMMAX R1 ;
"""


def test_kernel_resources_reads_ptxas_report():
    got = build.kernel_resources(PTXAS_LOG)
    assert got == {
        "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_"
        "stS1_S1_P13__nv_bfloat16Pfiiiif":
            {"registers": 168, "spill_stores": 8, "spill_loads": 4},
        "_ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_iiiif":
            {"registers": 64, "spill_stores": 0, "spill_loads": 0}}


def test_sass_counts_counts_mnemonics_per_function():
    got = build.sass_counts(SASS, ("HGMMA", "HMMA"))
    assert got == {
        "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st":
            {"HGMMA": 2, "HMMA": 1},
        "_ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_iiiif":
            {"HGMMA": 0, "HMMA": 0}}


def _fake_flash_build(tensor_core_ops):
    """A stand-in for ``build`` whose flash library has the 24 kernels of
    ``csrc/flash.cu`` (names as nvcc mangles them in the file's anonymous
    namespace), the bf16 ones with ``tensor_core_ops`` HGMMA each."""
    import types
    funcs = []
    for kernel in ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                   "flash_dkv_wgmma_kernel", "flash_fwd_kernel",
                   "flash_dq_kernel", "flash_dkv_kernel"):
        for d in (16, 32, 64, 128):
            n = (tensor_core_ops if "wgmma" in kernel else 0)
            mangled = f"{len(kernel)}{kernel}ILi{d}EEEv"
            funcs.append((f"_ZN18flash_cu_53261552{mangled}", n))
    sass = "\n".join(
        f"\t\tFunction : {name}\n" + "".join(
            f"        /*{i:04x}*/    HGMMA.64x64x16.F32.BF16 R1 ;\n"
            for i in range(n)) + "        /*ff00*/    EXIT ;"
        for name, n in funcs)
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Used 168 registers" for name, _ in funcs)

    def smem_bytes(which, d):
        return 1000 * which + d

    def f32_smem_bytes(which, d):
        return 100_000 + 1000 * which + d

    lib = types.SimpleNamespace(flash_bf16_smem_bytes=smem_bytes,
                                flash_f32_smem_bytes=f32_smem_bytes)
    return types.SimpleNamespace(
        load=lambda name: lib, build_log=lambda name: log,
        sass=lambda name: sass, kernel_resources=build.kernel_resources,
        sass_counts=build.sass_counts)


def test_flash_build_report_requires_tensor_cores_in_bf16_kernels():
    """chip_smoke's build line: every flash kernel by name and head dim
    with its dynamic shared memory; a bf16 kernel without a tensor-core
    instruction fails the phase."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = smoke.flash_build_report(_fake_flash_build(2))
    assert len(rows) == 24
    assert rows["flash_dq_wgmma_kernel<64>"] == {
        "registers": 168, "HGMMA": 2, "HMMA": 0, "smem_bytes": 1064}
    assert rows["flash_dkv_kernel<128>"] == {
        "registers": 168, "HGMMA": 0, "HMMA": 0, "smem_bytes": 102_128}
    assert rows["flash_fwd_kernel<64>"]["smem_bytes"] == 100_064
    with pytest.raises(RuntimeError, match="no tensor-core instruction"):
        smoke.flash_build_report(_fake_flash_build(0))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _fake_profile(rows):
    """A stand-in for a torch.profiler window: ``events()`` lists each
    (name, device, start us, end us) row as a FunctionEvent would."""
    import types
    kinds = {"cuda": torch.autograd.DeviceType.CUDA,
             "cpu": torch.autograd.DeviceType.CPU}
    events = [types.SimpleNamespace(
        name=name, device_type=kinds[dev],
        time_range=types.SimpleNamespace(start=start, end=end))
        for name, dev, start, end in rows]
    return types.SimpleNamespace(events=lambda: events)


def test_busy_share_is_the_union_of_kernel_intervals():
    """Two streams' kernels overlap: the busy time is the union of the
    kernel intervals, not their sum; host records do not count."""
    smoke = _chip_smoke()
    prof = _fake_profile([
        ("void (anonymous namespace)::chol_step_kernel<false>(float const*, "
         "GpArgs, int, int, float*, float*)", "cuda", 0.0, 10.0),
        ("void (anonymous namespace)::chol_trailing_kernel<false>(float "
         "const*, GpArgs, int, int, float*)", "cuda", 5.0, 30.0),
        ("cudaLaunchKernel", "cpu", 0.0, 100.0),
        ("void (anonymous namespace)::chol_step_kernel<true>(float const*, "
         "GpArgs, int, int, float*, float*)", "cuda", 12.0, 20.0),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", "cuda",
         40.0, 44.0)])
    rows = smoke.kernel_intervals(torch, prof)
    assert [r[0] for r in rows] == ["chol_step_kernel", "chol_trailing_kernel",
                                    "chol_step_kernel",
                                    "vectorized_elementwise_kernel"]
    assert smoke.busy_union_ms(rows) == pytest.approx(0.034)
    assert sum(stop - start for _, start, stop in rows) / 1e3 \
        == pytest.approx(0.047)
    assert smoke.busy_union_ms([]) == 0.0


def test_kernel_breakdown_groups_launches_per_rep():
    smoke = _chip_smoke()
    rows = [("chol_step_kernel", 0.0, 10.0), ("chol_trailing_kernel", 5.0, 30.0),
            ("chol_step_kernel", 40.0, 44.0), ("chol_step_kernel", 50.0, 56.0),
            ("chol_trailing_kernel", 60.0, 61.0),
            ("chol_step_kernel", 70.0, 72.0)]
    got = smoke.kernel_breakdown(rows, reps=2)
    assert got["chol_step_kernel"] == {
        "ms": pytest.approx(0.011), "launches": 2.0, "median_us": 5.0,
        "min_us": 2.0, "max_us": 10.0}
    assert got["chol_trailing_kernel"] == {
        "ms": pytest.approx(0.013), "launches": 1.0, "median_us": 13.0,
        "min_us": 1.0, "max_us": 25.0}


def _fake_chol_build(kernels):
    """A stand-in for ``build`` whose cholesky library has ``kernels``,
    each in the plain (ILb0E) and the fused (ILb1E) instantiation, named
    as nvcc mangles them in the file's anonymous namespace."""
    import types
    names = [f"_ZN12_GLOBAL__N_1{len(k)}{k}ILb{b}EEEvPKfNS_6GpArgsEiiPf"
             for k in kernels for b in (0, 1)]
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {100 + i} registers, used 1 barriers"
        for i, name in enumerate(names))
    lib = types.SimpleNamespace(chol_smem_bytes=lambda which: 67000 + which)
    return types.SimpleNamespace(
        load=lambda name: lib, build_log=lambda name: log,
        kernel_resources=build.kernel_resources)


def test_chol_build_report_names_every_kernel():
    """chip_smoke's build line for cholesky.cu: each kernel, plain and
    fused, with registers, spills and its launch's dynamic shared memory;
    a missing or unknown kernel fails the phase."""
    smoke = _chip_smoke()
    rows = smoke.chol_build_report(_fake_chol_build(smoke.CHOL_KERNELS))
    assert sorted(rows) == ["chol_step_kernel<fused>", "chol_step_kernel<plain>",
                            "chol_trailing_kernel<fused>",
                            "chol_trailing_kernel<plain>"]
    assert rows["chol_trailing_kernel<fused>"] == {
        "registers": 103, "spill_stores": 0, "spill_loads": 0,
        "smem_bytes": 67001}
    with pytest.raises(RuntimeError, match="expected"):
        smoke.chol_build_report(_fake_chol_build(("chol_step_kernel",)))
    with pytest.raises(RuntimeError, match="unknown kernel chol_diag_kernel"):
        smoke.chol_build_report(_fake_chol_build(
            (*smoke.CHOL_KERNELS, "chol_diag_kernel")))


def _fake_stencil_solve_build(diffusion_kernels, trisolve_kernels):
    """A stand-in for ``build`` whose diffusion and trisolve libraries hold
    the given kernels, mangled as nvcc names them in each file's anonymous
    namespace."""
    import types
    logs = {}
    for source, kernels in (("diffusion", diffusion_kernels),
                            ("trisolve", trisolve_kernels)):
        logs[source] = "\n".join(
            f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            f"loads\nptxas info    : Used {40 + i} registers, used 1 barriers"
            for i, name in enumerate(kernels))
    return types.SimpleNamespace(build_log=lambda name: logs[name],
                                 kernel_resources=build.kernel_resources)


_DIFFUSION_MANGLED = [
    f"_ZN45_GLOBAL__N__945978c1_12_diffusion_cu_bdf1c8cd24diffuse_evaporate"
    f"_kernelILb{b}ELb{ring}EEEvPKfS2_S2_Pfiii"
    for b in (0, 1) for ring in (0, 1)]
_TRISOLVE_MANGLED = [
    "_ZN44_GLOBAL__N__d5c9e1b0_11_trisolve_cu_183ee35720trisolve_pack_kernel"
    "EPKfiiPf"] + [
    f"_ZN44_GLOBAL__N__d5c9e1b0_11_trisolve_cu_183ee35715trisolve_kernelILi"
    f"{w}EEEvPKfS2_iiiiPf" for w in (16, 64)]


def test_stencil_solve_build_report_names_every_kernel():
    """chip_smoke's build line for diffusion.cu and trisolve.cu: each
    instantiation with registers and spills; a missing or unknown kernel
    fails the phase."""
    smoke = _chip_smoke()
    rows = smoke.stencil_solve_build_report(_fake_stencil_solve_build(
        _DIFFUSION_MANGLED, _TRISOLVE_MANGLED))
    assert len(rows) == 7
    assert rows["diffuse_evaporate_kernel<bulk,ring>"] == {
        "registers": 43, "spill_stores": 0, "spill_loads": 0}
    assert rows["diffuse_evaporate_kernel<cp_async,one>"][
        "registers"] == 40
    assert rows["trisolve_kernel<64>"]["registers"] == 42
    assert "trisolve_pack_kernel" in rows
    with pytest.raises(RuntimeError, match="expected"):
        smoke.stencil_solve_build_report(_fake_stencil_solve_build(
            _DIFFUSION_MANGLED[:-1], _TRISOLVE_MANGLED))
    with pytest.raises(RuntimeError, match="unknown kernel"):
        smoke.stencil_solve_build_report(_fake_stencil_solve_build(
            _DIFFUSION_MANGLED, _TRISOLVE_MANGLED + [
                "_ZN44_GLOBAL__N__d5c9e1b0_11_trisolve_cu_183ee35715"
                "trisolve_diag_inv_kernelEPKfiPf"]))
