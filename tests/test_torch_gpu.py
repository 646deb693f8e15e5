"""The port's CUDA kernels against their plain versions on the card, and the
calibration entry point on CUDA. Every test needs a CUDA device and skips
without one; this file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (cholesky, diffusion, dominance,  # noqa: E402
                                 flash_attention, flash_attention_bwd, gp,
                                 ops, ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("n,w", [(1, 8), (7, 33), (64, 72), (3, 120)])
def test_diffusion_kernel_bitwise(cuda, n, w):
    g = _gen(cuda, n * w)
    chem = torch.rand((n, w, w), generator=g, device=cuda) * 50
    rate = torch.rand((n,), generator=g, device=cuda)
    evap = torch.rand((n,), generator=g, device=cuda)
    got = diffusion.diffuse_evaporate(chem, rate, evap)
    assert torch.equal(got, ref.diffuse_evaporate_ref(chem, rate, evap))


def _diffusion_bitwise(cuda, n, w, offset=0):
    g = _gen(cuda, n * w + offset)
    base = torch.rand((n * w * w + offset,), generator=g, device=cuda) * 50
    chem = base[offset:].view(n, w, w)
    rate = torch.rand((n,), generator=g, device=cuda)
    evap = torch.rand((n,), generator=g, device=cuda)
    got = diffusion.diffuse_evaporate(chem, rate, evap)
    assert torch.equal(got, ref.diffuse_evaporate_ref(chem, rate, evap))
    return diffusion.route(chem)


# Lane counts just under and over one block per SM and one persistent wave
# at the paper's world (132 SMs x 3 blocks: 396 blocks), and the chunk's
# 20480 lanes.
@pytest.mark.parametrize("n", [1, 131, 133, 395, 397, 640, 20480])
def test_diffusion_kernel_bitwise_over_lane_counts(cuda, n):
    assert _diffusion_bitwise(cuda, n, 72) == "bulk"


# Both copy routes and both shapes of the kernel: w 33 and a field off a
# 16-byte boundary take cp.async; up to 139 a ring of two worlds beside a
# share buffer, from 140 one world (150, 171 and 238, the largest).
@pytest.mark.parametrize("n,w,offset,route", [
    (300, 8, 0, "bulk"), (300, 33, 0, "cp_async"), (20, 120, 0, "bulk"),
    (9, 139, 0, "cp_async"), (9, 150, 0, "bulk"), (5, 171, 0, "cp_async"),
    (140, 238, 0, "bulk"), (300, 72, 1, "cp_async"), (3, 1, 0, "cp_async"),
    (300, 2, 0, "bulk")])
def test_diffusion_kernel_bitwise_on_both_routes(cuda, n, w, offset, route):
    assert _diffusion_bitwise(cuda, n, w, offset) == route


# IEEE's special values beside small integers: -0 beside +0, NaN, +-inf,
# the +BIG of masked rows, the largest finite floats and denormals
_SPECIAL = (0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.0e30,
            3.4e38, -3.4e38, 1e-45, -1e-45)

# (Ni, Nj or None for the square sweep, M, values, groups, +BIG rows): every
# M of the unrolled kernels and the generic one (9); column counts around
# one word; groups sorted, unsorted, on one side only, and in ranges that
# straddle the 128-row tiles and 32-column words; +BIG rows first and
# scattered; the shapes of the GA ranking and of the streaming init's and
# the section 4.5 benchmark's sweeps
_DOM_CASES = {
    "1": (1, None, 3, "ints", None, None),
    "37": (37, None, 3, "ints", None, None),
    "100x33-grouped": (100, 33, 3, "ints", "unsorted", None),
    "256-grouped": (256, None, 3, "ints", "sorted", None),
    "333x70": (333, 70, 3, "ints", None, None),
    **{f"m{m}": (150, None, m, "ints", None, None) for m in range(1, 10)},
    "m9-special-grouped": (140, 90, 9, "special", "unsorted", None),
    **{f"nj{nj}": (200, nj, 3, "ints", None, None) for nj in (1, 31, 32, 33)},
    "40x300-m4": (40, 300, 4, "ints", None, None),
    "groups-rows-only": (130, 90, 3, "ints", "rows", None),
    "groups-cols-only": (130, 90, 3, "ints", "cols", None),
    "groups-straddle": (300, None, 3, "ints", "straddle", None),
    "groups-straddle-rect": (300, 290, 2, "ints", "straddle", None),
    "big-first": (320, None, 3, "ints", None, "first"),
    "big-scattered": (256, None, 3, "ints", None, "scattered"),
    "special": (300, None, 3, "special", None, None),
    "special-rect-m8": (129, 260, 8, "special", None, None),
    "special-grouped-m5": (200, None, 5, "special", "unsorted", "scattered"),
    "2048": (2048, None, 3, "ints", None, None),
    "2048-grouped": (2048, None, 3, "ints", "sorted", "scattered"),
    "8192": (8192, None, 3, "uniform", None, None),
    "8192-special": (8192, None, 3, "special", None, "scattered"),
    "50000x64": (50000, 64, 2, "ints", None, None),
}


def _dom_values(g, n, m, values, cuda):
    if values == "uniform":
        return torch.rand((n, m), generator=g, device=cuda)
    x = torch.randint(0, 4, (n, m), generator=g, device=cuda).float()
    if values == "special":
        special = torch.tensor(_SPECIAL, device=cuda)
        pick = torch.randint(0, len(_SPECIAL), (n, m), generator=g,
                             device=cuda)
        x = torch.where(torch.rand((n, m), generator=g, device=cuda) < 0.1,
                        special[pick], x)
    return x


def _dom_groups(g, n, kind, side, cuda):
    if kind == "sorted":
        return (torch.arange(n, device=cuda, dtype=torch.int32) * 8 // n)
    if kind == "unsorted" or kind == side:
        return torch.randint(-1, 3, (n,), generator=g, device=cuda,
                             dtype=torch.int32)
    if kind == "straddle":   # ranges of 50 / 45: across tiles and words
        return torch.arange(n, device=cuda, dtype=torch.int32) // (
            50 if side == "rows" else 45)
    return None


@pytest.mark.parametrize("case", list(_DOM_CASES))
def test_dominance_kernel_equal(cuda, case):
    """B2 (counts and bitmap) and, on every square ungrouped shape, B3
    equal to their plain versions."""
    ni, nj, m, values, groups, big = _DOM_CASES[case]
    g = _gen(cuda, ni * 31 + m)
    rows = _dom_values(g, ni, m, values, cuda)
    if big == "first":
        rows[:ni * 4 // 5] = 1.0e30
    elif big == "scattered":
        rows[torch.randperm(ni, generator=g, device=cuda)[:ni // 3]] = 1.0e30
    cols = None if nj is None else _dom_values(g, nj, m, values, cuda)
    gi = _dom_groups(g, ni, groups, "rows", cuda)
    gj = None if nj is None else _dom_groups(g, nj, groups, "cols", cuda)
    got = dominance.dominance_pass(rows, cols, gi, gj)
    expect = ref.dominance_pass_ref(rows, cols, gi, gj)
    assert torch.equal(got[0], expect[0]) and torch.equal(got[1], expect[1])
    if nj is None and groups is None:
        assert torch.equal(dominance.dominated_counts(rows),
                           ref.dominated_counts_ref(rows))


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    ops.reset_kernel_launch_counts()
    x = torch.zeros((4, 3), device=cuda)
    ops.dominance_pass(x)
    ops.dominated_counts(x)
    ops.diffuse_evaporate(torch.zeros((2, 8, 8), device=cuda),
                          torch.zeros(2, device=cuda),
                          torch.zeros(2, device=cuda))
    ops.gp_sqdist(torch.zeros((4, 2), device=cuda),
                  torch.zeros((3, 2), device=cuda))
    ops.gp_matrix(torch.zeros((4, 2), device=cuda),
                  torch.zeros((3, 2), device=cuda))
    ops.tri_solve(torch.eye(5, device=cuda), torch.zeros(5, device=cuda))
    ops.chol_factor(torch.eye(5, device=cuda), block=64)
    ops.gp_chol(torch.rand((5, 2), device=cuda), block=64)
    q = torch.rand((1, 8, 2, 16), device=cuda)
    ops.flash_attention_gqa(q, q, q)
    ops.flash_attention_gqa_diff(q.requires_grad_(), q, q).sum().backward()
    assert ops.kernel_launch_counts() == {
        "diffuse_evaporate": 1, "dominance_pass": 1, "dominated_counts": 1,
        "gp_sqdist": 1, "gp_matrix": 1, "tri_solve": 1,
        "tri_solve_backward": 0, "chol_blocked": 1,
        "gp_chol_blocked": 1, "flash_attention": 1, "flash_attention_fwd": 1,
        "flash_attention_dq": 1, "flash_attention_dkv": 1}


def test_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        diffusion.diffuse_evaporate(torch.zeros((2, 8, 8), device=cuda,
                                                dtype=torch.float64),
                                    torch.zeros(2, device=cuda),
                                    torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):
        dominance.dominance_pass(torch.zeros((4, 3), device=cuda),
                                 groups=torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="feature dim"):
        gp.gp_sqdist(torch.zeros((4, 33), device=cuda),
                     torch.zeros((3, 33), device=cuda))
    with pytest.raises(ValueError, match="multiples of 64"):
        cholesky.tri_solve_blocked(torch.eye(100, device=cuda),
                                   torch.zeros((100, 64), device=cuda))


@pytest.mark.parametrize("n1,n2,d,dup", [
    (1, 1, 1, 0), (37, 53, 2, 0), (80, 80, 2, 8), (255, 1031, 5, 0),
    (64, 300, 32, 0)])
def test_gp_kernel_bitwise(cuda, n1, n2, d, dup):
    """Distances, Matérn-5/2 and RBF: bitwise equal to the plain versions
    (same order of operations, no FMA, IEEE division/sqrt/exp)."""
    g = _gen(cuda, n1 * n2 + d)
    x1 = torch.rand((n1, d), generator=g, device=cuda)
    x1[1:1 + dup] = x1[0]
    x2 = x1 if n1 == n2 else torch.rand((n2, d), generator=g, device=cuda)
    assert torch.equal(gp.gp_sqdist(x1, x2), ref.gp_sqdist_ref(x1, x2))
    for kind in ("matern52", "rbf"):
        got = gp.gp_matrix(x1, x2, kind=kind, lengthscale=0.2, variance=1.5)
        expect = ref.gp_matrix_ref(x1, x2, kind=kind, lengthscale=0.2,
                                   variance=1.5)
        assert torch.equal(got, expect), kind


def _lower(n, g, dev):
    a = torch.randn((n, n), generator=g, device=dev)
    # cuSOLVER writes the factor column-major; the kernel takes rows
    return torch.linalg.cholesky(a @ a.T / n
                                 + torch.eye(n, device=dev)).contiguous()


# Kernel and plain version both substitute through explicit inverses of the
# diagonal tiles, but the kernel's tiles are 64 wide and the plain
# version's 256, and each sums its products in its own order: on these
# well-conditioned factors (A A^T / n + I) they agree to 1e-4 relative to
# max |X|, and each solves to a relative residual under 1e-5.
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("n,m", [(64, 64), (256, 320), (512, 1024)])
def test_tri_solve_kernel_matches_plain(cuda, trans, n, m):
    g = _gen(cuda, n + m)
    l = _lower(n, g, cuda)
    b = torch.randn((n, m), generator=g, device=cuda)
    got = cholesky.tri_solve_blocked(l, b, trans=trans)
    expect = ref.tri_solve_blocked_ref(l, b, trans=trans,
                                       block=min(n, 256))
    scale = expect.abs().max()
    assert ((got - expect).abs().max() / scale).item() < 1e-4
    lt = l.T if trans else l
    resid = torch.linalg.matrix_norm(lt @ got - b) / torch.linalg.matrix_norm(b)
    assert resid.item() < 1e-5


# The redesigned solve at the panel widths it chooses from (n_p 2048 keeps
# its whole panel only at 16 columns a strip, n_p 4096 only part of it)
# and the strip widths (m_p 64, 320 and 2048 take 16 columns, 50,176 the
# widest whose panel fits), against the same gates.
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m", [64, 320, 2048, 50176])
@pytest.mark.parametrize("n", [64, 512, 1024, 2048])
def test_tri_solve_kernel_matches_plain_over_strips(cuda, trans, n, m):
    g = _gen(cuda, 7 * n + m)
    l = _lower(n, g, cuda)
    b = torch.randn((n, m), generator=g, device=cuda)
    got = cholesky.tri_solve_blocked(l, b, trans=trans)
    expect = ref.tri_solve_blocked_ref(l, b, trans=trans,
                                       block=min(n, 256))
    scale = expect.abs().max()
    assert ((got - expect).abs().max() / scale).item() < 1e-4
    lt = l.T if trans else l
    resid = torch.linalg.matrix_norm(lt @ got - b) / torch.linalg.matrix_norm(b)
    assert resid.item() < 1e-5


@pytest.mark.parametrize("trans", [False, True])
def test_tri_solve_kernel_reads_back_what_the_panel_cannot_hold(cuda, trans):
    n, m = 4096, 128
    assert cholesky.solve_resident(n, cholesky.solve_strip(
        n, m, torch.cuda.get_device_properties(cuda).multi_processor_count)) \
        < n // 64
    g = _gen(cuda, 4096)
    l = _lower(n, g, cuda)
    b = torch.randn((n, m), generator=g, device=cuda)
    got = cholesky.tri_solve_blocked(l, b, trans=trans)
    expect = ref.tri_solve_blocked_ref(l, b, trans=trans, block=256)
    assert ((got - expect).abs().max() / expect.abs().max()).item() < 1e-4
    lt = l.T if trans else l
    resid = torch.linalg.matrix_norm(lt @ got - b) / torch.linalg.matrix_norm(b)
    assert resid.item() < 1e-5


def test_tri_solve_kernel_from_eight_threads_at_once(cuda):
    """Eight threads solve at once, each on a stream of its own (each call
    packs L into scratch of its own): each result equal to the solve of the
    same system alone."""
    import threading
    g = _gen(cuda, 21)
    systems = [(_lower(512, g, cuda), torch.randn((512, 2048), generator=g,
                                                  device=cuda), t % 2 == 1)
               for t in range(8)]
    alone = [cholesky.tri_solve_blocked(l, b, trans=tr)
             for l, b, tr in systems]
    torch.cuda.synchronize()
    got = [None] * 8
    start = threading.Barrier(8)

    def work(t):
        l, b, tr = systems[t]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[t] = cholesky.tri_solve_blocked(l, b, trans=tr)
        stream.synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(8):
        assert torch.equal(got[t], alone[t]), f"thread {t}"


def test_tri_solve_kernel_on_a_side_stream_is_ordered_there(cuda):
    """A solve on a non-default stream, its L and B written on that stream
    just before and its X consumed there at once, with no synchronize
    between: both launches run on the caller's stream."""
    g = _gen(cuda, 22)
    l = _lower(512, g, cuda)
    b = torch.randn((512, 50176), generator=g, device=cuda)
    expect = cholesky.tri_solve_blocked(l, b)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.default_stream())
    with torch.cuda.stream(stream):
        l2 = l.clone()
        b2 = b.clone()
        got = cholesky.tri_solve_blocked(l2, b2).clone()
        back = cholesky.tri_solve_blocked(l2, b2[:, :2048].contiguous(),
                                          trans=True)
        back_copy = back.clone()
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    assert torch.equal(back_copy, cholesky.tri_solve_blocked(
        l, b[:, :2048].contiguous(), trans=True))


def _spd(n, g, dev):
    a = torch.randn((n, n), generator=g, device=dev)
    return a @ a.T / n + torch.eye(n, device=dev)


# Kernel (64-wide tiles, right-looking) and plain version (block-wide tiles,
# left-looking, recursive tile factor) sum in other orders: the tolerance
# the reference's bench holds between two algorithms for one factor
# (benchmarks/run.py:593-595), and a relative residual under 1e-4.
# 1000 -> 1024: 16 steps, where each step kernel runs beside the trailing
# update of the step before; 4000 -> 4032: 63 steps, an odd tile count, so
# the 128-wide trailing blocks leave a 64-wide edge
@pytest.mark.parametrize("n,block", [(256, 64), (512, 256), (200, 64),
                                     (1000, 512), (4000, 64)])
def test_chol_kernel_matches_plain(cuda, n, block):
    g = _gen(cuda, n + block)
    a = _spd(n, g, cuda)
    n_p = -(-n // block) * block
    ap = torch.eye(n_p, device=cuda)
    ap[:n, :n] = a
    got = cholesky.chol_blocked(ap)
    expect = ref.chol_blocked_ref(ap, block=block)
    torch.testing.assert_close(got, expect, rtol=2e-4, atol=2e-4)
    assert torch.equal(got[n:, n:], torch.eye(n_p - n, device=cuda))
    assert not got[n:, :n].any() and not got.triu(1).any()
    l = got[:n, :n]
    resid = torch.linalg.matrix_norm(l @ l.T - a) / torch.linalg.matrix_norm(a)
    assert resid.item() < 1e-4


def test_chol_fast_paths_equal_the_intrinsics(cuda):
    """The factor's written-out square root and division give the bits of
    __fsqrt_rn and __fdiv_rn wherever they do not defer to them: every
    non-negative float, 2^26 random pairs."""
    got = cholesky.fast_path_check(cuda)
    assert got["sqrt_unequal"] == 0 and got["div_unequal"] == 0, got
    assert got["sqrt_fast"] + got["sqrt_slow"] == 2 ** 31
    assert got["div_fast"] + got["div_slow"] == 2 ** 26
    assert got["sqrt_fast"] > 1.8e9 and got["div_fast"] > 2 ** 24


@pytest.mark.parametrize("case", ["zero-row", "negative-pivot"])
def test_chol_kernel_guards_pivots_as_the_plain_version(cuda, case):
    """A zero pivot (a zero row and column in the second tile) or a
    negative one, as tests/test_torch_cholesky.py builds them on the CPU:
    no error, the same finite entries as the plain version, the guarded
    pivot sqrt(1e-30) = 1e-15, the rest within 2e-4."""
    a = _spd(128, _gen(cuda, 3), cuda)
    p = 70 if case == "zero-row" else 3
    a[p, :] = 0.0
    a[:, p] = 0.0
    if case == "negative-pivot":
        a[p, p] = -1.0
    got = cholesky.chol_blocked(a)
    expect = ref.chol_blocked_ref(a, block=64)
    assert torch.equal(torch.isfinite(got), torch.isfinite(expect))
    torch.testing.assert_close(got, expect, rtol=2e-4, atol=2e-4,
                               equal_nan=True)
    assert got[p, p].item() == torch.tensor(1e-15).item()


def test_chol_kernel_from_eight_threads_at_once(cuda):
    """Eight threads factor at once, each on a stream of its own (each call
    makes its own second stream and events): each result equal to the
    factor of the same matrix computed alone."""
    import threading
    mats = [_spd(640, _gen(cuda, 100 + t), cuda) for t in range(8)]
    alone = [cholesky.chol_blocked(m) for m in mats]
    torch.cuda.synchronize()
    got = [None] * 8
    start = threading.Barrier(8)

    def work(t):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[t] = cholesky.chol_blocked(mats[t])
        stream.synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(8):
        assert torch.equal(got[t], alone[t]), f"thread {t}"


def test_chol_kernel_on_a_side_stream_is_ordered_there(cuda):
    """A factor on a non-default stream, consumed on that stream at once,
    with no synchronize between: the caller's stream waits for all of the
    factor's work, so the copy sees the finished factor."""
    a = _spd(1024, _gen(cuda, 7), cuda)
    expect = cholesky.chol_blocked(a)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.default_stream())
    with torch.cuda.stream(stream):
        got = cholesky.chol_blocked(a).clone()
        fused = cholesky.gp_chol_blocked(
            torch.rand((1024, 8), generator=_gen(cuda, 8), device=cuda),
            1000, kind="rbf", lengthscale=0.3, nugget=1e-4).clone()
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    assert torch.isfinite(fused).all() and not fused.triu(1).any()


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("n,n_p,d", [(83, 128, 3), (200, 256, 8),
                                     (256, 256, 5)])
def test_gp_chol_kernel_is_chol_kernel_of_the_assembled_matrix(cuda, kind, n,
                                                               n_p, d):
    """The fused kernel assembles each covariance tile in B4's arithmetic
    order: bitwise the blocked kernel's factor of the plainly assembled K,
    and within 2e-4 of the fused plain version."""
    g = _gen(cuda, n * d)
    x = torch.zeros((n_p, d), device=cuda)
    x[:n] = torch.rand((n, d), generator=g, device=cuda)
    kw = dict(kind=kind, lengthscale=0.3, nugget=1e-4)
    got = cholesky.gp_chol_blocked(x, n, **kw)
    k = ref.gp_tile_ref(x, x, 0, 0, n, **kw)
    assert torch.equal(got, cholesky.chol_blocked(k))
    torch.testing.assert_close(
        got, ref.gp_chol_blocked_ref(x, n, block=64, **kw),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,block", [(200, 256), (600, 512), (256, 256)])
def test_ops_pad_to_64_on_the_card_changes_no_bit(cuda, n, block):
    """On the card ops pads to a multiple of 64, not of ``block``: the pad
    past it factors as identity, so [:n, :n] is the same bits."""
    g = _gen(cuda, n)
    a = _spd(n, g, cuda)
    n_p = -(-n // block) * block
    ap = torch.eye(n_p, device=cuda)
    ap[:n, :n] = a
    assert torch.equal(ops.chol_factor(a, block=block),
                       cholesky.chol_blocked(ap)[:n, :n])
    x = torch.zeros((n_p, 4), device=cuda)
    x[:n] = torch.rand((n, 4), generator=g, device=cuda)
    assert torch.equal(ops.gp_chol(x[:n], block=block),
                       cholesky.gp_chol_blocked(
                           x, n, kind="matern52", lengthscale=0.2,
                           nugget=1e-4)[:n, :n])


def test_chol_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="f32"):
        cholesky.chol_blocked(torch.eye(64, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cholesky.chol_blocked(torch.eye(128, device=cuda)[:, ::2][:64])
    with pytest.raises(ValueError, match="multiple of 64"):
        cholesky.chol_blocked(torch.eye(100, device=cuda))
    kw = dict(kind="matern52", lengthscale=0.2, nugget=1e-4)
    with pytest.raises(ValueError, match="f32"):
        cholesky.gp_chol_blocked(torch.zeros((64, 2), device=cuda,
                                             dtype=torch.float64), 64, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cholesky.gp_chol_blocked(torch.zeros((2, 64), device=cuda).T, 64,
                                 **kw)
    with pytest.raises(ValueError, match="multiple of 64"):
        cholesky.gp_chol_blocked(torch.zeros((100, 2), device=cuda), 100,
                                 **kw)
    with pytest.raises(ValueError, match="true size"):
        cholesky.gp_chol_blocked(torch.zeros((64, 2), device=cuda), 65, **kw)
    with pytest.raises(ValueError, match="kind"):
        cholesky.gp_chol_blocked(torch.zeros((64, 2), device=cuda), 64,
                                 **{**kw, "kind": "sqdist"})


# Flash attention (B8, B9): kernel and plain version sum in other orders
# (online softmax over 64- or 128-wide tiles against one softmax over the
# row); the
# reference's own tolerances: 2e-5 (f32) and 2e-2 (bf16) for the output
# (tests/test_kernels.py:30), 2e-4 for the gradients (:140), 1e-5 for lse.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _attention_inputs(dev, b, h, kh, s, d, dtype, seed):
    g = _gen(dev, seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d),
                          (b, h, s, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [8, 100, 192, 320, 512, 1, 127, 129, 384])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_kernels_match_plain(cuda, d, s, dtype, causal):
    """B8, B9's forward, dQ and dK/dV against their plain versions; 6 q
    heads on 2 kv heads (group 3: head h reads kv head h // 3, not h % 2);
    S 1, 8 and 100 are ragged to every tile; 192 and 320 are multiples of
    64 (the f32 tiles and dK/dV key blocks, the bf16 dK/dV kernel's q
    tiles) but not of 128 (the f32 forward's q rows at D <= 64, the bf16
    kernels' blocks); 127 and 129 fall one below and one above 128, and
    384 is a multiple of 128."""
    _check_flash_kernels(cuda, 2, 6, 2, s, d, dtype, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernels_match_plain_at_full_width(cuda, dtype):
    """The same checks at smollm-135m's attention: one sequence of 4096,
    9 q heads on 3 kv heads, head dim 64, causal, in both types."""
    _check_flash_kernels(cuda, 1, 9, 3, 4096, 64, dtype, True)


def test_flash_kernels_from_eight_threads_at_once(cuda):
    """Eight threads run the f32 forward and backward at once, each on a
    stream of its own: each result equal to the same call made alone."""
    import threading
    _no_tf32()
    problems = [_attention_inputs(cuda, 1, 6, 2, 100 + 50 * t, 64,
                                  torch.float32, 40 + t) for t in range(8)]

    def both(q, k, v, do):
        out, lse = flash_attention_bwd.flash_attention_fwd(q, k, v)
        return (flash_attention.flash_attention(q, k, v), out, lse,
                *flash_attention_bwd.flash_attention_bwd(q, k, v, out, lse,
                                                         do))

    alone = [both(*p) for p in problems]
    torch.cuda.synchronize()
    got = [None] * 8
    start = threading.Barrier(8)

    def work(t):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            start.wait()
            got[t] = both(*problems[t])
        stream.synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(8):
        for g_, w_ in zip(got[t], alone[t]):
            assert torch.equal(g_, w_), f"thread {t}"


def _check_flash_kernels(cuda, b, h, kh, s, d, dtype, causal):
    _no_tf32()
    q, k, v, do = _attention_inputs(cuda, b, h, kh, s, d, dtype, d * s)
    tol, grad_tol = FLASH_TOL[dtype], FLASH_GRAD_TOL[dtype]
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    _close(out, ref.flash_attention_ref(q, k, v, causal=causal), tol)
    out_fwd, lse = flash_attention_bwd.flash_attention_fwd(q, k, v,
                                                           causal=causal)
    assert torch.equal(out_fwd, out)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    _close(out_fwd, want_out, tol)
    _close(lse, want_lse, 1e-5)
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, lse, do,
                                                  causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    for g_, w_ in zip(got, want):
        _close(g_, w_, grad_tol)


@pytest.mark.parametrize("b,h,kh,s,d", [(1, 2, 2, 64, 16), (2, 4, 2, 128, 32),
                                        (1, 6, 3, 64, 16), (1, 9, 3, 200, 64)])
def test_flash_diff_matches_autograd_of_plain(cuda, b, h, kh, s, d):
    """The autograd Function's gradients (dQ and dK/dV kernels, GQA
    group-sum outside) against autograd through the plain version, with a
    non-constant dO; model layout in, as ops hands it over."""
    _no_tf32()
    q, k, v, w = _attention_inputs(cuda, b, h, kh, s, d, torch.float32, s)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    out = ops.flash_attention_gqa_diff(*leaves)
    (out * w.transpose(1, 2)).sum().backward()
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    (ref.flash_attention_ref(*plain) * w).sum().backward()
    for got, want in zip(leaves, plain):
        _close(got.grad.transpose(1, 2), want.grad, 2e-4)


def test_gqa_apply_flash_matches_sdpa_on_card(cuda):
    from repro_torch.configs.smollm_135m import CONFIG
    from repro_torch.models import attention
    p = attention.gqa_init(CONFIG, _gen(cuda), device=cuda)
    x = torch.randn((2, 256, CONFIG.d_model), generator=_gen(cuda, 1),
                    device=cuda).to(torch.bfloat16)
    pos = torch.arange(256, device=cuda).expand(2, 256)
    mask = torch.ones((256, 256), dtype=torch.bool, device=cuda).tril()
    ops.reset_kernel_launch_counts()
    with torch.no_grad():
        flash = attention.gqa_apply(CONFIG, p, x, pos, mask, allow_flash=True)
        assert ops.kernel_launch_counts()["flash_attention"] == 1
        plain = attention.gqa_apply(CONFIG, p, x, pos, mask)
    _close(flash, plain, 2e-2)


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 64, 16), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention(torch.zeros((1, 2, 64, 8),
                                                    device=cuda),
                                        torch.zeros((1, 2, 64, 8),
                                                    device=cuda),
                                        torch.zeros((1, 2, 64, 8),
                                                    device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple of block_q"):
        flash_attention.flash_attention(q, q, q, block_q=48)
    with pytest.raises(RuntimeError, match="flash_attention_gqa_diff"):
        flash_attention.flash_attention(q.requires_grad_(), q, q)


@pytest.mark.parametrize("s,d,match", [(1000, 16, "multiple of block_q"),
                                       (64, 48, "head dims")])
def test_flash_or_ref_on_the_card_launches_or_raises(cuda, s, d, match):
    """On the card ``flash_attention_or_ref`` never gives way to the plain
    version: a shape the kernel cannot take raises before any launch."""
    q, k, v, _ = _attention_inputs(cuda, 1, 2, 1, s, d, torch.float32, 3)
    ops.reset_kernel_launch_counts()
    with pytest.raises(ValueError, match=match):
        ops.flash_attention_or_ref(q, k, v)
    assert not any(ops.kernel_launch_counts().values())
    q, k, v, _ = _attention_inputs(cuda, 1, 2, 1, 64, 16, torch.float32, 3)
    ops.flash_attention_or_ref(q, k, v)
    assert ops.kernel_launch_counts()["flash_attention"] == 1


def test_calibrate_on_cuda_resumes_bitwise(cuda, tmp_path):
    from repro_torch.launch import explore
    flags = dict(reduced=True, n_islands=2, mu=8, lam=8, steps_per_epoch=1,
                 replicates=2, printer=lambda *_: None)
    straight, _ = explore.calibrate(out_dir=str(tmp_path / "a"), epochs=2,
                                    **flags)
    explore.calibrate(out_dir=str(tmp_path / "b"), epochs=1, **flags)
    resumed, _ = explore.calibrate(out_dir=str(tmp_path / "b"), epochs=2,
                                   **flags)
    for a, b in zip(straight.archive + straight.islands,
                    resumed.archive + resumed.islands):
        assert torch.equal(a, b)


def test_calibrate_surrogate_on_cuda_faults_and_resume_bitwise(cuda,
                                                               tmp_path):
    """The surrogate through the pool on the card: a 35 %-fault run and a
    resumed run give the clean run's history bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.launch import explore
    flags = dict(reduced=True, q=4, n_init=8, replicates=2,
                 printer=lambda *_: None)
    ops.reset_kernel_launch_counts()
    clean, _ = explore.calibrate_surrogate(out_dir=str(tmp_path / "a"),
                                           rounds=4, **flags)
    assert ops.kernel_launch_counts()["gp_sqdist"] >= 2
    faulty, _ = explore.calibrate_surrogate(out_dir=str(tmp_path / "b"),
                                            rounds=4, fault_rate=0.35,
                                            **flags)
    explore.calibrate_surrogate(out_dir=str(tmp_path / "c"), rounds=3,
                                **flags)
    resumed, _ = explore.calibrate_surrogate(out_dir=str(tmp_path / "c"),
                                             rounds=4, **flags)
    assert resumed.resumed_rounds == 3
    for other in (faulty, resumed):
        assert (other.genomes == clean.genomes).all()
        assert (other.objectives == clean.objectives).all()


def test_streaming_init_on_cuda_inline_equals_the_faulty_pool(cuda):
    """The streaming init at REDUCED on the card: inline, and through the
    3 x 2 pool at 35 % injected failures (six chunks on the card at once),
    give the same genomes and objectives bit for bit; every chunk ran the
    diffusion kernel once a tick."""
    from repro_torch.evolution import ga
    from repro_torch.launch import explore
    cfg = explore.NSGA2Config(mu=16, genome_dim=2, bounds=explore.BOUNDS)
    eval_fn = explore.ants_eval_fn(explore.REDUCED, 2)
    kw = dict(n_total=256, chunk=64, device=cuda)
    ops.reset_kernel_launch_counts()
    inline = ga.evaluate_population_streaming(cfg, eval_fn, 0, **kw)
    assert ops.kernel_launch_counts()["diffuse_evaporate"] == \
        4 * explore.REDUCED.max_ticks
    pool = explore.make_init_pool(0.35)
    try:
        pooled = ga.evaluate_population_streaming(cfg, eval_fn, 0,
                                                  environment=pool, **kw)
    finally:
        pool.shutdown()
    assert (inline.genomes == pooled.genomes).all()
    assert (inline.objectives == pooled.objectives).all()
    assert inline.objectives.shape == (256, 3)
    assert pooled.attempts >= pooled.chunks_total == 4
    top_g, top_o = ga.select_top_streaming(cfg, pooled.genomes,
                                           pooled.objectives, 16,
                                           device=cuda)
    assert top_g.device.type == "cuda" and top_o.shape == (16, 3)


def test_listing3_on_cuda_serial_async_and_cached_bitwise(cuda):
    """Paper Listing 3 through the port's DSL on the card, on REDUCED's
    world cut to 60 ticks with sources of radius 1 and 256 ants (the first
    source empties within the horizon): the model task builds its generator
    from its seed, so the serial, async and cached runs give the same five
    runs bit for bit, and the cached run launches no diffusion kernel."""
    import dataclasses

    from repro_torch.ants import simulate
    from repro_torch.configs.ants_netlogo import REDUCED
    from repro_torch.core import (Capsule, PyTask, TaskCache, TorchTask, Val,
                                  aggregate, explore, puzzle)
    from repro_torch.explore import SeedSampling, StatisticTask, median
    from repro_torch.runtime.device import make_generator
    seed, food, med = Val("seed", int), Val("food1", float), Val("med1",
                                                                   float)

    cfg = dataclasses.replace(REDUCED, max_ticks=60, food_radius=1.0,
                              population=256)

    def ants_fn(seed):
        return simulate(cfg, 50.0, 10.0, device=cuda,
                        generator=make_generator(int(seed), cuda))[0]

    def run(**kw):
        model = Capsule(TorchTask("ants", ants_fn, inputs=(seed,),
                                  outputs=(food,)))
        stat = Capsule(StatisticTask("stat", [(food, med, median)]))
        res = (puzzle(Capsule(PyTask("head", lambda ctx: {})))
               >> explore(SeedSampling(seed, 5, seed=7)) >> model
               >> aggregate() >> stat).run(**kw)
        return res[stat][0]

    cache = TaskCache()
    ops.reset_kernel_launch_counts()
    serial = run(scheduler="serial")
    assert ops.kernel_launch_counts()["diffuse_evaporate"] == \
        5 * cfg.max_ticks
    runs = [serial, run(scheduler="async"), run(cache=cache)]
    ops.reset_kernel_launch_counts()
    runs.append(run(cache=cache))
    assert ops.kernel_launch_counts()["diffuse_evaporate"] == 0
    for r in runs:
        assert r["food1"].device.type == "cuda"
        assert torch.equal(r["food1"], serial["food1"])
        assert torch.equal(r["med1"], serial["med1"])
    # a tensor input reaches the task's function on the task's device
    where = TorchTask("where", lambda x: x.device.type, inputs=(Val("x"),),
                      outputs=(Val("d"),))
    assert where.run({"x": torch.ones(2)})["d"] == "cuda"


# ---------------------------------------------------------------------------
# several ranks on the card: two gloo processes on cuda:0
# ---------------------------------------------------------------------------
RANK_PREAMBLE = """
import datetime, functools, sys
import torch
import torch.distributed as dist
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.launch import mesh as tmesh
mesh = tmesh.make_island_mesh(data=world, device="cuda")
"""


def _card_ranks(script, tmp_path, world=2, timeout=300.0):
    """``script`` as ``world`` gloo ranks on the card; -> their saved
    results. A rank that fails or overruns fails the test."""
    import os
    import subprocess
    import sys
    import textwrap
    import time
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    code = RANK_PREAMBLE + textwrap.dedent(script)
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=root) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_sharded_dominance_pass_two_ranks_on_the_card(cuda, tmp_path):
    got = _card_ranks("""
        from repro_torch.evolution import nsga2
        from repro_torch.kernels import ops
        from repro_torch.runtime import sharding
        sweep = functools.partial(sharding.sharded_dominance_pass, mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(4)
        res = []
        for n, groups in ((997, 3), (320, 0), (2048, 0)):
            f = torch.randint(0, 1001, (n, 3), generator=gen,
                              device="cuda").to(torch.float32)
            g = (torch.arange(n, device="cuda", dtype=torch.int32) % groups
                 if groups else None)
            ops.reset_kernel_launch_counts()
            counts, block = sweep(f, groups=g)
            launches = ops.kernel_launch_counts()["dominance_pass"]
            one_c, one_b = ops.dominance_pass(f, groups=g)
            rows = one_b[block.row0:block.row0 + len(block.words)]
            res.append(dict(
                counts=torch.equal(counts, one_c),
                rows=torch.equal(block.words, rows), launches=launches,
                ranks=torch.equal(nsga2.nondominated_ranks(
                    f, groups=g, pass_fn=sweep),
                    nsga2.nondominated_ranks(f, groups=g))))
        torch.save(res, f"{out}/rank{rank}.pt")
    """, tmp_path)
    for res in got:
        for x in res:
            assert x == dict(counts=True, rows=True, launches=1, ranks=True)


def test_two_rank_island_run_on_the_card_equals_one_rank(cuda, tmp_path):
    run = """
        import dataclasses
        from repro_torch.configs.ants_netlogo import REDUCED
        from repro_torch.evolution import island, nsga2
        from repro_torch.launch import explore

        def run(mesh=None, **kw):
            cfg = nsga2.NSGA2Config(mu=8, genome_dim=2,
                                    bounds=((0.0, 99.0), (0.0, 99.0)))
            gen = torch.Generator(device="cuda").manual_seed(0)
            ants = dataclasses.replace(REDUCED, max_ticks=100)
            return island.run_islands(
                cfg, explore.ants_eval_fn(ants, 2), gen, n_islands=4, lam=8,
                steps_per_epoch=2, epochs=2, archive_size=32, merge_top_k=4,
                device="cuda", mesh=mesh, **kw)
    """
    got = _card_ranks(run + """
        res = [run(mesh), run(mesh, pipeline=True)]
        torch.save([[t.cpu() for t in list(s.islands) + list(s.archive)]
                    for s in res], f"{out}/rank{rank}.pt")
    """, tmp_path)
    ns = {"torch": torch}
    import textwrap
    exec(textwrap.dedent(run), ns)
    want = [ns["run"](), ns["run"](pipeline=True)]
    for res in got:
        for tensors, state in zip(res, want):
            for a, b in zip(tensors, list(state.islands) + list(state.archive)):
                assert torch.equal(a, b.cpu())


def test_device_environment_pins_attempts_on_the_card(cuda):
    from repro_torch.core import (Context, PyTask, TorchTask, Val,
                                  make_device_members)
    (member,) = make_device_members(None, 1)
    assert member.devices == (torch.device("cuda", 0),)
    probe = PyTask("probe", lambda ctx: {
        "dev": torch.cuda.current_device(),
        "made": torch.ones(1, device="cuda").device.index},
        outputs=(Val("dev", int), Val("made", int)))
    assert member.submit(probe, Context()) == {"dev": 0, "made": 0}
    lane = TorchTask("lane", lambda x: x * 2, inputs=(Val("x"),),
                     outputs=(Val("y"),))
    outs = member.map_explore(lane, [Context(x=torch.ones(2))] * 4)
    assert member.last_lane_devices == (torch.device("cuda", 0),)
    assert all(o["y"].device == torch.device("cuda", 0) for o in outs)


# The qEHVI box sweeps: box samples (rows) against the current front
# (columns), whose empty slots are +BIG rows; hv_estimate's 4096 samples
# against a front of any size.
@pytest.mark.parametrize("ni,nj,n_big", [(128, 64, 24), (128, 64, 0),
                                         (4096, 64, 16), (4096, 37, 0),
                                         (4096, 1, 0)])
def test_dominance_kernel_at_the_box_sweep_shapes(cuda, ni, nj, n_big):
    g = _gen(cuda, ni + nj)
    u = torch.rand((ni, 3), generator=g, device=cuda) * 2.0 - 1.0
    front = torch.randn((nj, 3), generator=g, device=cuda) * 0.5
    front[nj - n_big:] = 1.0e30
    got = ops.dominance_pass(u, front)
    expect = ref.dominance_pass_ref(u, front)
    assert torch.equal(got[0], expect[0]) and torch.equal(got[1], expect[1])
    assert int((got[0] > 0).sum()) > 0


def test_run_surrogate_mo_on_cuda_equals_the_cpu_run(cuda):
    """run_surrogate_mo at REDUCED (1 replicate; 2 Sobol rounds and 1 qEHVI
    round of 4) on the card against the same run on the CPU, each
    evaluation's Gumbel noise drawn on the host from its (seed, round,
    slot) generator's seed: the Sobol rounds' ticks equal; in the qEHVI
    round the card's pick equals the CPU's wherever the CPU's gain leads
    the next slot's by more than 4 / (mc_samples x hv_samples), the
    tolerance of a few flipped sample-cell comparisons."""
    import numpy as np

    from repro_torch.ants import model
    from repro_torch.explore import moacq
    from repro_torch.launch import explore
    cfg = moacq.MOSurrogateConfig(bounds=explore.BOUNDS, q=4, n_init=8,
                                  seed=0)
    red = explore.REDUCED

    def eval_fn(gen, genomes):
        host = torch.Generator().manual_seed(gen.initial_seed())
        noise = model.draw_gumbel(
            host, (red.max_ticks, len(genomes), red.population, 8), "cpu")
        return model.simulate_batch(red, genomes[:, 0], genomes[:, 1],
                                    noise=noise.to(genomes.device))

    runs = {w: moacq.run_surrogate_mo(cfg, eval_fn, rounds=3, device=w)
            for w in ("cpu", cuda)}
    cpu, card = runs["cpu"], runs[cuda]
    assert np.array_equal(card.genomes[:8], cpu.genomes[:8])
    assert np.array_equal(card.objectives[:8], cpu.objectives[:8])
    assert (cpu.objectives < red.max_ticks).any()     # objectives vary
    ex = moacq.MOSurrogateExplorer(cfg, device="cpu")
    ex.load_state_arrays({"x01": (cpu.genomes[:8] - ex._lo) / ex._span,
                          "y": cpu.objectives[:8], "round": np.int32(2)})
    batch = ex.ask()
    np.testing.assert_array_equal(batch, cpu.genomes[8:])
    tol = 4.0 / (cfg.mc_samples * cfg.hv_samples)
    gains = ex.last_gains
    for s in range(cfg.q):
        if s == cfg.q - 1 or gains[s] - gains[s + 1] > tol:
            np.testing.assert_allclose(card.genomes[8 + s],
                                       cpu.genomes[8 + s], rtol=1e-6)
    assert np.isfinite(card.hv) and card.hv > 0


# ---------------------------------------------------------------------------
# LM serving (launch.serve): every arch at REDUCED, card against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [
    "minicpm-2b", "phi3-medium-14b", "smollm-135m", "granite-3-2b",
    "mamba2-2.7b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
    "jamba-1.5-large-398b", "chameleon-34b", "whisper-base"])
def test_serve_reduced_card_matches_cpu(cuda, arch):
    """serve_once on the card launches none of the port's kernels (serving
    runs ``_sdpa``, as the reference); the served tokens teacher-forced on
    the card and, with the same weights, on the CPU give logits within
    2e-4, and the tokens are the CPU's argmax wherever its top-2 margin
    exceeds that (each row up to its first step at or under it)."""
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.common import tree_map
    from repro_torch.serve import teacher_forced_logits
    tol = 2e-4
    _no_tf32()
    ops.reset_kernel_launch_counts()
    tokens, _ = serve.serve_once(arch, device="cuda", printer=lambda *a: None)
    assert not any(ops.kernel_launch_counts().values())
    model, params, prompts, frames, _ = serve.setup(arch, device=cuda)
    toks = torch.as_tensor(tokens)
    card = teacher_forced_logits(model, params, prompts, toks.to(cuda),
                                 frames=frames).cpu()
    cpu = teacher_forced_logits(
        build(model.cfg, "cpu"), tree_map(lambda t: t.cpu(), params),
        prompts.cpu(), toks, frames=None if frames is None else frames.cpu())
    torch.testing.assert_close(card, cpu, atol=tol, rtol=tol)
    top2 = cpu.topk(2, dim=-1).values
    margin, argmax = top2[..., 0] - top2[..., 1], cpu.argmax(-1)
    for r in range(toks.shape[0]):
        for t in range(toks.shape[1]):
            if margin[t, r] <= tol:
                break
            assert int(argmax[t, r]) == int(toks[r, t]), (r, t)


# ---------------------------------------------------------------------------
# LM training (launch.train) and bandit-routed serving (serve.bandit)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [
    "minicpm-2b", "phi3-medium-14b", "smollm-135m", "granite-3-2b",
    "mamba2-2.7b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
    "jamba-1.5-large-398b", "chameleon-34b", "whisper-base"])
def test_train_step_reduced_card_matches_cpu(cuda, arch):
    """One two-microbatch train step at REDUCED (f32, TF32 off) on the card
    and on the CPU from the same weights: no kernel of the port launched
    (training runs ``_sdpa``, as the reference); loss within 1e-5 and the
    grad norm within 1e-4 relative; each stepped weight within 0.25 * lr
    (Adam's first step moves a weight by about lr * g / (|g| + eps), so a
    gradient at rounding level can move it by a fraction of lr either
    way)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.train import batch_at
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, TrainState,
                                   init_opt_state, make_train_step)
    _no_tf32()
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    oc = OptimizerConfig(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    stream = TokenStream(DataConfig(cfg.vocab_size, 16, 4))
    params, _ = build(cfg, cuda).init(_gen(cuda))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        state = TrainState(p, init_opt_state(p),
                           torch.Generator().manual_seed(0).get_state())
        ops.reset_kernel_launch_counts()
        out[dev.type] = make_train_step(build(cfg, dev), oc, 2)(
            state, batch_at(cfg, stream, 0, 4, dev))
        assert not any(ops.kernel_launch_counts().values())
    (card, mc), (cpu, mh) = out["cuda"], out["cpu"]
    assert abs(float(mc["loss"]) - float(mh["loss"])) \
        <= 1e-5 * abs(float(mh["loss"]))
    assert abs(float(mc["grad_norm"]) - float(mh["grad_norm"])) \
        <= 1e-4 * float(mh["grad_norm"])
    lr = float(mh["lr"])
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= 0.25 * lr


def test_bandit_request_on_the_card_launches_gp_sqdist_only(cuda):
    """Three routed requests at REDUCED on the card, then a surrogate sync:
    the requests launch no kernel of the port (the arms run ``_sdpa``), the
    sync's GP fit launches ``gp_sqdist`` once, bitwise equal to its plain
    version at the fit's shape; the greedy arm's tokens equal the CPU's on
    the same weights wherever the CPU's top-2 margin exceeds 2e-4."""
    import numpy as np
    from repro_torch.explore import SurrogateConfig, SurrogateExplorer
    from repro_torch.launch import bandit_serve
    from repro_torch.models import build
    from repro_torch.models.common import tree_map
    from repro_torch.serve import bandit, teacher_forced_logits
    _no_tf32()
    cfg, arms, spawn = bandit_serve.make_arm_set(
        "smollm-135m", reduced=True, new_tokens=6, device=cuda)
    router = bandit.BanditRouter(arms, bandit.BanditConfig(lat_weight=0.0),
                                 spawn_fn=spawn)
    explorer = SurrogateExplorer(SurrogateConfig(
        bounds=bandit.ARM_BOUNDS, q=1, n_init=2, seed=0, lengthscales=(0.2,),
        n_starts=6, opt_steps=12, mc_samples=32), device=cuda)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ops.reset_kernel_launch_counts()
    results = [router.route(prompts) for _ in range(3)]
    assert not any(ops.kernel_launch_counts().values())
    assert router.sync_surrogate(explorer) is not None
    counts = ops.kernel_launch_counts()
    assert counts.pop("gp_sqdist") == 1 and not any(counts.values())
    x = torch.as_tensor(explorer.x01, device=cuda)
    assert torch.equal(ops.gp_sqdist(x, x), ref.gp_sqdist_ref(x, x))
    greedy = results[0]
    assert greedy.arm == arms[0].name
    # make_arm_set's weights: a generator seeded 0 on the card
    params, _ = build(cfg, cuda).init(_gen(cuda))
    toks = torch.as_tensor(greedy.tokens).long()
    cpu = teacher_forced_logits(build(cfg, "cpu"),
                                tree_map(lambda t: t.cpu(), params),
                                torch.as_tensor(prompts).long(), toks)
    top2 = cpu.topk(2, dim=-1).values
    margin, argmax = top2[..., 0] - top2[..., 1], cpu.argmax(-1)
    for r in range(toks.shape[0]):
        for t in range(toks.shape[1]):
            if margin[t, r] <= 2e-4:
                break
            assert int(argmax[t, r]) == int(toks[r, t]), (r, t)


# ---------------------------------------------------------------------------
# B1 and B2 as torch.library custom ops; packaged tasks on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 320, 640])
def test_diffusion_custom_op_is_the_launcher_bitwise(cuda, n):
    from repro_torch.kernels import library
    g = _gen(cuda, n)
    chem = torch.rand((n, 72, 72), generator=g, device=cuda) * 50
    rate = torch.rand((n,), generator=g, device=cuda)
    evap = torch.rand((n,), generator=g, device=cuda)
    ops.reset_kernel_launch_counts()
    got = library.diffuse_evaporate(chem, rate, evap)
    routed = ops.diffuse_evaporate(chem, rate, evap)
    assert ops.kernel_launch_counts()["diffuse_evaporate"] == 2
    want = diffusion.diffuse_evaporate(chem, rate, evap)
    assert torch.equal(got, want) and torch.equal(routed, want)


@pytest.mark.parametrize("ni,nj,grouped", [(256, None, True), (64, None, True),
                                           (2048, None, False),
                                           (160, 320, False)])
def test_dominance_custom_op_is_the_launcher(cuda, ni, nj, grouped):
    from repro_torch.kernels import library
    g = _gen(cuda, ni)
    rows = torch.randint(0, 1001, (ni, 3), generator=g,
                         device=cuda).to(torch.float32)
    cols = None if nj is None else torch.randint(
        0, 1001, (nj, 3), generator=g, device=cuda).to(torch.float32)
    groups = (torch.arange(ni, device=cuda, dtype=torch.int32) % 8
              if grouped else None)
    ops.reset_kernel_launch_counts()
    got = library.dominance_pass(rows, cols, groups, None)
    routed = ops.dominance_pass(rows, cols, groups)
    assert ops.kernel_launch_counts()["dominance_pass"] == 2
    want = dominance.dominance_pass(rows, cols, groups, None)
    for a, b, c in zip(got, routed, want):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_packaged_tasks_rehydrate_on_the_card(cuda, tmp_path):
    import dataclasses

    from repro_torch.ants import model, simulate_state
    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.core import packaging
    cfg = dataclasses.replace(CONFIG, max_ticks=30)

    def ants_apply(d, e, noise):
        state = simulate_state(cfg, d, e, noise=noise)
        return state.ticks_empty.to(torch.float32), state.chem

    g = _gen(cuda, 26)
    n = 640
    ants_args = (torch.rand((n,), generator=g, device=cuda) * 99,
                 torch.rand((n,), generator=g, device=cuda) * 99,
                 model.draw_gumbel(g, (cfg.max_ticks, n, cfg.population, 8),
                                   cuda))
    objectives = torch.randint(0, 1001, (2048, 3), generator=g,
                               device=cuda).to(torch.float32)
    for name, fn, args, kernel, expect in (
            ("ants", ants_apply, ants_args, "diffuse_evaporate",
             cfg.max_ticks),
            ("dominance", lambda x: ops.dominance_pass(x), (objectives,),
             "dominance_pass", 1)):
        path = packaging.package(fn, args, str(tmp_path / name), name=name)
        assert packaging.manifest(path)["device"] == "cuda"
        run = packaging.load(path)
        ops.reset_kernel_launch_counts()
        got = run(*args)
        counts = ops.kernel_launch_counts()
        assert counts[kernel] == expect and sum(counts.values()) == expect
        want = fn(*args)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert want[1].shape == (2048, 64)
