"""The port's CUDA kernels against their plain versions on the card, and the
calibration entry point on CUDA. Every test needs a CUDA device and skips
without one; this file imports neither JAX nor the JAX package, so it runs
on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import diffusion, dominance, ops, ref  # noqa: E402

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


@pytest.mark.parametrize("ni,nj,grouped", [
    (1, None, False), (37, None, False), (100, 33, True), (256, None, True),
    (333, 70, False)])
def test_dominance_kernel_equal(cuda, ni, nj, grouped):
    g = _gen(cuda, ni)
    rows = torch.randint(0, 6, (ni, 3), generator=g, device=cuda).float()
    cols = None if nj is None else torch.randint(
        0, 6, (nj, 3), generator=g, device=cuda).float()
    n_cols = ni if nj is None else nj
    gi = torch.randint(0, 3, (ni,), generator=g, device=cuda,
                       dtype=torch.int32) if grouped else None
    gj = torch.randint(0, 3, (n_cols,), generator=g, device=cuda,
                       dtype=torch.int32) if grouped and nj else None
    got = dominance.dominance_pass(rows, cols, gi, gj)
    expect = ref.dominance_pass_ref(rows, cols, gi, gj)
    assert torch.equal(got[0], expect[0]) and torch.equal(got[1], expect[1])
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
    assert ops.kernel_launch_counts() == {
        "diffuse_evaporate": 1, "dominance_pass": 1, "dominated_counts": 1}


def test_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        diffusion.diffuse_evaporate(torch.zeros((2, 8, 8), device=cuda,
                                                dtype=torch.float64),
                                    torch.zeros(2, device=cuda),
                                    torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):
        dominance.dominance_pass(torch.zeros((4, 3), device=cuda),
                                 groups=torch.zeros(4, device=cuda))


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
