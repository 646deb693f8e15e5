"""The port's flash attention (B8, B9) and GQA layer on the CPU: the plain
versions in ``repro_torch.kernels.ref``, the routing in
``repro_torch.kernels.ops``, the autograd Function, and
``repro_torch.models.attention.gqa_apply``, against the JAX package: its
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them),
its jnp oracle and its own ``gqa_apply``. Inputs come from numpy with a
seed; weights are drawn by the reference's ``gqa_init`` and carried across
with ``gqa_params_from_arrays``.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import smollm_135m as jsmollm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention_bwd import (  # noqa: E402
    flash_attention_bwd as jflash_bwd, flash_attention_diff as jflash_diff,
    flash_attention_fwd as jflash_fwd)
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import smollm_135m  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402

# The reference's own tolerances between its Pallas kernel and its oracle
# (tests/test_kernels.py:30): f32 and bf16 outputs; 1e-5 for lse (:158),
# 2e-4 for gradients (:140).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, kh, s, d, seed, n=3):
    """q (B,H,S,D), k, v (B,KH,S,D) and, for n = 4, dO (B,H,S,D), f32."""
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, d), (b, kh, s, d), (b, kh, s, d), (b, h, s, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes[:n]]


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        TORCH_DTYPE[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(x, jnp.dtype(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the plain forward against the Pallas kernel (interpret) and the jnp oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,s,d", [
    (1, 2, 2, 64, 16),      # MHA
    (2, 4, 2, 128, 32),     # GQA group 2
    (1, 6, 1, 64, 64),      # MQA-ish
    (1, 8, 2, 256, 64),     # deeper blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_sweep(b, h, kh, s, d, dtype):
    """The reference sweep's shapes and tolerances (test_kernels.py:16-35);
    the port's CPU route through ops.flash_attention_gqa gives the same."""
    q, k, v = _inputs(b, h, kh, s, d, b * h + s)
    got = ref.flash_attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype))
    assert got.dtype == TORCH_DTYPE[dtype]
    kernel = jflash(_j(q, dtype), _j(k, dtype), _j(v, dtype), causal=True,
                    block_q=32, block_k=64, interpret=True)
    oracle = jref.flash_attention_ref(_j(q, dtype), _j(k, dtype),
                                      _j(v, dtype), causal=True)
    _close(got, kernel, TOL[dtype])
    _close(got, oracle, TOL[dtype])
    routed = ops.flash_attention_gqa(*(_t(x, dtype).transpose(1, 2)
                                       for x in (q, k, v)))
    assert torch.equal(routed.transpose(1, 2), got)


@pytest.mark.parametrize("s,block", [(64, 32), (100, 50)])
def test_flash_ref_noncausal_matches_jax(s, block):
    """Non-causal, also at a sequence that is no multiple of 64 (the CUDA
    kernels' tile), where key columns past S must not be seen."""
    q, k, v = _inputs(1, 2, 2, s, 16, 7)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=False)
    kernel = jflash(_j(q), _j(k), _j(v), causal=False, block_q=block,
                    block_k=block, interpret=True)
    _close(got, kernel, TOL["float32"])
    _close(got, jref.flash_attention_ref(_j(q), _j(k), _j(v), causal=False),
           TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_row_sums(causal):
    """Attention of v = ones returns ones (softmax normalization)."""
    q, k = _inputs(1, 2, 2, 64, 16, 3, n=2)
    out = ref.flash_attention_ref(_t(q), _t(k), torch.ones((1, 2, 64, 16)),
                                  causal=causal)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_ref_matches_jax(causal):
    """out and lse against the Pallas forward-with-logsumexp, 1e-5."""
    q, k, v = _inputs(1, 6, 3, 64, 16, 11)
    out, lse = ref.flash_attention_fwd_ref(_t(q), _t(k), _t(v),
                                           causal=causal)
    j_out, j_lse = jflash_fwd(_j(q), _j(k), _j(v), causal=causal,
                              block_q=32, block_k=32, interpret=True)
    assert lse.shape == (1, 6, 64) and lse.dtype == torch.float32
    _close(out, j_out, 1e-5)
    _close(lse, j_lse, 1e-5)


@pytest.mark.parametrize("b,h,kh,s,d,causal,dtype", [
    (1, 6, 3, 64, 16, True, "float32"),
    (2, 4, 2, 128, 32, False, "float32"),
    (1, 6, 3, 64, 16, True, "bfloat16"),
])
def test_flash_bwd_ref_matches_jax(b, h, kh, s, d, causal, dtype):
    """dq, dk_h, dv_h against the Pallas dQ and dK/dV kernels on the same
    out and lse (the reference's forward), dsum from the cast out on both
    sides: 2e-5 in f32 (one formula, two summation orders), 2e-2 in bf16."""
    q, k, v, do = (_j(x, dtype) for x in _inputs(b, h, kh, s, d, s + d, 4))
    j_out, j_lse = jflash_fwd(q, k, v, causal=causal, block_q=32,
                              block_k=32, interpret=True)
    want = jflash_bwd(q, k, v, j_out, j_lse, do, causal=causal, block_q=32,
                      block_k=32, interpret=True)
    got = ref.flash_attention_bwd_ref(
        *(_t(x, dtype) for x in (q, k, v, j_out)), _t(j_lse), _t(do, dtype),
        causal=causal)
    for g, w in zip(got, want):
        assert g.shape == (b, h, s, d) and g.dtype == TORCH_DTYPE[dtype]
        _close(g, w, TOL[dtype])


# ---------------------------------------------------------------------------
# the autograd Function against jax.grad of the custom_vjp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,s,d", [
    (1, 2, 2, 64, 16),
    (2, 4, 2, 128, 32),
    (1, 6, 3, 64, 16),
])
def test_flash_diff_grads_match_jax(b, h, kh, s, d):
    """ops.flash_attention_gqa_diff (model layout, CPU: the plain forward
    and backward inside the Function, GQA group-sum outside) against
    jax.grad of flash_attention_diff in interpret mode, loss
    sum(out * w) with a random w so that dO is not constant; 2e-4."""
    q, k, v, w = _inputs(b, h, kh, s, d, b * 7 + s, 4)

    def loss(q_, k_, v_):
        return (jflash_diff(q_, k_, v_, True, 32, 32, True) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).transpose(1, 2).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention_gqa_diff(*leaves, block_q=32, block_k=32)
    (out * _t(w).transpose(1, 2)).sum().backward()
    for leaf, g in zip(leaves, want):
        _close(leaf.grad.transpose(1, 2), g, 2e-4)


# ---------------------------------------------------------------------------
# the GQA layer against the reference's, weights carried across
# ---------------------------------------------------------------------------
def _gqa_case(cfg_name, dtype, allow_flash, b, s, seed=0):
    jcfg = getattr(jsmollm, cfg_name)
    cfg = getattr(smollm_135m, cfg_name)
    params, _ = jattention.gqa_init(jcfg, jax.random.key(seed),
                                    jnp.dtype(dtype))
    p = attention.gqa_params_from_arrays(
        cfg, {name: np.asarray(a) for name, a in params.items()},
        device="cpu")
    assert all(t.dtype == TORCH_DTYPE[dtype] for t in p.values())
    for name, a in params.items():
        np.testing.assert_array_equal(_np(p[name]), _np(a))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    mask = np.tril(np.ones((s, s), bool))
    want = jattention.gqa_apply(jcfg, params, _j(x, dtype), jnp.asarray(pos),
                                jnp.asarray(mask), allow_flash=allow_flash)
    with torch.no_grad():
        got = attention.gqa_apply(cfg, p, _t(x, dtype),
                                  torch.from_numpy(pos.copy()),
                                  torch.from_numpy(mask), allow_flash)
    assert got.shape == (b, s, cfg.d_model)
    assert got.dtype == TORCH_DTYPE[dtype]
    return got, want


# f32: two frameworks' summation orders (measured ~1e-6); bf16: the q/k/v
# and output projections round to bf16 on both sides, one bf16 ulp apart
# at most (|out| < 4: 1.6e-2).
GQA_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.mark.parametrize("allow_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_apply_matches_jax_reduced(dtype, allow_flash):
    """smollm-135m REDUCED (d 48, 3 heads on 1 kv head, head dim 16): the
    reference's flash branch runs its Pallas kernel in interpret mode."""
    got, want = _gqa_case("REDUCED", dtype, allow_flash, b=2, s=32)
    _close(got, want, GQA_TOL[dtype])


@pytest.mark.parametrize("allow_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_apply_matches_jax_full_width(dtype, allow_flash):
    """The slice as a whole at smollm-135m CONFIG's full width (d 576, 9
    heads on 3 kv heads, head dim 64) at a short sequence (B 1, S 128)."""
    got, want = _gqa_case("CONFIG", dtype, allow_flash, b=1, s=128)
    _close(got, want, GQA_TOL[dtype])


def test_gqa_module_holds_the_reference_layout():
    cfg = smollm_135m.REDUCED
    gen = torch.Generator().manual_seed(0)
    p = attention.gqa_init(cfg, gen, device="cpu")
    layer = attention.GQAttention(cfg, p)
    assert {n: tuple(t.shape) for n, t in layer.named_parameters()} == {
        "wq": (48, 3, 16), "wk": (48, 1, 16), "wv": (48, 1, 16),
        "wo": (3, 16, 48)}
    assert all(t.dtype == torch.bfloat16 for t in layer.parameters())
    x = torch.randn((2, 16, 48), generator=gen).to(torch.bfloat16)
    pos = torch.arange(16).expand(2, 16)
    mask = torch.ones((16, 16), dtype=torch.bool).tril()
    with torch.no_grad():
        assert torch.equal(layer(x, pos, mask, allow_flash=True),
                           attention.gqa_apply(cfg, p, x, pos, mask, True))
    # B8 has no backward: the flash branch refuses weights that need grad
    with pytest.raises(RuntimeError, match="flash_attention_gqa_diff"):
        layer(x, pos, mask, allow_flash=True)
    layer(x, pos, mask).float().sum().backward()     # _sdpa differentiates
    assert layer.wq.grad is not None
    with pytest.raises(ValueError, match="wq"):
        attention.gqa_params_from_arrays(
            cfg, {"wq": np.zeros((4, 3, 16), np.float32)}, device="cpu")


def test_gqa_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    cfg = smollm_135m.REDUCED
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.gqa_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.gqa_params_from_arrays(cfg, {})


def test_dense_init_is_a_truncated_normal_with_fan_in_scale():
    gen = torch.Generator().manual_seed(3)
    w = common.dense_init(gen, (64, 4, 32), torch.float32, device="cpu")
    scale = 1.0 / np.sqrt(64 * 4)
    assert w.shape == (64, 4, 32) and w.abs().max() <= 3 * scale
    # std of N(0, 1) truncated to [-3, 3] is 0.9866
    assert abs(w.std().item() / scale - 0.9866) < 0.05
    again = common.dense_init(torch.Generator().manual_seed(3), (64, 4, 32),
                              torch.float32, device="cpu")
    assert torch.equal(w, again)


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(14, dtype=np.int32).reshape(2, 7)
    for dtype in ("float32", "bfloat16"):
        tol = 1e-6 if dtype == "float32" else 1e-2
        _close(common.rms_norm(_t(x, dtype), _t(scale), 1e-5),
               jcommon.rms_norm(_j(x, dtype), _j(scale), 1e-5), tol)
        cos, sin = common.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
        jcos, jsin = jcommon.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
        _close(cos, jcos, 1e-6)
        _close(sin, jsin, 1e-6)
        _close(common.apply_rope(_t(x, dtype), cos, sin),
               jcommon.apply_rope(_j(x, dtype), jcos, jsin), tol)


def test_configs_are_copies_of_the_reference():
    for name in ("CONFIG", "REDUCED"):
        mine, theirs = getattr(smollm_135m, name), getattr(jsmollm, name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.resolved_head_dim == theirs.resolved_head_dim
    assert smollm_135m.CONFIG.dtype == "bfloat16"
    assert smollm_135m.CONFIG.use_flash_kernel
    assert [dataclasses.asdict(s) for s in base.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]


# ---------------------------------------------------------------------------
# routing, availability, and what the wrappers refuse
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_shape,kh,blocks,expect", [
    ((1, 64, 2, 16), 2, {}, True),
    ((4, 4096, 9, 64), 3, {}, True),         # smollm-135m at train_4k
    ((1, 128, 4, 128), 1, {}, True),
    ((1, 100, 2, 32), 2, {}, True),          # block min(512, 100)
    ((1, 1024, 2, 64), 2, {}, True),
    ((1, 1000, 2, 64), 2, {}, False),        # 1000 % 512
    ((1, 96, 2, 64), 2, {"block_q": 64}, False),
    ((1, 4, 2, 16), 2, {}, False),           # s < 8
    ((1, 64, 2, 12), 2, {}, False),          # d % 8
    ((1, 64, 2, 8), 2, {}, False),           # not a head dim the kernel takes
    ((1, 64, 2, 48), 2, {}, False),
    ((1, 64, 9, 64), 2, {}, False),          # h % kh
])
def test_flash_available(q_shape, kh, blocks, expect):
    b, s, h, d = q_shape
    q, k = torch.zeros(q_shape), torch.zeros((b, s, kh, d))
    assert ops.flash_available(q, k, **blocks) is expect


def test_flash_or_ref_decides_by_shape_before_any_launch():
    """On the CPU the shape gate decides, and either way the plain version
    runs; no kernel is launched."""
    ops.reset_kernel_launch_counts()
    for s in (64, 1000):            # available, and not (1000 % 512)
        q, k, v = (_t(x) for x in _inputs(1, 2, 1, s, 16, s))
        assert torch.equal(ops.flash_attention_or_ref(q, k, v),
                           ref.flash_attention_ref(q, k, v))
    q, k, v = (_t(x) for x in _inputs(1, 2, 1, 64, 8, 1))   # head dim 8
    assert torch.equal(ops.flash_attention_or_ref(q, k, v, causal=False),
                       ref.flash_attention_ref(q, k, v, causal=False))
    assert not any(ops.kernel_launch_counts().values())


@pytest.mark.parametrize("s,d,match", [(1000, 16, "multiple of block_q"),
                                       (64, 48, "CUDA")])
def test_flash_or_ref_off_the_cpu_never_takes_the_plain_version(s, d, match):
    """Off the CPU, as the reference on its own device, the shape gate is
    not consulted: a shape ``flash_available`` refuses goes to the kernel
    wrapper, which raises (tensors on the meta device stand in for the card
    here; the plain version would take them)."""
    q, k, v = (_t(x).to("meta") for x in _inputs(1, 2, 1, s, d, 5))
    assert not ops.flash_available(q.transpose(1, 2), k.transpose(1, 2))
    assert ref.flash_attention_ref(q, k, v).shape == q.shape
    ops.reset_kernel_launch_counts()
    with pytest.raises(ValueError, match=match):
        ops.flash_attention_or_ref(q, k, v)
    assert not any(ops.kernel_launch_counts().values())


def test_kernel_wrappers_raise_on_cpu_tensors():
    q, k, v, do = (_t(x) for x in _inputs(1, 2, 1, 64, 16, 0, 4))
    lse = dsum = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd.flash_attention_dq(q, k, v, do, lse, dsum)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd.flash_attention_dkv(q, k, v, do, lse, dsum)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd.flash_attention_bwd(q, k, v, q, lse, do)


def test_kernel_inputs_start_on_16_bytes():
    """The wrappers hand the kernels rows that start on 16-byte boundaries:
    a contiguous view 4 bytes off one is copied, an aligned tensor passes
    as it is."""
    flat = torch.arange(1 + 2 * 64 * 16, dtype=torch.float32)
    q = flat[1:].view(1, 2, 64, 16)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    got = flash.aligned(q)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, q)
    base = flat[:-1].view(1, 2, 64, 16)
    assert flash.aligned(base) is base
    assert flash.aligned(q.transpose(1, 2)).is_contiguous()


def test_b8_refuses_inputs_that_require_grad():
    """B8 has no vjp in the reference: under grad mode an input that
    requires grad raises, naming the differentiable variant; under
    no_grad the same call runs."""
    q, k, v = (_t(x).transpose(1, 2) for x in _inputs(1, 2, 1, 64, 16, 2))
    q.requires_grad_()
    for call in (lambda: ops.flash_attention_gqa(q, k, v),
                 lambda: ops.flash_attention_or_ref(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                 lambda: flash.flash_attention(q, k, v)):
        with pytest.raises(RuntimeError, match="flash_attention_gqa_diff"):
            call()
    with torch.no_grad():
        assert ops.flash_attention_gqa(q, k, v).shape == q.shape


def test_contract_raises_where_the_reference_asserts():
    q, k, v = (_t(x).transpose(1, 2) for x in _inputs(1, 6, 4, 64, 16, 4))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.flash_attention_gqa(q, k, v)
    q, k, v = (_t(x).transpose(1, 2) for x in _inputs(1, 2, 1, 96, 16, 4))
    with pytest.raises(ValueError, match="block_q"):
        ops.flash_attention_gqa(q, k, v, block_q=64)
    with pytest.raises(ValueError, match="block_k"):
        ops.flash_attention_gqa_diff(q, k, v, block_k=64)
    with pytest.raises(ValueError, match="B, KH, S, D"):
        ops.flash_attention_gqa(q, k[:, :32], v)
