"""The port's LM zoo (``repro_torch.models``) on the CPU against the JAX
package, module by module and arch by arch, at REDUCED sizes in f32.

Inputs come from numpy with a seed; weights are drawn by the reference's
own init functions and carried across with ``common.carry`` /
``model.params_from_arrays``. The tolerance is 2e-4 (atol and rtol), the
reference's own decode-against-prefill tolerance (tests/test_models.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import attention, common, mlp, moe, ssm  # noqa: E402
from repro_torch.models.model import Model, params_from_arrays  # noqa: E402

TOL = 2e-4
F32 = torch.float32


def _cfgs(arch, **kw):
    """(reference config, port config) at REDUCED, f32, serving's flags."""
    kw = dict(dtype="float32", use_flash_kernel=False, **kw)
    return (dataclasses.replace(jget_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _flat(tree, prefix=""):
    """Nested dicts -> {path: leaf}, for comparing trees of both packages."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _trees_close(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(_np(g[path]), _np(w[path]), atol=tol,
                                   rtol=tol, err_msg=path)


def _carry(port_init, ref_pair):
    """The reference's (params, axes) of one module -> the port's params,
    checked against the port's own init drawn on the meta device."""
    expected, axes = port_init("meta")
    assert axes == ref_pair[1]
    return common.carry(expected, jax.tree.map(np.asarray, ref_pair[0]),
                        device="cpu")


def _jit(fn):
    """A reference function jitted with its config static: one compile a
    shape instead of one an op."""
    return jax.jit(fn, static_argnums=0)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------
def test_norms_positions_and_activations():
    rng = np.random.default_rng(0)
    x = _randn(rng, 3, 5, 64, scale=3.0)
    p = {"scale": _randn(rng, 64), "bias": _randn(rng, 64)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(common.layer_norm(torch.from_numpy(x), tp, 1e-5),
           jcommon.layer_norm(jnp.asarray(x), p, 1e-5))
    for arch in ("whisper-base", "smollm-135m"):        # layernorm, rmsnorm
        jcfg, cfg = _cfgs(arch)
        scale = tp if cfg.norm == "layernorm" else tp["scale"]
        jscale = p if cfg.norm == "layernorm" else p["scale"]
        _close(common.apply_norm(cfg, torch.from_numpy(x), scale),
               jcommon.apply_norm(jcfg, jnp.asarray(x), jscale))
    # at whisper's 1500 frames an angle is ~1.5e3 rad, where one f32 ulp
    # of exp's result moves it (and its sine) by ~1e-4
    for seq, dim in ((24, 64), (1500, 512), (7, 2)):
        _close(common.sinusoidal_positions(seq, dim, "cpu"),
               jcommon.sinusoidal_positions(seq, dim))
    for name in ("silu", "gelu"):
        _close(common.activation(name)(torch.from_numpy(x)),
               jcommon.activation(name)(jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------------------------
# feed-forwards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base"])
def test_mlp_apply(arch):
    """SwiGLU (smollm) and the tanh-approximate GELU MLP (whisper)."""
    jcfg, cfg = _cfgs(arch)
    ref_pair = jmlp.mlp_init(jcfg, jax.random.key(1), jnp.float32)
    p = _carry(lambda dev: mlp.mlp_init(cfg, None, F32, device=dev),
               ref_pair)
    x = _randn(np.random.default_rng(1), 2, 9, cfg.d_model)
    _close(mlp.mlp_apply(cfg, p, torch.from_numpy(x)),
           _jit(jmlp.mlp_apply)(jcfg, ref_pair[0], jnp.asarray(x)))


@pytest.mark.parametrize("arch,capacity_factor,b,s", [
    ("granite-moe-1b-a400m", 0.5, 2, 16),    # drops
    ("granite-moe-1b-a400m", 1.25, 3, 16),   # the config's factor
    ("deepseek-v2-lite-16b", 0.5, 2, 16),    # shared expert, drops
    ("deepseek-v2-lite-16b", 1.25, 4, 1),    # decode: one dropless group
    ("granite-moe-1b-a400m", 1.25, 5, 1),
])
def test_moe_apply(arch, capacity_factor, b, s):
    jcfg, cfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    ref_pair = jmoe.moe_init(jcfg, jax.random.key(2), jnp.float32)
    p = _carry(lambda dev: moe.moe_init(cfg, None, F32, dev), ref_pair)
    x = _randn(np.random.default_rng(2), b, s, cfg.d_model)
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    jy, jaux = _jit(jmoe.moe_apply)(jcfg, ref_pair[0], jnp.asarray(x))
    _close(y, jy)
    _close(aux["load_balance_loss"], jaux["load_balance_loss"], 1e-6)
    _close(aux["dropped_frac"], jaux["dropped_frac"], 1e-6)
    if capacity_factor < 1 and s > 1:
        assert float(aux["dropped_frac"]) > 0
    if s == 1:
        assert float(aux["dropped_frac"]) == 0


def test_moe_top_k_takes_the_lower_index_among_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, ids = moe._top_k(probs, 2)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert ids.tolist() == np.asarray(jids).tolist() == [[1, 2], [0, 1]]
    _close(vals, jvals, 0)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b, l, g, hg, p_, n):
    rng = np.random.default_rng(seed)
    xh = _randn(rng, b, l, g, hg, p_)
    Bh = _randn(rng, b, l, g, n, scale=0.5)
    Ch = _randn(rng, b, l, g, n, scale=0.5)
    dt = np.log1p(np.exp(_randn(rng, b, l, g * hg)))
    A = -np.exp(_randn(rng, g * hg, scale=0.3))
    state = _randn(rng, b, g, hg, p_, n, scale=0.5)
    return [x.astype(np.float32) for x in (xh, Bh, Ch, dt, A, state)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g,hg", [(1, 4), (2, 2)])
def test_ssd_chunked(g, hg, with_state):
    """Two chunks of mamba2 REDUCED's 32: against the reference's chunked
    and sequential forms and the port's own sequential oracle, with and
    without an initial state."""
    jcfg, cfg = _cfgs("mamba2-2.7b")
    *arrays, state = _ssd_inputs(3, 2, 64, g, hg, 16, 8)
    init = state if with_state else None
    t = [torch.from_numpy(a) for a in arrays]
    y, s = ssm.ssd_chunked(cfg, *t, torch.from_numpy(init)
                           if with_state else None)
    j = [jnp.asarray(a) for a in arrays]
    jinit = jnp.asarray(init) if with_state else None
    jy, js = _jit(jssm.ssd_chunked)(jcfg, *j, jinit)
    assert y.dtype == s.dtype == F32
    _close(y, jy)
    _close(s, js)
    ry, rs = ssm.ssd_reference(cfg, *t, torch.from_numpy(init)
                               if with_state else None)
    jry, jrs = _jit(jssm.ssd_reference)(jcfg, *j, jinit)
    _close(ry, jry)
    _close(rs, jrs)
    _close(y, ry)
    _close(s, rs)


def test_ssm_apply_with_cache_then_decode():
    jcfg, cfg = _cfgs("mamba2-2.7b")
    ref_pair = jssm.ssm_init(jcfg, jax.random.key(4), jnp.float32)
    p = _carry(lambda dev: ssm.ssm_init(cfg, None, F32, dev), ref_pair)
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 32, cfg.d_model)
    out, cache = ssm.ssm_apply(cfg, p, torch.from_numpy(x),
                               return_cache=True)
    jout, jcache = jax.jit(jssm.ssm_apply, static_argnums=(0, 4))(
        jcfg, ref_pair[0], jnp.asarray(x), None, True)
    _close(out, jout)
    _trees_close(cache, jcache)
    ssm_decode = _jit(jssm.ssm_decode)
    for step in range(2):
        x1 = _randn(rng, 2, 1, cfg.d_model)
        out, cache = ssm.ssm_decode(cfg, p, torch.from_numpy(x1), cache)
        jout, jcache = ssm_decode(jcfg, ref_pair[0], jnp.asarray(x1),
                                       jcache)
        _close(out, jout)
        _trees_close(cache, jcache)


def test_causal_conv_is_a_cross_correlation():
    rng = np.random.default_rng(5)
    x, w = _randn(rng, 2, 7, 3), _randn(rng, 3, 4)
    _close(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)), 1e-6)


# ---------------------------------------------------------------------------
# attention: GQA cache paths, MLA, cross-attention
# ---------------------------------------------------------------------------
def _positions(b, s):
    return np.tile(np.arange(s), (b, 1))


@pytest.mark.parametrize("arch", ["smollm-135m", "chameleon-34b"])
def test_gqa_prefill_then_decode(arch):
    """GQA with its cache; chameleon adds qk-norm."""
    jcfg, cfg = _cfgs(arch)
    ref_pair = jattention.gqa_init(jcfg, jax.random.key(6), jnp.float32)
    p = _carry(lambda dev: (attention.gqa_init(cfg, None, F32, dev),
                            attention.gqa_axes(cfg)), ref_pair)
    b, s, t = 2, 12, 16
    rng = np.random.default_rng(6)
    x = _randn(rng, b, s, cfg.d_model)
    mask = np.tril(np.ones((s, s), bool))
    cache = attention.gqa_init_cache(cfg, b, t, F32, "cpu")
    jcache = jattention.gqa_init_cache(jcfg, b, t, jnp.float32)
    y, cache = attention.gqa_prefill(
        cfg, p, torch.from_numpy(x), torch.from_numpy(_positions(b, s)),
        torch.from_numpy(mask), cache)
    jy, jcache = _jit(jattention.gqa_prefill)(
        jcfg, ref_pair[0], jnp.asarray(x), jnp.asarray(_positions(b, s)),
        jnp.asarray(mask), jcache)
    _close(y, jy)
    _trees_close(cache, jcache)
    pos = np.array([s, s - 3])                 # rows at different indices
    gqa_decode = _jit(jattention.gqa_decode)
    for step in range(2):
        x1 = _randn(rng, b, 1, cfg.d_model)
        y, cache = attention.gqa_decode(cfg, p, torch.from_numpy(x1),
                                        torch.from_numpy(pos + step), cache)
        jy, jcache = gqa_decode(jcfg, ref_pair[0],
                                           jnp.asarray(x1),
                                           jnp.asarray(pos + step), jcache)
        _close(y, jy)
        _trees_close(cache, jcache)


def test_mla_apply_then_absorbed_decode():
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    ref_pair = jattention.mla_init(jcfg, jax.random.key(7), jnp.float32)
    p = _carry(lambda dev: attention.mla_init(cfg, None, F32, dev), ref_pair)
    b, s, t = 2, 10, 14
    rng = np.random.default_rng(7)
    x = _randn(rng, b, s, cfg.d_model)
    mask = np.tril(np.ones((s, s), bool))
    args = (_positions(b, s), mask)
    y = attention.mla_apply(cfg, p, torch.from_numpy(x),
                            *map(torch.from_numpy, args))
    jy = _jit(jattention.mla_apply)(jcfg, ref_pair[0], jnp.asarray(x),
                              *map(jnp.asarray, args))
    _close(y, jy)
    cache = attention.mla_init_cache(cfg, b, t, F32, "cpu")
    jcache = jattention.mla_init_cache(jcfg, b, t, jnp.float32)
    y, cache = attention.mla_apply(cfg, p, torch.from_numpy(x),
                                   *map(torch.from_numpy, args), cache)
    jy, jcache = _jit(jattention.mla_apply)(
        jcfg, ref_pair[0], jnp.asarray(x), *map(jnp.asarray, args), jcache)
    _close(y, jy)
    _trees_close(cache, jcache)
    pos = np.array([s, s - 2])
    mla_decode = _jit(jattention.mla_decode)
    for step in range(2):
        x1 = _randn(rng, b, 1, cfg.d_model)
        y, cache = attention.mla_decode(cfg, p, torch.from_numpy(x1),
                                        torch.from_numpy(pos + step), cache)
        jy, jcache = mla_decode(jcfg, ref_pair[0],
                                           jnp.asarray(x1),
                                           jnp.asarray(pos + step), jcache)
        _close(y, jy)
        _trees_close(cache, jcache)


def test_xattn_apply():
    jcfg, cfg = _cfgs("whisper-base")
    ref_pair = jattention.xattn_init(jcfg, jax.random.key(8), jnp.float32)
    p = _carry(lambda dev: attention.xattn_init(cfg, None, F32, dev),
               ref_pair)
    rng = np.random.default_rng(8)
    enc = _randn(rng, 2, cfg.encoder_seq_len, cfg.d_model)
    x = _randn(rng, 2, 5, cfg.d_model)
    kv = attention.xattn_kv(p, torch.from_numpy(enc))
    jkv = jattention.xattn_kv(ref_pair[0], jnp.asarray(enc))
    _close(kv[0], jkv[0])
    _close(kv[1], jkv[1])
    _close(attention.xattn_apply(cfg, p, torch.from_numpy(x), kv),
           _jit(jattention.xattn_apply)(jcfg, ref_pair[0], jnp.asarray(x),
                                        jkv))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_init_tree_matches_reference(arch):
    """The port's parameter and cache trees (names, shapes, types) and
    their logical axes are the reference's, at REDUCED and at CONFIG (both
    drawn on the meta device, the reference's abstractly)."""
    for reduced in (True, False):
        jcfg = jget_config(arch, reduced=reduced)
        cfg = get_config(arch, reduced=reduced)
        jmodel, model = jbuild(jcfg), Model(cfg, "meta")
        jparams, jaxes = jmodel.abstract_init()
        params, axes = model.init(None)
        assert axes == jaxes
        assert _shapes(params) == _shapes(jparams)
        jcaches, jcache_axes = jmodel.abstract_cache(2, 40)
        caches, cache_axes = model.init_cache(2, 40)
        assert cache_axes == jcache_axes
        assert _shapes(caches) == _shapes(jcaches)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_decode_matches_prefill(arch):
    """The port alone (mirrors the reference's
    test_arch_decode_matches_forward): prefill S tokens then decode 2 gives
    the last logits of one prefill over all S + 2. MoE is made dropless, as
    there, since prefill's capacity drops tokens that decode keeps."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", use_flash_kernel=False)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = Model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(2))
    b, s, extra = 2, 24, 2
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (b, s + extra), generator=gen)
    batch, full = {"tokens": toks[:, :s]}, {"tokens": toks}
    if cfg.is_encoder_decoder:
        frames = torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                             generator=gen)
        batch["frames"] = full["frames"] = frames
    caches, _ = model.init_cache(b, s + extra)
    _, caches = model.prefill(params, batch, caches)
    for t in range(extra):
        logits_dec, caches = model.decode(
            params, {"token": toks[:, s + t:s + t + 1],
                     "positions": torch.full((b,), s + t)}, caches)
    logits_full, _ = model.prefill(params, full,
                                   model.init_cache(b, s + extra)[0])
    _close(logits_dec[:, -1], logits_full[:, -1])


def test_params_from_arrays_checks_names_and_shapes():
    jcfg, cfg = _cfgs("smollm-135m")
    arrays = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0))[0])
    params = params_from_arrays(cfg, arrays, device="cpu")
    np.testing.assert_array_equal(_np(params["embed"]), arrays["embed"])
    bf16 = params_from_arrays(cfg, arrays, dtype="bfloat16", device="cpu")
    assert bf16["embed"].dtype == torch.bfloat16
    missing = dict(arrays, blocks={})
    with pytest.raises(ValueError, match="blocks: expected weights"):
        params_from_arrays(cfg, missing, device="cpu")
    wrong = dict(arrays, final_norm=np.ones((7,), np.float32))
    with pytest.raises(ValueError, match="final_norm: expected"):
        params_from_arrays(cfg, wrong, device="cpu")
