"""The port's training path (``repro_torch.data``, ``repro_torch.train``,
``Model.loss``, ``launch.train``) on the CPU against the JAX package, at
REDUCED in f32: the token stream, the int8 compression, the schedules,
AdamW and the chunked cross-entropy (``Model.loss`` and one train step per
arch are in test_torch_train_models.py). Within the port: the remat
policies, microbatch accumulation, bf16 gradient sums, kill-and-resume of
``train_loop``, the CLI, ``param_counts`` and the abstract state.

Tolerances, each measured with margin over what the two packages give:
- tokens, the int8 payloads, scales, dequantized values and error buffers:
  equal;
- the schedule: rtol 1e-6 (XLA's cos against ATen's);
- AdamW on the same grads: rtol 1e-6, atol 1e-9 on moments and masters;
- the chunked CE and its gradients: rtol 1e-5, atol 1e-7;
- within the port: remat policies and kill-and-resume bitwise; 1 against 4
  microbatches within the reference's own bounds (tests/test_train.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.models.model import chunked_softmax_xent as j_xent  # noqa: E402
from repro.train import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import chunked_softmax_xent  # noqa: E402
from repro_torch.train import (OptimizerConfig, TrainState,  # noqa: E402
                               init_opt_state, make_train_step)
from repro_torch.train import (compression, optimizer,  # noqa: E402
                               train_step)

B, S, MB = 4, 32, 2
LR = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfgs(arch, **kw):
    kw = {"dtype": "float32", "use_flash_kernel": False, **kw}
    return (dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                                **kw),
            dataclasses.replace(configs.get_config(arch, reduced=True), **kw))


def _batches(cfg, b=B, s=S, step=0):
    """(reference batch, port batch): the stream's tokens at ``step``, and
    an encoder-decoder's frames from default_rng(step)."""
    toks = TokenStream(DataConfig(cfg.vocab_size, s, b)).batch_at(step)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.is_encoder_decoder:
        fr = np.random.default_rng(step).normal(
            size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return jb, tb


def _oc(cls, **kw):
    return cls(**dict(dict(learning_rate=LR, total_steps=10,
                           warmup_steps=2), **kw))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host,hosts,vocab,seq,batch", [
    (0, 0, 0, 1, 49152, 64, 4), (3, 17, 1, 2, 512, 15, 6),
    (7, 1000, 3, 4, 122753, 128, 8), (1, 5, 0, 1, 50, 16, 2)])
def test_token_stream_equals_the_reference(seed, step, host, hosts, vocab,
                                           seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    got = TokenStream(DataConfig(**kw), host, hosts).batch_at(step)
    want = JTokenStream(JDataConfig(**kw), host, hosts).batch_at(step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1000,), (37, 300), (3,), (256,)])
def test_int8_quantization_is_the_references_bit_for_bit(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10, shape)) \
        .astype(np.float32)
    x.reshape(-1)[:3] = (0.0, 127.5 / 127.0, -2.5)   # ties to even
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s, shape).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, shape)))


def test_error_feedback_is_the_references_bit_for_bit():
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 40), "b": {"c": (300,), "d": (2, 3, 5)}}
    mk = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda t: isinstance(t, tuple))
    grads = [mk() for _ in range(3)]
    err = compression.init_error_buffers(
        jax.tree.map(torch.from_numpy, grads[0]))
    jerr = jcomp.init_error_buffers(grads[0])
    for g in grads:                     # three steps: the buffers carry
        deq, err = compression.compress_grads_ef(
            jax.tree.map(torch.from_numpy, g), err)
        jdeq, jerr = jcomp.compress_grads_ef(jax.tree.map(jnp.asarray, g),
                                             jerr)
        for tree, jtree in ((deq, jdeq), (err, jerr)):
            f, jf = _flat(tree), _flat(jtree)
            assert f.keys() == jf.keys()
            for k in f:
                np.testing.assert_array_equal(f[k].numpy(),
                                              np.asarray(jf[k]), k)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_at_every_step_matches_the_reference(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=60,
              schedule=schedule, decay_frac=0.2, min_lr_frac=0.1)
    f = optimizer.schedule_fn(OptimizerConfig(**kw))
    jf = jax.jit(jopt.schedule_fn(JOptimizerConfig(**kw)))
    steps = np.arange(0, 66, dtype=np.int32)
    got = np.array([float(f(torch.tensor(s))) for s in steps])
    want = np.array([float(jf(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_matches_the_reference_on_the_same_grads():
    """Three updates on the same gradients: one clipped (norm far above
    grad_clip), a 1-D leaf (no decay), a stacked 2-D norm (decayed, as the
    reference decays it)."""
    rng = np.random.default_rng(11)
    shapes = {"w": (16, 24), "norm": (24,), "stack": (3, 24)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20,
              weight_decay=0.1)
    oc, joc = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    state = init_opt_state(params)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init_opt_state(jparams)
    jupdate = jax.jit(lambda g, p, s: jopt.adamw_update(joc, g, p, s))
    for scale in (30.0, 0.5, 0.01):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        params, state, m = optimizer.adamw_update(
            oc, {k: torch.from_numpy(v) for k, v in g.items()}, params,
            state)
        jparams, jstate, jm = jupdate({k: jnp.asarray(v)
                                       for k, v in g.items()}, jparams,
                                      jstate)
        assert int(state.step) == int(jstate.step)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        for tree, jtree in ((params, jparams), (state.mu, jstate.mu),
                            (state.nu, jstate.nu),
                            (state.master, jstate.master)):
            for k in shapes:
                np.testing.assert_allclose(_np(tree[k]), np.asarray(jtree[k]),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
    assert float(m["grad_norm"]) < 1.0 < 30.0   # the first one was clipped


def test_adamw_keeps_bf16_params_with_f32_masters():
    params = {"w": torch.randn(8, 4).to(torch.bfloat16)}
    state = init_opt_state(params)
    assert state.master["w"].dtype == torch.float32
    new, state, _ = optimizer.adamw_update(
        OptimizerConfig(), {"w": torch.randn(8, 4).to(torch.bfloat16)},
        params, state)
    assert new["w"].dtype == torch.bfloat16
    assert torch.equal(new["w"], state.master["w"].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("transpose", [False, True])
def test_chunked_xent_and_grads_match_the_reference(transpose):
    """50 tokens in chunks of 16 (two padded), 40 vocab slots of which 33
    are real, a few targets ignored (-1)."""
    rng = np.random.default_rng(2)
    t, d, v, vocab = 50, 12, 40, 33
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((v, d) if transpose else (d, v)) * 0.5) \
        .astype(np.float32)
    tg = rng.integers(0, vocab, t).astype(np.int32)
    tg[[3, 20, 49]] = -1

    def jloss(h, w):
        return j_xent(h, w, jnp.asarray(tg), transpose, vocab_size=vocab,
                      ce_chunk=16)

    (jl, jcount), (jgh, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss, count = chunked_softmax_xent(th, tw, torch.from_numpy(tg).long(),
                                       transpose, vocab_size=vocab,
                                       ce_chunk=16)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    assert float(count) == float(jcount) == t - 3
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-7)
    # the padded vocab slots get no gradient
    pad = gw[vocab:] if transpose else gw[:, vocab:]
    assert not pad.any()


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
def _grads(cfg, params, batch):
    leaves = [p.detach().clone().requires_grad_()
              for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = build(cfg, "cpu").loss(live, batch)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_remat_policies_give_the_same_grads_bit_for_bit(arch):
    """"dots" (the matrix products saved, the rest recomputed) and "full"
    (the block recomputed) against "none"; the SSM's chunked scan and the
    MoE's scatter dispatch recompute exactly."""
    _, cfg = _cfgs(arch, remat_policy="none")
    params, _ = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = _batches(cfg)[1]
    loss, want = _grads(cfg, params, batch)
    for policy in ("dots", "full"):
        got_loss, got = _grads(dataclasses.replace(cfg, remat_policy=policy),
                               params, batch)
        assert torch.equal(got_loss, loss), policy
        for g, w in zip(got, want):
            assert torch.equal(g, w), policy


def test_microbatches_one_and_four_agree():
    """The same batch in 1 and in 4 microbatches: each microbatch's mean
    loss is averaged, so the f32 sums differ in order only; within the
    reference's own bounds (tests/test_train.py: loss and grad norm rtol
    1e-5, weights 1e-4)."""
    _, cfg = _cfgs("smollm-135m")
    model = build(cfg, "cpu")
    batch = _batches(cfg)[1]
    out = {}
    for mb in (1, 4):
        params, _ = model.init(torch.Generator().manual_seed(0))
        state = TrainState(params, init_opt_state(params),
                           torch.Generator().manual_seed(0).get_state())
        out[mb] = make_train_step(model, _oc(OptimizerConfig, warmup_steps=0),
                                  mb)(state, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[k]), float(m4[k]), rtol=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        assert float((a - b).abs().max()) < 1e-4


def test_bf16_step_sums_grads_in_f32(monkeypatch):
    """bf16 params: the grads of two microbatches are summed in f32 (the
    accumulated mean equals the f32 mean of the two bf16 grads), and the
    stepped params are the f32 masters cast to bf16."""
    _, cfg = _cfgs("smollm-135m", dtype="bfloat16")
    model = build(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    batch = _batches(cfg)[1]
    halves = [{"tokens": batch["tokens"][i * 2:(i + 1) * 2]}
              for i in range(2)]
    per = [_grads(cfg, params, h)[1] for h in halves]
    want = [(a.float() + b.float()) / 2 for a, b in zip(*per)]
    seen = {}
    real = optimizer.adamw_update

    def spy(oc, grads, p, s):
        seen["grads"] = tree_leaves(grads)
        return real(oc, grads, p, s)

    state = TrainState(params, init_opt_state(params),
                       torch.Generator().get_state())
    monkeypatch.setattr(train_step, "adamw_update", spy)
    new, _ = make_train_step(model, _oc(OptimizerConfig), 2)(state, batch)
    for g, w in zip(seen["grads"], want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    for p, m in zip(tree_leaves(new.params), tree_leaves(new.opt.master)):
        assert p.dtype == torch.bfloat16 and torch.equal(p, m.bfloat16())


class _Killed(Exception):
    pass


def test_train_loop_killed_and_resumed_equals_uninterrupted(tmp_path):
    """Killed after step 3's checkpoint (ckpt_every 3), resumed into the
    same directory: the remaining steps' losses and the final state are the
    uninterrupted run's, bit for bit (MoE, compression on)."""
    kw = dict(reduced=True, steps=6, batch=4, seq=16, microbatches=2,
              ckpt_every=3, use_compression=True, log_every=1,
              device="cpu")
    arch = "granite-moe-1b-a400m"
    straight, losses = tlaunch.train_loop(arch, printer=lambda *_: None,
                                          ckpt_dir=str(tmp_path / "a"),
                                          **kw)

    def killer(line):
        if "step     3" in line:
            raise _Killed

    with pytest.raises(_Killed):
        tlaunch.train_loop(arch, printer=killer,
                           ckpt_dir=str(tmp_path / "b"), **kw)
    lines = []
    resumed, tail = tlaunch.train_loop(arch, printer=lines.append,
                                       ckpt_dir=str(tmp_path / "b"), **kw)
    assert lines[0].startswith("[train] resumed from step 3")
    assert tail == losses[3:]
    for tree, want in ((resumed.params, straight.params),
                       (resumed.opt.master, straight.opt.master),
                       (resumed.opt.mu, straight.opt.mu),
                       (resumed.error, straight.error)):
        for a, b in zip(tree_leaves(tree), tree_leaves(want)):
            assert torch.equal(a, b)
    assert torch.equal(resumed.rng, straight.rng)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_00000003", "step_00000006"]


def test_train_loop_resumes_bf16_and_refuses_other_settings(tmp_path):
    kw = dict(reduced=True, batch=2, seq=8, ckpt_every=2, device="cpu",
              printer=lambda *_: None, ckpt_dir=str(tmp_path))
    tlaunch.train_loop("smollm-135m", steps=2, dtype="bfloat16", **kw)
    state, losses = tlaunch.train_loop("smollm-135m", steps=3,
                                       dtype="bfloat16", **kw)
    assert len(losses) == 1 and int(state.opt.step) == 3
    assert tree_leaves(state.params)[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="other settings.*dtype"):
        tlaunch.train_loop("smollm-135m", steps=4, dtype="float32", **kw)
    with pytest.raises(ValueError, match="other settings.*lr"):
        tlaunch.train_loop("smollm-135m", steps=4, dtype="bfloat16",
                           lr=1e-3, **kw)


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    argv = ["--arch", "whisper-base", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1", "--lr", "1e-3", "--microbatches", "2",
            "--compression", "--dtype", "float32", "--device", "cpu"]
    tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "[train] step     1" in out
    tlaunch.main(argv[:4] + ["3"] + argv[5:])
    assert "resumed from step 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="other settings.*compression"):
        tlaunch.main([a for a in argv if a != "--compression"])


def test_cli_refuses_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])


def test_loss_at_initialisation_is_near_log_vocab():
    _, cfg = _cfgs("smollm-135m")
    model = build(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss, metrics = model.loss(params, _batches(cfg)[1])
    assert abs(float(metrics["ce"]) - np.log(cfg.vocab_size)) < 0.5
    assert float(loss) >= float(metrics["ce"])


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_equal_the_references(arch):
    for reduced in (False, True):
        assert configs.get_config(arch, reduced=reduced).param_counts() == \
            jconfigs.get_config(arch, reduced=reduced).param_counts()


def test_abstract_train_state_is_on_the_meta_device():
    from repro_torch.train import abstract_train_state
    cfg = configs.get_config("deepseek-v2-lite-16b")     # CONFIG, bf16
    st = abstract_train_state(build(cfg), use_compression=True)
    leaves = tree_leaves(st.params) + tree_leaves(st.opt.master) \
        + tree_leaves(st.error)
    assert all(t.device.type == "meta" for t in leaves)
    assert tree_leaves(st.params)[0].dtype == torch.bfloat16
    assert tree_leaves(st.opt.master)[0].dtype == torch.float32
    n = sum(t.numel() for t in tree_leaves(st.params))
    assert n > 15e9                      # the whole 16B model, no memory
