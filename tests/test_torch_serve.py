"""The port's serving path (``repro_torch.serve``, ``launch.serve``) on the
CPU against the JAX package, for every arch at REDUCED in f32: prefill and
decode logits and caches, greedy ``generate`` tokens, and temperature-1.5
``generate`` with the reference's Gumbel draws replayed; the configs; the
engine's first-token and EOS rules on a stub model; the CLI.

The weights are the reference's ``Model(cfg).init(key(0))`` carried by
``params_from_arrays``; the prompts are ``serve_once``'s (numpy's
``default_rng(0)``). The tolerance is 2e-4 (atol and rtol) on logits, the
reference's own decode-against-prefill tolerance. Tokens must be equal at
every step where the reference's top-2 margin of what it takes the argmax
of (the logits, or logits / T + noise) exceeds it; a row is followed up to
its first step at or under the margin, after which the two trajectories
may part. Both packages' logits are teacher-forced on the reference's
tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro.serve.engine import _compiled  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import params_from_arrays  # noqa: E402
from repro_torch.serve import ServeConfig, engine, generate  # noqa: E402

TOL = 2e-4
B, S, N = 4, 16, 24                 # serve_once's batch, prompt, new tokens
T_SAMPLED = 1.5


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


def _snapshot(tree):
    return {path: _np(leaf).copy() for path, leaf in _flat(tree).items()}


def _trees_close(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(_np(g[path]), _np(w[path]), atol=TOL,
                                   rtol=TOL, err_msg=path)


@functools.lru_cache(maxsize=None)
def _case(arch):
    """Both packages set up as ``serve_once`` serves ``arch`` (REDUCED,
    f32), the reference's weights in both."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                               dtype="float32", use_flash_kernel=False)
    jmodel = jbuild(jcfg)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    model, _, prompts, frames, _ = serve.setup(
        arch, batch=B, prompt_len=S, new_tokens=N, device="cpu")
    params = params_from_arrays(model.cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jbatch = {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)}
    if frames is not None:
        jbatch["frames"] = jnp.asarray(frames.numpy())
    return dict(jmodel=jmodel, jparams=jparams, jbatch=jbatch,
                jdecode=jax.jit(jmodel.decode), model=model, params=params,
                prompts=prompts, frames=frames)


def _teacher_forced(c, tokens):
    """Both packages' f32 logits (N, B, V) at every step of ``tokens`` (B, N)
    fed back one at a time, and the caches after prefill and after two
    decode steps."""
    jmodel, model = c["jmodel"], c["model"]
    jprefill = _compiled(jmodel, JServeConfig(max_new_tokens=N))[0]
    jcache, _ = jmodel.init_cache(B, S + N)
    jlogits, jcache = jprefill(c["jparams"], c["jbatch"], jcache)
    batch = {"tokens": c["prompts"]}
    if c["frames"] is not None:
        batch["frames"] = c["frames"]
    cache, _ = model.init_cache(B, S + N)
    logits, cache = model.prefill(c["params"], batch, cache)
    # copies: the port's caches are written in place by the next step
    caches = [(_snapshot(cache), _snapshot(jcache))]
    got, want = [logits[:, -1]], [jlogits[:, -1]]
    for t in range(N - 1):
        tok = tokens[:, t:t + 1]
        jlogits, jcache = c["jdecode"](
            c["jparams"], {"token": jnp.asarray(tok, jnp.int32),
                           "positions": jnp.full((B,), S + t, jnp.int32)},
            jcache)
        logits, cache = model.decode(
            c["params"], {"token": torch.from_numpy(tok.copy()),
                          "positions": torch.full((B,), S + t)}, cache)
        got.append(logits[:, -1])
        want.append(jlogits[:, -1])
        if t < 2:
            caches.append((_snapshot(cache), _snapshot(jcache)))
    return (np.stack([_np(x) for x in got]),
            np.stack([_np(x) for x in want]), caches)


def _assert_tokens(mine, theirs, scores):
    """Tokens equal wherever the reference's top-2 margin of ``scores``
    (N, B, V) exceeds TOL; each row up to its first step under it."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]                 # (N, B)
    followed = 0
    for r in range(B):
        for t in range(N):
            if margin[t, r] <= TOL:
                break
            assert mine[r, t] == theirs[r, t], (r, t, margin[t, r])
            followed += 1
    return followed


def _gumbel_replay(key, vocab):
    """The reference's Gumbel noise in the order its ``generate`` draws it:
    one split for the first token, one a decode step."""
    noise, rng = [], key
    for _ in range(N):
        rng, sub = jax.random.split(rng)
        noise.append(np.asarray(jax.random.gumbel(sub, (B, vocab),
                                                  jnp.float32)))
    return noise


@functools.lru_cache(maxsize=None)
def _greedy(arch):
    """The reference's greedy tokens (B, N) and both packages' logits and
    caches teacher-forced on them."""
    c = _case(arch)
    theirs = np.asarray(jgenerate(c["jmodel"], c["jparams"],
                                  c["jbatch"]["tokens"],
                                  JServeConfig(max_new_tokens=N),
                                  frames=c["jbatch"].get("frames")))
    return (theirs,) + _teacher_forced(c, theirs)


def check_prefill_and_decode(arch):
    """Prefill's logits and caches, then two decode steps' logits and
    caches, on the reference's greedy tokens."""
    _, got, want, caches = _greedy(arch)
    assert len(caches) == 3
    for cache, jcache in caches:
        _trees_close(cache, jcache)
    np.testing.assert_allclose(got[:3], want[:3], atol=TOL, rtol=TOL)


def check_greedy(arch):
    c = _case(arch)
    theirs, got, want, _ = _greedy(arch)
    mine = generate(c["model"], c["params"], c["prompts"],
                    ServeConfig(max_new_tokens=N),
                    frames=c["frames"]).numpy()
    assert mine.shape == (B, N)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert _assert_tokens(mine, theirs, want) >= B   # some steps held
    # the reference's own tokens are its logits' argmax
    _assert_tokens(want.argmax(-1).T, theirs, want)


def check_sampled(arch, monkeypatch):
    """Temperature 1.5: the port's draws are replaced by the reference's
    own Gumbel noise, which ``jax.random.categorical`` adds to logits / T."""
    c = _case(arch)
    key = jax.random.key(3)
    theirs = np.asarray(jgenerate(
        c["jmodel"], c["jparams"], c["jbatch"]["tokens"],
        JServeConfig(max_new_tokens=N, temperature=T_SAMPLED),
        frames=c["jbatch"].get("frames"), rng=key))
    noise = _gumbel_replay(key, c["model"].cfg.padded_vocab)
    draws = iter(noise)

    def replay(shape, generator, device):
        nxt = next(draws)
        assert tuple(shape) == nxt.shape
        return torch.from_numpy(nxt.copy()).to(device)

    monkeypatch.setattr(engine, "draw_gumbel", replay)
    mine = generate(c["model"], c["params"], c["prompts"],
                    ServeConfig(max_new_tokens=N, temperature=T_SAMPLED),
                    frames=c["frames"]).numpy()
    with pytest.raises(StopIteration):
        next(draws)                                    # every draw used
    got, want, _ = _teacher_forced(c, theirs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    scores = want / T_SAMPLED + np.stack(noise)
    assert _assert_tokens(mine, theirs, scores) >= B
    # the replayed noise is the reference's: its tokens follow from it
    _assert_tokens(scores.argmax(-1).T, theirs, scores)
    assert not np.array_equal(theirs, _greedy(arch)[0])


# The archs whose layers are GQA + a dense MLP; the others (SSM, MoE, MLA,
# the hybrid and the encoder-decoder) are in test_torch_serve_mixers.py,
# which shares the checks above: the reference's init and compiles take
# most of each case's time, and the split keeps each file near a minute.
DENSE = ("minicpm-2b", "phi3-medium-14b", "smollm-135m", "granite-3-2b",
         "chameleon-34b")


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_reference(arch):
    check_greedy(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_sampled_generate_replays_reference_draws(arch, monkeypatch):
    check_sampled(arch, monkeypatch)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_are_copies_of_the_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for reduced in (True, False):
        mine = configs.get_config(arch, reduced=reduced)
        theirs = jconfigs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        for prop in ("padded_vocab", "resolved_head_dim", "pattern",
                     "n_blocks"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# the engine's rules on a stub model (tests/test_data_serve.py's)
# ---------------------------------------------------------------------------
class _StubModel:
    """The serve interface with scripted logits: flat at prefill unless
    ``prefill_peak`` forces an argmax, strongly preferring token 3 at every
    decode step."""

    def __init__(self, vocab=32, prefill_peak=None):
        self.vocab = vocab
        self.prefill_peak = prefill_peak

    def init_cache(self, b, max_seq):
        return torch.zeros((b,), dtype=torch.long), None

    def prefill(self, params, batch, cache):
        logits = torch.zeros((batch["tokens"].shape[0], 1, self.vocab))
        if self.prefill_peak is not None:
            logits[:, :, self.prefill_peak] = 10.0
        return logits, cache

    def decode(self, params, batch, cache):
        logits = torch.zeros((batch["token"].shape[0], 1, self.vocab))
        logits[:, :, 3] = 10.0
        return logits, cache


def test_first_token_respects_temperature():
    """The first token is sampled like any other: with flat prefill logits
    it varies over generators at temperature 1.0, while greedy pins it to
    index 0 whatever the generator."""
    model = _StubModel(vocab=64)
    prompts = torch.zeros((2, 4), dtype=torch.long)
    sc = ServeConfig(max_new_tokens=3, temperature=1.0)
    firsts = {int(generate(model, {}, prompts, sc,
                           generator=torch.Generator().manual_seed(k))[0, 0])
              for k in range(8)}
    assert len(firsts) > 1
    greedy = ServeConfig(max_new_tokens=3)
    for k in range(4):
        out = generate(model, {}, prompts, greedy,
                       generator=torch.Generator().manual_seed(k))
        assert (out[:, 0] == 0).all() and (out[:, 1:] == 3).all()


def test_first_token_eos_finishes_sequence():
    """A prefill whose argmax is the EOS id gives all-pad output: the first
    token is EOS-masked and every later step stays frozen."""
    model = _StubModel(vocab=16, prefill_peak=5)
    prompts = torch.zeros((2, 4), dtype=torch.long)
    out = generate(model, {}, prompts,
                   ServeConfig(max_new_tokens=6, eos_id=5, pad_id=0))
    assert out.shape == (2, 6) and (out == 0).all()
    free = generate(model, {}, prompts, ServeConfig(max_new_tokens=6))
    assert (free[:, 0] == 5).all() and (free[:, 1:] == 3).all()


def test_eos_in_decode_freezes_the_row():
    """EOS from a decode step pads that step and every later one."""
    model = _StubModel(vocab=16, prefill_peak=7)
    out = generate(model, {}, torch.zeros((3, 4), dtype=torch.long),
                   ServeConfig(max_new_tokens=5, eos_id=3, pad_id=9))
    assert out.tolist() == [[7, 9, 9, 9, 9]] * 3


def test_sample_token_is_argmax_of_scaled_logits_plus_noise():
    logits = torch.tensor([[0.0, 1.0, 2.0], [3.0, 0.0, 0.0]])
    noise = torch.tensor([[5.0, 0.0, 0.0], [0.0, 0.0, 2.0]])
    sc = ServeConfig(temperature=2.0)
    assert engine.sample_token(logits, sc, noise).tolist() == [0, 2]
    assert engine.sample_token(logits, ServeConfig(), None).tolist() == [2, 0]
    g = torch.Generator().manual_seed(0)
    u = engine.draw_gumbel((4096,), g, "cpu")
    assert torch.isfinite(u).all() and abs(float(u.mean()) - 0.5772) < 0.05


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                "--batch", "2", "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "[serve] smollm-135m: 2x5 tokens" in out and "on cpu" in out
    tokens, stats = serve.serve_once("whisper-base", batch=2, new_tokens=3,
                                     device="cpu", printer=lambda *a: None)
    assert tokens.shape == (2, 3) and stats["warm_s"] > 0
    assert ((tokens >= 0) & (tokens < 257)).all()


def test_cli_refuses_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "smollm-135m", "--reduced"])
