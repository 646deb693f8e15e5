"""The port's bandit-routed serving (``repro_torch.serve.bandit``,
``launch.bandit_serve``) on the CPU against the JAX package: the router's
decisions, UCB bounds, the quality proxy, journal replay (a journal written
by the reference replays in the port), the surrogate loop's spawn and cull
on the same history, the model arms' tokens from the reference's weights
(the temperature-0.8 arm with the reference's Gumbel draws replayed), and
routing through the fault-injected service pool, bit-exact against the
inline run at ``lat_weight=0``.

Arms that emit fixed token blocks (the reference's own test arms) make the
rewards exact constants, so routing is compared pull for pull. Tolerances:
decisions, rewards, statistics and journals equal; the spawned genome
within 1e-2 of the unit cube per dim (the reference's ask with its own
draws replayed: tests/test_torch_surrogate.py's batch tolerance); model-arm
tokens equal wherever the port's top-2 margin of what it takes the argmax
of exceeds 2e-4 (the serving tests' logit tolerance).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.explore import surrogate as jsur  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import bandit as jbandit  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import ExplorationService  # noqa: E402
from repro_torch.explore import surrogate as tsur  # noqa: E402
from repro_torch.launch import bandit_serve  # noqa: E402
from repro_torch.launch.explore import make_init_pool  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.model import params_from_arrays  # noqa: E402
from repro_torch.serve import bandit, engine  # noqa: E402
from repro_torch.serve import teacher_forced_logits  # noqa: E402

PROMPTS = np.zeros((2, 4), np.int32)
TOL = 2e-4
GENOME_ATOL = 1e-2


def _const_gen(fill, n):
    """A (B, n) token block: ``"ramp"`` (every token unique, quality 1) or
    one value (quality 1/n). Works with either package's second argument
    (key or seed), which it ignores."""
    def gen(prompts, _key_or_seed):
        b = np.asarray(prompts).shape[0]
        if fill == "ramp":
            return np.tile(np.arange(n, dtype=np.int32), (b, 1))
        return np.full((b, n), fill, np.int32)
    return gen


ARMS = (("low", 0, 8, (0.0, 0.0)), ("mid", 1, 4, (0.4, 0.0)),
        ("high", "ramp", 8, (0.8, 0.0)))


def _routers(cfg_kw, journal=None, jjournal=None, spawn=None, service=None):
    """(port router, reference router) over the same three fixed arms."""
    def arms(mod):
        return [mod.Arm(name, _const_gen(fill, n),
                        genome=np.asarray(g, np.float32))
                for name, fill, n, g in ARMS]

    def spawner(mod):
        if spawn is None:
            return None
        return lambda genome: spawn(mod, genome)

    return (bandit.BanditRouter(arms(bandit), bandit.BanditConfig(**cfg_kw),
                                journal=journal, spawn_fn=spawner(bandit),
                                service=service),
            jbandit.BanditRouter(arms(jbandit),
                                 jbandit.BanditConfig(**cfg_kw),
                                 journal=jjournal, spawn_fn=spawner(jbandit)))


POLICIES = [dict(policy="ucb", ucb_c=0.5, lat_weight=0.0),
            dict(policy="ucb", ucb_c=2.0, lat_weight=0.0, min_pulls=2),
            dict(policy="epsilon", epsilon=0.3, lat_weight=0.0, seed=9),
            dict(policy="epsilon", epsilon=0.5, lat_weight=0.0, seed=3),
            dict(policy="epsilon", epsilon=0.0, lat_weight=0.0)]


@pytest.mark.parametrize("cfg_kw", POLICIES)
def test_routing_decisions_match_the_reference(cfg_kw):
    mine, theirs = _routers(cfg_kw)
    for _ in range(40):
        r, jr = mine.route(PROMPTS), theirs.route(PROMPTS)
        assert (r.arm, r.reward, r.quality, r.request) == \
            (jr.arm, jr.reward, jr.quality, jr.request)
        np.testing.assert_array_equal(r.tokens, jr.tokens)
    assert mine.history == theirs.history
    assert mine.arm_stats() == theirs.arm_stats()
    assert mine.oracle_arm() == theirs.oracle_arm()
    np.testing.assert_array_equal(mine.regret_curve(), theirs.regret_curve())


def test_ucb_bound_matches_the_reference():
    mine, theirs = _routers(dict(policy="ucb", ucb_c=1.7))
    for r in (mine, theirs):
        for arm, (pulls, total) in zip(r.arms, ((10, 7.5), (3, 1.2),
                                                (0, 0.0))):
            arm.stats.pulls, arm.stats.reward_sum = pulls, total
    for i in range(3):
        for t in (None, 1, 2, 13, 1000):
            assert mine.ucb_bound(i, t) == theirs.ucb_bound(i, t)


def test_token_diversity_matches_the_reference():
    rng = np.random.default_rng(4)
    for shape in ((2, 12), (1, 1), (5, 3, 4), (0, 3)):
        t = rng.integers(0, 5, shape).astype(np.int32)
        assert bandit.token_diversity(t) == jbandit.token_diversity(t)


def test_a_reference_journal_replays_in_the_port(tmp_path):
    """The reference routes 9 requests and journals a spawn and a cull;
    the port's router replays the file to the same statistics, request
    counter and active set, then routes on as the reference does."""
    path = str(tmp_path / "rewards.jsonl")

    def spawn(mod, genome):
        return mod.Arm("spawned", _const_gen("ramp", 6),
                       genome=np.asarray(genome, np.float32))

    kw = dict(policy="ucb", ucb_c=0.5, lat_weight=0.0)
    _, theirs = _routers(kw, jjournal=path, spawn=spawn)
    for _ in range(9):
        theirs.route(PROMPTS)
    theirs._log({"op": "spawn", "arm": "gp-arm", "genome": [0.9, 0.0]})
    theirs._log({"op": "cull", "arm": "low"})
    theirs.close()
    with open(path, "a") as f:
        f.write('{"op": "pull", "req": 99, "ar')      # a torn tail
    size = len(open(path).read())

    mine, _ = _routers(kw, journal=path, spawn=spawn)
    _, again = _routers(kw, jjournal=path, spawn=spawn)
    assert mine.n_requests == again.n_requests == 9
    assert mine.arm_stats() == again.arm_stats()
    assert [a.name for a in mine.arms] == [a.name for a in again.arms]
    assert mine.active() == again.active()
    for _ in range(6):
        r, jr = mine.route(PROMPTS), again.route(PROMPTS)
        assert (r.arm, r.reward) == (jr.arm, jr.reward)
    mine.close()
    again.close()
    # both appended the same records, in the same schema
    lines = open(path).read()[size:].splitlines()
    assert len(lines) == 12
    mine_recs = [json.loads(x) for x in lines[0::2]]
    their_recs = [json.loads(x) for x in lines[1::2]]
    for a, b in zip(mine_recs, their_recs):
        a.pop("latency_s"), b.pop("latency_s")
        assert a == b


def _reference_draws(cfg, round_):
    """The reference's ascent draws of round ``round_`` as torch tensors
    (its ``fold_in`` keys)."""
    key = jax.random.fold_in(jax.random.key(cfg.seed), round_)
    starts = jax.random.uniform(jax.random.fold_in(key, 0),
                                (cfg.n_starts, cfg.q, cfg.dim), jnp.float32)
    normals = jsur._slot_normals(jax.random.fold_in(key, 1), cfg.q,
                                 cfg.mc_samples)
    return (torch.from_numpy(np.array(starts)),
            torch.from_numpy(np.array(normals)))


def test_sync_surrogate_spawns_and_culls_as_the_reference(tmp_path,
                                                          monkeypatch):
    """Two surrogate syncs on the same routed history: the same arm
    culled each time, the spawned genomes within GENOME_ATOL (unit cube),
    the same journal operations."""
    monkeypatch.setattr(tsur, "draw_proposal_noise", _reference_draws)
    spawned = {"port": [], "ref": []}

    def spawn(mod, genome):
        who = "port" if mod is bandit else "ref"
        spawned[who].append(np.asarray(genome, np.float32))
        return mod.Arm(f"gp{len(spawned[who])}", _const_gen("ramp", 6),
                       genome=np.asarray(genome, np.float32))

    kw = dict(policy="epsilon", epsilon=0.0, lat_weight=0.0)
    mine, theirs = _routers(kw, journal=str(tmp_path / "p.jsonl"),
                            jjournal=str(tmp_path / "r.jsonl"), spawn=spawn)
    skw = dict(bounds=bandit.ARM_BOUNDS, q=1, n_init=2, seed=0,
               lengthscales=(0.2,), n_starts=6, opt_steps=12,
               mc_samples=32)
    ex = tsur.SurrogateExplorer(tsur.SurrogateConfig(**skw), device="cpu")
    jex = jsur.SurrogateExplorer(jsur.SurrogateConfig(**skw))
    span = np.array([hi - lo for lo, hi in bandit.ARM_BOUNDS])
    for _ in range(2):
        for _ in range(6):
            assert mine.route(PROMPTS).arm == theirs.route(PROMPTS).arm
        a, ja = mine.sync_surrogate(ex), theirs.sync_surrogate(jex)
        assert a.name == ja.name
        np.testing.assert_allclose(a.genome / span, ja.genome / span,
                                   atol=GENOME_ATOL)
        assert mine.active() == theirs.active()
        assert [mine.arms[i].name for i in mine.active()] == \
            [theirs.arms[i].name for i in theirs.active()]
    mine.close()
    theirs.close()
    ops = [[json.loads(x)["op"] for x in open(tmp_path / f)]
           for f in ("p.jsonl", "r.jsonl")]
    assert ops[0] == ops[1] and "cull" in ops[0] and "spawn" in ops[0]


def test_sync_surrogate_needs_two_armed_arms():
    arms = [bandit.Arm("only", _const_gen("ramp", 8),
                       genome=np.array([0.5, 0.0], np.float32)),
            bandit.Arm("nogenome", _const_gen(0, 8))]
    r = bandit.BanditRouter(arms, bandit.BanditConfig(lat_weight=0.0))
    r.route(PROMPTS)
    r.route(PROMPTS)
    ex = tsur.SurrogateExplorer(tsur.SurrogateConfig(
        bounds=bandit.ARM_BOUNDS, q=1, n_init=2), device="cpu")
    assert r.sync_surrogate(ex) is None


def test_routing_is_bit_exact_under_35pct_failures(tmp_path):
    """Every request fires as a journaled service task on a pool failing
    35 % of the attempts: routing, rewards and tokens equal the inline
    run's (the reference's chaos test, in the port)."""
    kw = dict(policy="ucb", ucb_c=0.5, lat_weight=0.0, seed=5)
    clean, _ = _routers(kw)
    clean_tokens = [clean.route(PROMPTS).tokens for _ in range(14)]
    pool = make_init_pool(0.35, backoff_s=0.01, retries=12, device="cpu")
    service = ExplorationService(pool, journal=str(tmp_path / "q.jsonl"),
                                 name="bandit-test")
    try:
        chaos, _ = _routers(kw, service=service)
        chaos_tokens = [chaos.route(PROMPTS).tokens for _ in range(14)]
    finally:
        service.shutdown()
        pool.shutdown()
    assert pool.stats.snapshot()["failed_attempts"] > 0
    assert chaos.history == clean.history
    for a, b in zip(clean_tokens, chaos_tokens):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# model arms from the reference's weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smollm():
    """smollm-135m at REDUCED in f32 as make_arm_set builds it, with the
    reference's weights from key(0) in both packages."""
    jcfg = dataclasses.replace(jconfigs.get_config("smollm-135m",
                                                   reduced=True),
                               dtype="float32", use_flash_kernel=False)
    jmodel = jbuild(jcfg)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    cfg = dataclasses.replace(configs.get_config("smollm-135m",
                                                 reduced=True),
                              dtype="float32", use_flash_kernel=False)
    model = build(cfg, "cpu")
    params = params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return jmodel, jparams, model, params, prompts


def _gumbel_replay(key, b, n, vocab):
    """The reference's Gumbel noise in the order its ``generate`` draws it:
    one split for the first token, one a decode step."""
    noise, rng = [], key
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        noise.append(np.asarray(jax.random.gumbel(sub, (b, vocab),
                                                  jnp.float32)))
    return noise


def _followed(mine, theirs, scores):
    """Tokens equal wherever the top-2 margin of ``scores`` (N, B, V)
    exceeds TOL, each row up to its first step under it; returns the
    number of steps compared."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    followed = 0
    for r in range(mine.shape[0]):
        for t in range(mine.shape[1]):
            if margin[t, r] <= TOL:
                break
            assert mine[r, t] == theirs[r, t], (r, t, margin[t, r])
            followed += 1
    return followed


def test_quantized_weights_equal_the_references(smollm):
    _, jparams, _, params, _ = smollm
    got = _flat(bandit.quantize_params_int8(params))
    want = _flat(jax.tree.map(np.asarray,
                              jbandit.quantize_params_int8(jparams)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("temperature,quantize", [(0.8, False), (0.0, True)])
def test_model_arm_tokens_match_the_reference(smollm, monkeypatch,
                                              temperature, quantize):
    """The temperature-0.8 arm with the reference's Gumbel draws for
    request 3 replayed through ``engine.draw_gumbel``; the int8 greedy arm
    as it is."""
    jmodel, jparams, model, params, prompts = smollm
    n = 12
    jarm = jbandit.make_model_arm(jmodel, jparams, temperature=temperature,
                                  max_new_tokens=n, quantize=quantize,
                                  seed_tag="smollm-135m")
    arm = bandit.make_model_arm(model, params, temperature=temperature,
                                max_new_tokens=n, quantize=quantize,
                                seed_tag="smollm-135m")
    assert arm.name == jarm.name
    np.testing.assert_array_equal(arm.genome, jarm.genome)
    key = jax.random.fold_in(jax.random.key(0), 3)
    theirs = jarm.generate_fn(prompts, key)
    noise = _gumbel_replay(key, 2, n, model.cfg.padded_vocab)
    draws = iter(noise)
    if temperature > 0:
        monkeypatch.setattr(engine, "draw_gumbel",
                            lambda shape, gen, dev: torch.from_numpy(
                                next(draws).copy()))
    mine = arm.generate_fn(prompts, tsur.derive_seed(0, 3))
    assert mine.dtype == np.int32 and mine.shape == theirs.shape == (2, n)
    p = bandit.quantize_params_int8(params) if quantize else params
    logits = teacher_forced_logits(
        model, p, torch.from_numpy(prompts).long(),
        torch.tensor(np.asarray(theirs), dtype=torch.long)).numpy()
    scores = logits / temperature + np.stack(noise) if temperature > 0 \
        else logits
    assert _followed(mine, theirs, scores) >= 2 * 4


def test_cli_chaos_routes_as_inline_and_writes_its_files(tmp_path, capsys):
    """``--fault-rate 0.35 --lat-weight 0`` through the service equals the
    inline ``--lat-weight 0`` run (arms, spawns, culls), and a journal
    replays on a rerun."""
    base = ["--device", "cpu", "--reduced", "--requests", "12",
            "--lat-weight", "0", "--surrogate-every", "4", "--batch", "2",
            "--prompt-len", "4", "--new-tokens", "6", "--policy", "ucb",
            "--ucb-c", "2.0", "--epsilon", "0.1", "--seed", "0",
            "--arch", "smollm-135m"]
    bandit_serve.main(base + ["--out", str(tmp_path / "inline"),
                              "--journal", str(tmp_path / "j.jsonl")])
    bandit_serve.main(base + ["--out", str(tmp_path / "chaos"),
                              "--fault-rate", "0.35"])
    inline = json.load(open(tmp_path / "inline" / "bandit_result.json"))
    chaos = json.load(open(tmp_path / "chaos" / "bandit_result.json"))
    assert chaos["arms"] == inline["arms"]
    assert chaos["oracle_arm"] == inline["oracle_arm"]
    assert chaos["regret"] == inline["regret"]
    assert chaos["pool_stats"]["failed_attempts"] > 0
    assert (tmp_path / "chaos" / "bandit_provenance.json").exists()
    assert len(inline["arms"]) > 3                   # the surrogate spawned
    # the journal's 12 pulls replay: nothing left to route
    capsys.readouterr()
    res = bandit_serve.run_bandit(
        reduced=True, requests=12, batch=2, prompt_len=4, new_tokens=6,
        lat_weight=0.0, surrogate_every=4, journal=str(tmp_path / "j.jsonl"),
        out_dir=str(tmp_path / "again"), device="cpu",
        printer=lambda *_: None)
    assert res["requests"] == 12
    assert {k: v["pulls"] for k, v in res["arms"].items()
            if v["pulls"]} == {k: v["pulls"] for k, v in
                               inline["arms"].items() if v["pulls"]}


def test_cli_refuses_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bandit_serve.main(["--reduced", "--requests", "1"])
