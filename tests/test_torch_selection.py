"""NSGA-II selection of the port against the JAX package on the CPU: ranks,
crowding, truncation, offspring (fed the JAX package's own random draws),
environmental selection, the archive merge and the island reseed."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.evolution import archive as jarchive  # noqa: E402
from repro.evolution import ga as jga  # noqa: E402
from repro.evolution import island as jisland  # noqa: E402
from repro.evolution import nsga2 as jnsga2  # noqa: E402
from repro_torch.evolution import archive, ga, island, nsga2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BOUNDS = ((0.0, 99.0), (0.0, 99.0))


def _t(x):
    return torch.from_numpy(np.array(x))


def _objectives(seed, n, m=3, levels=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, (n, m)).astype(np.float32)


RANK_CASES = {
    "plain": dict(n=40, valid=False, groups=0),
    "prime": dict(n=97, valid=False, groups=0),
    "masked": dict(n=64, valid=True, groups=0),
    "grouped": dict(n=96, valid=True, groups=4),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_ranks_match_reference(case):
    c = RANK_CASES[case]
    rng = np.random.default_rng(c["n"])
    obj = _objectives(c["n"], c["n"])
    valid = rng.random(c["n"]) < 0.8 if c["valid"] else None
    groups = (np.repeat(np.arange(c["groups"]), c["n"] // c["groups"])
              .astype(np.int32) if c["groups"] else None)
    j = [None if a is None else jnp.asarray(a) for a in (valid, groups)]
    expect = np.asarray(jax.jit(jnsga2.nondominated_ranks)(jnp.asarray(obj),
                                                           *j))
    t = [None if a is None else _t(a) for a in (valid, groups)]
    got = nsga2.nondominated_ranks(_t(obj), *t)
    np.testing.assert_array_equal(got.numpy(), expect)
    if groups is None:
        np.testing.assert_array_equal(
            nsga2.nondominated_ranks_peel(_t(obj), t[0]).numpy(), expect)


def test_one_pairwise_pass_per_ranking():
    obj = _t(_objectives(1, 128))
    ops.reset_pairwise_pass_count()
    ranks = nsga2.nondominated_ranks(obj)
    assert ops.pairwise_pass_count() == 1
    n_fronts = int(ranks.max()) + 1
    assert n_fronts > 3
    ops.reset_pairwise_pass_count()
    nsga2.nondominated_ranks_peel(obj)
    assert ops.pairwise_pass_count() == n_fronts


def _assert_crowding_equal(got, expect):
    inf = np.isinf(expect)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_allclose(got[~inf], expect[~inf], rtol=1e-6)


@pytest.mark.parametrize("grouped", [False, True])
def test_crowding_matches_reference(grouped):
    rng = np.random.default_rng(7)
    obj = (rng.random((60, 3)) * 10).astype(np.float32)
    obj[5] = obj[6]                                # a duplicate pair
    valid = rng.random(60) < 0.9
    groups = np.repeat(np.arange(3), 20).astype(np.int32) if grouped \
        else None
    jg = None if groups is None else jnp.asarray(groups)
    jranks = jax.jit(jnsga2.nondominated_ranks)(
        jnp.asarray(obj), jnp.asarray(valid), groups=jg)
    expect = np.asarray(jax.jit(jnsga2.crowding_distance, static_argnums=3)(
        jnp.asarray(obj), jranks, jg, 3))
    got = nsga2.crowding_distance(
        _t(obj), _t(jranks), None if groups is None else _t(groups),
        n_groups=3).numpy()
    _assert_crowding_equal(got, expect)
    key_expect = np.asarray(jnsga2.truncation_key(
        jranks, jnp.asarray(expect), jnp.asarray(valid)))
    key_got = nsga2.truncation_key(_t(jranks), _t(got), _t(valid)).numpy()
    np.testing.assert_array_equal(np.argsort(key_got, kind="stable"),
                                  np.argsort(key_expect, kind="stable"))


def test_lexsort_matches_jnp():
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, 4, 50) for _ in range(3)]
    np.testing.assert_array_equal(
        nsga2.lexsort([_t(k) for k in keys]).numpy(),
        np.asarray(jnp.lexsort([jnp.asarray(k) for k in keys])))


def _jax_offspring_draws(key, n, lam, d, cfg):
    """The draws of repro.evolution.nsga2.make_offspring, replayed along
    its split tree."""
    k_t1, k_t2, k_x, k_m, k_re, k_pick = jax.random.split(key, 6)

    def pair(k, p):
        k_u, k_b = jax.random.split(k)
        return (jax.random.uniform(k_u, (1, d))[0],
                jax.random.bernoulli(k_b, p, (1, d))[0])

    u_sbx, swap = jax.vmap(lambda k: pair(k, 0.5))(jax.random.split(k_x, lam))
    u_mut, mutate = jax.vmap(lambda k: pair(k, cfg.mut_p))(
        jax.random.split(k_m, lam))
    draws = dict(
        cand1=jax.random.randint(k_t1, (lam, 2), 0, n),
        cand2=jax.random.randint(k_t2, (lam, 2), 0, n),
        u_sbx=u_sbx, swap=swap, u_mut=u_mut, mutate=mutate,
        reeval=jax.random.bernoulli(k_re, cfg.reevaluate, (lam,)),
        src=jax.random.randint(k_pick, (lam,), 0, n))
    return draws


def test_make_offspring_with_reference_draws():
    n, lam = 24, 32
    kw = dict(mu=n, genome_dim=2, bounds=BOUNDS, reevaluate=0.3)
    jcfg, tcfg = jnsga2.NSGA2Config(**kw), nsga2.NSGA2Config(**kw)
    rng = np.random.default_rng(11)
    genomes = (rng.random((n, 2)) * 99).astype(np.float32)
    obj = _objectives(12, n)
    jranks = jax.jit(jnsga2.nondominated_ranks)(jnp.asarray(obj))
    jcrowd = jax.jit(jnsga2.crowding_distance)(jnp.asarray(obj), jranks)
    key = jax.random.key(5)
    expect, ereeval = jax.jit(
        lambda k, g, r, c: jnsga2.make_offspring(jcfg, k, g, r, c, lam))(
            key, jnp.asarray(genomes), jranks, jcrowd)
    draws = jax.jit(lambda k: _jax_offspring_draws(k, n, lam, 2, jcfg))(key)
    draws = nsga2.OffspringDraws(**{
        k: _t(v).to(torch.int64) if k in ("cand1", "cand2", "src")
        else _t(v) for k, v in draws.items()})
    got, reeval = nsga2.apply_offspring(tcfg, draws, _t(genomes), _t(jranks),
                                        _t(jcrowd))
    np.testing.assert_array_equal(reeval.numpy(), np.asarray(ereeval))
    assert reeval.any() and not reeval.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-6)


def test_offspring_draws_stay_in_bounds():
    cfg = nsga2.NSGA2Config(mu=16, genome_dim=2, bounds=BOUNDS)
    gen = torch.Generator().manual_seed(0)
    genomes = torch.rand((3, 16, 2), generator=gen) * 99
    ranks = torch.zeros((3, 16), dtype=torch.int32)
    children, reeval = nsga2.make_offspring(cfg, gen, genomes, ranks,
                                            torch.ones((3, 16)), 20)
    assert children.shape == (3, 20, 2) and reeval.shape == (3, 20)
    assert (children >= 0).all() and (children <= 99).all()
    lo, hi = cfg.lo(), cfg.hi()
    picks = nsga2.tournament(gen, ranks[0], torch.ones(16), 50)
    assert picks.shape == (50,) and picks.min() >= 0 and picks.max() < 16
    x = nsga2.sbx_crossover(gen, genomes[0], genomes[1], lo, hi, 15.0)
    x = nsga2.polynomial_mutation(gen, x, lo, hi, 20.0, 1.0)
    assert (x >= 0).all() and (x <= 99).all() and not torch.equal(
        x, genomes[0])


def test_select_mu_matches_reference():
    p, mu = 32, 16
    kw = dict(mu=mu, genome_dim=2, bounds=BOUNDS)
    rng = np.random.default_rng(4)
    genomes = (rng.random((p, 2)) * 99).astype(np.float32)
    obj = _objectives(4, p)
    valid = rng.random(p) < 0.85
    eidx, eranks, ecrowd = jax.jit(functools.partial(
        jnsga2.select_mu, jnsga2.NSGA2Config(**kw)))(
            jnp.asarray(genomes), jnp.asarray(obj), jnp.asarray(valid))
    idx, ranks, crowd = nsga2.select_mu(nsga2.NSGA2Config(**kw),
                                        _t(genomes), _t(obj), _t(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(eidx))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(eranks))
    _assert_crowding_equal(crowd.numpy(), np.asarray(ecrowd))


def test_grouped_select_mu_equals_per_island():
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    rng = np.random.default_rng(9)
    genomes = _t((rng.random((3, 20, 2)) * 99).astype(np.float32))
    obj = _t(_objectives(9, 60).reshape(3, 20, 3))
    valid = _t(rng.random((3, 20)) < 0.9)
    idx, ranks, _ = nsga2.select_mu(cfg, genomes, obj, valid)
    for i in range(3):
        i_idx, i_ranks, _ = nsga2.select_mu(cfg, genomes[i], obj[i],
                                            valid[i])
        assert torch.equal(idx[i], i_idx) and torch.equal(ranks[i], i_ranks)


def test_archive_merge_matches_reference():
    rng = np.random.default_rng(13)
    a, k = 16, 20
    arc_g = (rng.random((a, 2)) * 99).astype(np.float32)
    arc_o = _objectives(13, a)
    arc_v = np.arange(a) < 10
    arc_o[~arc_v] = jnsga2.BIG
    inc_g = (rng.random((k, 2)) * 99).astype(np.float32)
    inc_o = _objectives(14, k)
    inc_v = rng.random(k) < 0.9
    expect = jax.jit(jarchive.merge)(
        jarchive.Archive(jnp.asarray(arc_g), jnp.asarray(arc_o),
                         jnp.asarray(arc_v)),
        jnp.asarray(inc_g), jnp.asarray(inc_o), jnp.asarray(inc_v))
    got = archive.merge(archive.Archive(_t(arc_g), _t(arc_o), _t(arc_v)),
                        _t(inc_g), _t(inc_o), _t(inc_v))
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    front = archive.pareto_front(got).numpy()
    np.testing.assert_array_equal(
        front, np.asarray(jax.jit(jarchive.pareto_front)(expect)))


def test_reseed_matches_reference():
    n_i, mu, a = 3, 8, 12
    kw = dict(mu=mu, genome_dim=2, bounds=BOUNDS)
    jcfg = jnsga2.NSGA2Config(**kw)
    rng = np.random.default_rng(17)
    islands = jax.vmap(lambda k: jga.init_state(jcfg, k))(
        jax.random.split(jax.random.key(3), n_i))
    islands = islands._replace(
        objectives=jnp.asarray(_objectives(17, n_i * mu).reshape(n_i, mu, 3)),
        valid=jnp.ones((n_i, mu), bool))
    arc = jarchive.Archive(
        jnp.asarray((rng.random((a, 2)) * 99).astype(np.float32)),
        jnp.asarray(_objectives(18, a)), jnp.asarray(rng.random(a) < 0.6))
    reseed_frac = 0.5
    expect = jax.jit(jisland.make_reseed(jcfg, reseed_frac=reseed_frac))(
        islands, arc)
    # the reference's draw: per island, split its key and pick n_replace
    n_replace = max(int(mu * reseed_frac), 1)
    k_seed = jax.vmap(jax.random.split)(islands.rng)[:, 1]
    pick = jax.jit(jax.vmap(
        lambda k: jax.random.randint(k, (n_replace,), 0, a)))(k_seed)
    t_islands = ga.GAState(_t(islands.genomes), _t(islands.objectives),
                           _t(islands.valid), _t(islands.generation),
                           _t(islands.evaluations))
    got = island.reseed_apply(t_islands, archive.Archive(*map(_t, arc)),
                              _t(pick).to(torch.int64))
    for name in ("genomes", "objectives", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(expect, name)))
