"""The port's surrogate engine on the CPU against the JAX package's, on the
same numpy inputs: Sobol design, GP fit and posteriors, batch acquisition
with the reference's normals replayed, the OSPREY fantasy re-score, the
archive-scale inducing fit, the ask/tell loop teacher-forced round by round,
and the ants objective with the reference's Gumbel stream. Then, within the
port: fault injection, checkpoint resume and the CLI.

Where the JAX side would reach a Pallas kernel (``kops.gp_sqdist``,
``kops.tri_solve``) it runs through its own routing on the CPU, as the JAX
package's tests run it; the port takes its plain versions.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ants_netlogo import CONFIG as J_CONFIG  # noqa: E402
from repro.configs.ants_netlogo import REDUCED as J_REDUCED  # noqa: E402
from repro.explore import bigfit as jbig  # noqa: E402
from repro.explore import surrogate as jsur  # noqa: E402
from repro.explore.sampling import _sobol_points as j_sobol  # noqa: E402
from repro.launch import explore as jexplore  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.ants import model  # noqa: E402
from repro_torch.configs.ants_netlogo import CONFIG, REDUCED  # noqa: E402
from repro_torch.explore import bigfit as tbig  # noqa: E402
from repro_torch.explore import surrogate as tsur  # noqa: E402
from repro_torch.explore.sampling import _sobol_points as t_sobol  # noqa: E402
from repro_torch.launch import explore  # noqa: E402

UNIT2 = ((0.0, 1.0), (0.0, 1.0))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def objective(x, xp=np):
    """The archive benchmark's synthetic objective (one minimum near
    (0.3, 0.7) with a ripple) on f32 rows; ``xp`` is numpy or jax.numpy."""
    return (x[:, 0] - 0.3) ** 2 + (x[:, 1] - 0.7) ** 2 \
        + 0.01 * xp.sin(17 * x[:, 0])


def _history(n, d=2, seed=0):
    """A seeded history of a rough objective: the marginal likelihood picks
    a short lengthscale, so the fitted matrices stay well conditioned and
    the comparisons below measure the port, not f32 conditioning."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    y = np.sin(9 * x[:, 0]) * np.cos(7 * x[:, 1]) + 0.3 * x[:, -1]
    return x, y.astype(np.float32)


def _cfgs(**kw):
    kw.setdefault("bounds", UNIT2)
    return jsur.SurrogateConfig(**kw), tsur.SurrogateConfig(**kw)


def _reference_draws(cfg, round_):
    """The starts and slot normals the reference's ``propose_batch`` draws
    in round ``round_``, as torch tensors."""
    key = jax.random.fold_in(jax.random.key(cfg.seed), round_)
    starts = jax.random.uniform(jax.random.fold_in(key, 0),
                                (cfg.n_starts, cfg.q, cfg.dim), jnp.float32)
    normals = jsur._slot_normals(jax.random.fold_in(key, 1), cfg.q,
                                 cfg.mc_samples)
    return _t(starts), _t(normals)


# ---------------------------------------------------------------------------
# design and GP core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,seed", [(16, 2, 0), (24, 5, 3), (7, 1, 11)])
def test_sobol_points_equal_the_reference(n, d, seed):
    np.testing.assert_array_equal(t_sobol(n, d, seed), j_sobol(n, d, seed))


# The lengthscale is an argmin over a 5-point grid: equal. The factor's
# entries are at most ~1 and each side factors in its own schedule: for
# Matérn-5/2 they agree to 1e-4, and so do the posteriors. The RBF matrix
# is far worse conditioned at the same lengthscale (noise 1e-4), and f32
# rounding grows to ~5e-4 there: 1e-3. alpha solves against that matrix,
# so it agrees to 1e-2 of its largest entry; the posterior mean built from
# it, which is what the engine uses, to the tolerance above.
GP_ATOL = {"matern52": 1e-4, "rbf": 1e-3}


@pytest.mark.parametrize("kernel", ["matern52", "rbf"])
@pytest.mark.parametrize("n,d", [(40, 2), (47, 5)])
def test_gp_fit_and_posterior_match_the_reference(kernel, n, d):
    jcfg, tcfg = _cfgs(bounds=((0.0, 1.0),) * d, kernel=kernel)
    x, y = _history(n, d)
    js = jsur.gp_fit(jcfg, jnp.asarray(x), jnp.asarray(y))
    ts = tsur.gp_fit(tcfg, _t(x), _t(y))
    assert float(ts.lengthscale) == float(js.lengthscale)
    atol = GP_ATOL[kernel]
    np.testing.assert_allclose(ts.chol.numpy(), _np(js.chol), atol=atol)
    alpha = _np(js.alpha)
    np.testing.assert_allclose(ts.alpha.numpy(), alpha,
                               atol=1e-2 * np.abs(alpha).max())
    for f in ("y_mean", "y_std", "best"):
        np.testing.assert_allclose(float(getattr(ts, f)),
                                   float(getattr(js, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    xq = np.random.default_rng(1).random((6, d)).astype(np.float32)
    jm, jc = jsur.gp_posterior(jcfg, js, jnp.asarray(xq))
    tm, tc = tsur.gp_posterior(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=atol)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=atol)
    jm, jv = jsur.gp_mean_var(jcfg, js, jnp.asarray(xq))
    tm, tv = tsur.gp_mean_var(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=atol)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=atol)
    # the diagonal of the joint covariance is the marginal variance
    np.testing.assert_allclose(torch.diagonal(tc).numpy(),
                               tv.numpy(), atol=1e-5)


def test_gp_state_from_the_reference_gives_its_posterior():
    """A JAX GPState carried into the port: the same posterior (the same
    factor, f32 solves and products in another order: 1e-5)."""
    jcfg, tcfg = _cfgs()
    x, y = _history(30)
    js = jsur.gp_fit(jcfg, jnp.asarray(x), jnp.asarray(y))
    ts = tsur.gp_state_from_arrays(jax.tree.map(np.asarray, js), "cpu")
    xq = np.random.default_rng(2).random((5, 2)).astype(np.float32)
    jm, jc = jsur.gp_posterior(jcfg, js, jnp.asarray(xq))
    tm, tc = tsur.gp_posterior(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-5)


# ---------------------------------------------------------------------------
# batch acquisition
# ---------------------------------------------------------------------------
def _random_mvn(seed, q):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((q, q)).astype(np.float32)
    return (rng.standard_normal(q).astype(np.float32),
            (a @ a.T / q + 0.1 * np.eye(q)).astype(np.float32))


# Monte-Carlo means over the same 96 normals: the port's batch Cholesky
# and sample sums run in a fixed column order, the reference's through
# LAPACK and a matmul, so the values agree to f32 rounding (1e-5).
@pytest.mark.parametrize("q", [1, 3, 8])
def test_q_ei_and_q_ucb_with_the_reference_normals(q):
    mean, cov = _random_mvn(q, q)
    key = jax.random.key(7)
    normals = _t(jsur._slot_normals(key, q, 96))
    j_ei = float(jsur.q_ei(jnp.asarray(mean), jnp.asarray(cov), 0.3,
                           key=key, n_samples=96, jitter=1e-5))
    t_ei = float(tsur.q_ei(_t(mean), _t(cov), 0.3, normals, jitter=1e-5))
    np.testing.assert_allclose(t_ei, j_ei, rtol=1e-5, atol=1e-6)
    j_ucb = float(jsur.q_ucb(jnp.asarray(mean), jnp.asarray(cov), 2.0,
                             key=key, n_samples=96, jitter=1e-5))
    t_ucb = float(tsur.q_ucb(_t(mean), _t(cov), 2.0, normals, jitter=1e-5))
    np.testing.assert_allclose(t_ucb, j_ucb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qei_monotone_in_q(seed):
    """Nested batches share their slots' normals and the leading block of
    the batch Cholesky, so q-EI never drops as a point is added: exactly."""
    mean, cov = _random_mvn(seed + 20, 6)
    _, normals = tsur.draw_proposal_noise(
        tsur.SurrogateConfig(bounds=UNIT2, q=6, mc_samples=64, seed=seed), 3)
    vals = [float(tsur.q_ei(_t(mean[:q]), _t(cov[:q, :q]), 0.5,
                            normals[:, :q])) for q in range(1, 7)]
    assert all(b >= a for a, b in zip(vals, vals[1:])), vals
    assert all(v >= 0.0 for v in vals)


def test_draws_keep_slot_columns_across_batch_sizes():
    """Column i of the normals depends on (seed, round, slot i) only."""
    a = tsur.draw_proposal_noise(tsur.SurrogateConfig(bounds=UNIT2, q=3), 2)
    b = tsur.draw_proposal_noise(tsur.SurrogateConfig(bounds=UNIT2, q=5), 2)
    assert torch.equal(a[1], b[1][:, :3])
    c = tsur.draw_proposal_noise(tsur.SurrogateConfig(bounds=UNIT2, q=3), 3)
    assert not torch.equal(a[1], c[1])


def test_failed_cholesky_gives_nan_like_the_reference():
    bad = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])
    got = tsur.cholesky_or_nan(bad)
    assert torch.isnan(got[0]).all()
    assert torch.equal(got[1], torch.linalg.cholesky(bad[1]))
    assert torch.isnan(tsur._batch_chol(bad[:1], 0.0)).all()


# The ascent repeats the reference's: each start climbs along its own
# normalized gradient and the best start wins. Fed the reference's
# starts and normals, the batch agrees to 1e-4 (the gradients differ in
# f32 rounding only; 24 steps of 0.08 along unit directions).
def test_propose_batch_with_the_reference_draws():
    jcfg, tcfg = _cfgs(q=4)
    x, y = _history(40)
    js = jsur.gp_fit(jcfg, jnp.asarray(x), jnp.asarray(y))
    ts = tsur.gp_fit(tcfg, _t(x), _t(y))
    key = jax.random.fold_in(jax.random.key(0), 5)
    jb, jv = jax.jit(lambda s, k: jsur.propose_batch(jcfg, s, k))(js, key)
    starts, normals = _reference_draws(jcfg, 5)
    tb, tv = tsur.propose_batch(tcfg, ts, starts, normals)
    np.testing.assert_allclose(tb.numpy(), _np(jb), atol=1e-4)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-3, atol=1e-5)


# EI of the pending points under the history factor extended with the
# landed rows: f32 solves against a bordered factor, 1e-3 of the largest.
@pytest.mark.parametrize("landed", [1, 3])
def test_fantasy_scores_match_the_reference(landed):
    jcfg, tcfg = _cfgs(q=4)
    x, y = _history(24)
    js = jsur.gp_fit(jcfg, jnp.asarray(x), jnp.asarray(y))
    rng = np.random.default_rng(landed)
    xn = rng.random((4, 2)).astype(np.float32)
    yn = objective(xn)
    mn = (np.arange(4) < landed).astype(np.float32)
    xp = rng.random((4, 2)).astype(np.float32)
    expect = _np(jsur._fantasy_scores(
        jcfg, js.chol, jnp.asarray(x), jnp.asarray(y), js.lengthscale,
        jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(mn), jnp.asarray(xp)))
    got = tsur._fantasy_scores(
        tcfg, _t(js.chol), _t(x), _t(y), _t(js.lengthscale), _t(xn), _t(yn),
        _t(mn), _t(xp)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-3 * np.abs(expect).max())


# ---------------------------------------------------------------------------
# archive scale: the inducing-point path
# ---------------------------------------------------------------------------
# Small archive: n = 300 past n_max_exact = 128, m = 64 inducing points.
# The (m, n) solve runs through each side's blocked triangular solve, then
# both sum A A^T over n = 300 in their own orders: the statistics agree to
# 1e-3 of their largest entry. The posteriors (what the engine uses) solve
# twice against L_m, whose K_mm carries only 10x jitter: 5e-4.
BIG = dict(n_max_exact=128, n_inducing=64)


@pytest.fixture(scope="module")
def inducing_pair():
    jcfg, tcfg = _cfgs(**BIG)
    x, y = _history(300, seed=4)
    js = jsur.gp_fit(jcfg, jnp.asarray(x), jnp.asarray(y))
    ts = tsur.gp_fit(tcfg, _t(x), _t(y))
    assert isinstance(js, jbig.InducingGPState)
    assert isinstance(ts, tbig.InducingGPState)
    return jcfg, tcfg, js, ts


def _close_states(ts, js, rel=1e-3):
    for f in ("z", "l_m", "aat", "ay", "a1", "count", "y_sum", "y_sq",
              "y_min", "y_mean", "y_std", "lengthscale", "best"):
        a = _np(getattr(js, f))
        np.testing.assert_allclose(getattr(ts, f).numpy(), a,
                                   atol=rel * max(np.abs(a).max(), 1.0),
                                   err_msg=f)


def _close_posteriors(jcfg, tcfg, js, ts, seed):
    xq = np.random.default_rng(seed).random((5, 2)).astype(np.float32)
    jm, jc = jsur.gp_posterior(jcfg, js, jnp.asarray(xq))
    tm, tc = tsur.gp_posterior(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=5e-4)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=5e-4)
    jm, jv = jsur.gp_mean_var(jcfg, js, jnp.asarray(xq))
    tm, tv = tsur.gp_mean_var(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=5e-4)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=5e-4)


def test_fit_inducing_matches_the_reference(inducing_pair):
    jcfg, tcfg, js, ts = inducing_pair
    _close_states(ts, js)
    _close_posteriors(jcfg, tcfg, js, ts, 5)


def test_update_inducing_matches_the_reference(inducing_pair):
    jcfg, tcfg, js, ts = inducing_pair
    xn = np.random.default_rng(6).random((4, 2)).astype(np.float32)
    yn = objective(xn)
    mask = np.array([1, 1, 0, 1], np.float32)
    j2 = jbig.update_inducing(jcfg, js, jnp.asarray(xn), jnp.asarray(yn),
                              jnp.asarray(mask))
    t2 = tbig.update_inducing(tcfg, ts, _t(xn), _t(yn), _t(mask))
    assert float(t2.count) == float(ts.count) + 3
    _close_states(t2, j2)
    _close_posteriors(jcfg, tcfg, j2, t2, 7)


def test_inducing_state_from_the_reference_gives_its_posterior(
        inducing_pair):
    jcfg, tcfg, js, _ = inducing_pair
    ts = tbig.inducing_state_from_arrays(jax.tree.map(np.asarray, js), "cpu")
    xq = np.random.default_rng(8).random((5, 2)).astype(np.float32)
    jm, jc = jbig.posterior_inducing(jcfg, js, jnp.asarray(xq))
    tm, tc = tbig.posterior_inducing(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-5)


def test_big_method_ensemble_is_not_ported_yet():
    """The ensemble is ported now (tests/test_torch_moacq.py holds it to the
    reference): past n_max_exact, gp_fit routes to it and its posterior is
    finite."""
    _, tcfg = _cfgs(big_method="ensemble", expert_size=64, **BIG)
    x, y = _history(200)
    st = tsur.gp_fit(tcfg, _t(x), _t(y))
    assert isinstance(st, tbig.EnsembleGPState) and st.x.shape == (4, 64, 2)
    mean, var = tsur.gp_mean_var(tcfg, st, _t(x[:5]))
    assert torch.isfinite(mean).all() and (var > 0).all()


def test_archive_explorer_asks_in_the_unit_cube_and_tells_incrementally():
    """Past n_max_exact the explorer keeps its inducing state across
    rounds (cold fit once, then incremental tells)."""
    _, tcfg = _cfgs(q=4, **BIG)
    x, y = _history(300, seed=9)
    ex = tsur.SurrogateExplorer(tcfg, device="cpu")
    ex.load_state_arrays({"x01": x, "y": y, "round": np.int32(75)})
    xq = ex.ask()
    assert xq.shape == (4, 2) and ((xq >= 0) & (xq <= 1)).all()
    cold = ex._big_state
    ex.tell(xq, objective(xq))
    assert float(ex._big_state.count) == 304.0
    assert ex._big_state.z is cold.z
    xq2 = ex.ask()
    assert np.isfinite(xq2).all() and ex.last_state is ex._big_state


# ---------------------------------------------------------------------------
# the slice as a whole: ask/tell rounds against the reference
# ---------------------------------------------------------------------------
ROUNDS = 4


@pytest.fixture(scope="module")
def reference_surrogate():
    jcfg, tcfg = _cfgs(q=4, n_init=8)
    res = jsur.run_surrogate(
        jcfg, lambda keys, g: objective(g, jnp),
        rounds=ROUNDS)
    return jcfg, tcfg, res


def _ask_from(tcfg, x01, y, round_, monkeypatch):
    monkeypatch.setattr(tsur, "draw_proposal_noise", _reference_draws)
    ex = tsur.SurrogateExplorer(tcfg, device="cpu")
    ex.load_state_arrays({"x01": x01, "y": y, "round": np.int32(round_)})
    return ex.ask()


# Teacher-forced: every round r of the port starts from the reference's
# history of rounds < r, with the reference's starts and normals, so one
# near-tie cannot compound over rounds. Sobol rounds are equal. In GP
# rounds each of the 24 ascent steps moves 0.08 along the normalized
# gradient, and where q-EI is flat f32 rounding turns that direction a
# little: the starts end up to ~7e-3 apart (unit cube), so the batches
# agree to 1e-2. Several points can share an EI priority of ~0, so the
# priority order of near-ties is free: the batches are compared as sets.
BATCH_ATOL = 1e-2


def _same_batch(got, expect, what):
    dist = np.abs(got[:, None, :] - expect[None, :, :]).max(-1)
    match = dist.argmin(0)
    assert sorted(match) == list(range(len(expect))), (what, got, expect)
    assert dist[match, np.arange(len(expect))].max() <= BATCH_ATOL, \
        (what, got, expect)


def test_run_surrogate_rounds_match_the_reference(reference_surrogate,
                                                  monkeypatch):
    jcfg, tcfg, res = reference_surrogate
    q = tcfg.q
    x01 = np.asarray(res.genomes, np.float32)
    y = np.asarray(res.objectives, np.float32)
    for r in range(ROUNDS):
        got = _ask_from(tcfg, x01[:r * q], y[:r * q], r, monkeypatch)
        expect = x01[r * q:(r + 1) * q]
        if r * q < tcfg.n_init_padded:
            np.testing.assert_array_equal(got, expect)
        else:
            _same_batch(got, expect, f"round {r}")


def test_port_run_surrogate_rounds_match_the_reference_asks(
        reference_surrogate, monkeypatch):
    """The other direction: the port's own run_surrogate (the reference's
    draws), and the reference's ask from the port's history each round."""
    jcfg, tcfg, jres = reference_surrogate
    monkeypatch.setattr(tsur, "draw_proposal_noise", _reference_draws)
    res = tsur.run_surrogate(
        tcfg, lambda gen, g: torch.from_numpy(objective(g.numpy())),
        rounds=ROUNDS, device="cpu")
    assert res.rounds_done == ROUNDS and not res.interrupted
    q = tcfg.q
    for r in range(ROUNDS):
        jex = jsur.SurrogateExplorer(jcfg)
        jex.load_state_arrays({"x01": res.genomes[:r * q].astype(np.float32),
                               "y": res.objectives[:r * q],
                               "round": np.int32(r)})
        _same_batch(res.genomes[r * q:(r + 1) * q], jex.ask(), f"round {r}")


def test_reference_history_resumes_in_the_port(reference_surrogate,
                                               monkeypatch):
    """The reference explorer's ``state_arrays`` load into the port, whose
    next ask is the reference's (as above)."""
    jcfg, tcfg, _ = reference_surrogate
    jex = jsur.SurrogateExplorer(jcfg)
    for _ in range(3):
        xq = jex.ask()
        jex.tell(xq, objective(xq))
    tree = jex.state_arrays()
    monkeypatch.setattr(tsur, "draw_proposal_noise", _reference_draws)
    tex = tsur.SurrogateExplorer(tcfg, device="cpu")
    tex.load_state_arrays(tree)
    assert tex.round == 3
    _same_batch(tex.ask(), jex.ask(), "round 3")
    # the posterior in raw units on the round's fitted state (as the
    # posterior tests: 1e-4 in standardized units, times y_std ~0.2)
    xq = np.random.default_rng(5).random((6, 2)).astype(np.float32)
    for got, expect in zip(tex.predict(xq), jex.predict(xq)):
        np.testing.assert_allclose(got, expect, atol=1e-4)


def _quadratic_eval(gen, g):
    # uses the job's own generator: a retried attempt must draw alike
    return torch.from_numpy(objective(g.numpy())) \
        + 1e-3 * torch.rand((g.shape[0],), generator=gen)


def test_pool_run_with_faults_is_bit_exact_with_the_clean_run(tmp_path):
    _, tcfg = _cfgs(q=4, n_init=8)
    clean = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=3,
                               device="cpu")
    pool = explore.make_init_pool(0.35)
    try:
        faulty = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=3,
                                    environment=pool, device="cpu")
        stats = list(pool.member_stats().values())
    finally:
        pool.shutdown()
    assert faulty.attempts > 12
    assert sum(s["failed"] for s in stats) > 0
    for s in stats:
        assert s["submitted"] == s["completed"] + s["failed"] + s["hung"] \
            + s["corrupted"]
    np.testing.assert_array_equal(faulty.genomes, clean.genomes)
    np.testing.assert_array_equal(faulty.objectives, clean.objectives)



@pytest.mark.parametrize("workers,capacity", [(1, 1), (2, 3)])
def test_pool_shape_does_not_change_the_run(workers, capacity):
    """The pool's shape changes where and when jobs run, never what the run
    asks or gets back."""
    _, tcfg = _cfgs(q=4, n_init=8)
    clean = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=3,
                               device="cpu")
    pool = explore.make_init_pool(0.0, workers=workers, capacity=capacity)
    try:
        pooled = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=3,
                                    environment=pool, device="cpu")
    finally:
        pool.shutdown()
    assert pooled.attempts == 12
    np.testing.assert_array_equal(pooled.genomes, clean.genomes)
    np.testing.assert_array_equal(pooled.objectives, clean.objectives)

def test_checkpoint_resume_is_bit_exact(tmp_path):
    _, tcfg = _cfgs(q=4, n_init=8)
    straight = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=4,
                                  device="cpu")
    ck = str(tmp_path / "ck")
    cut = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=4, device="cpu",
                             checkpoint_dir=ck, stop_after_rounds=3)
    assert cut.interrupted and cut.rounds_done == 3
    # the committed tree is the reference's {"x01", "y", "round"}
    like = {"x01": np.zeros((12, 2), np.float32),
            "y": np.zeros((12,), np.float32), "round": np.int32(0)}
    saved = checkpoint.restore(ck, 3, like)
    assert int(saved["round"]) == 3
    np.testing.assert_array_equal(saved["y"], straight.objectives[:12])
    resumed = tsur.run_surrogate(tcfg, _quadratic_eval, rounds=4,
                                 device="cpu", checkpoint_dir=ck)
    assert resumed.resumed_rounds == 3
    np.testing.assert_array_equal(resumed.genomes, straight.genomes)
    np.testing.assert_array_equal(resumed.objectives, straight.objectives)


def test_resume_with_other_settings_is_refused(tmp_path):
    _, tcfg = _cfgs(q=4, n_init=8)
    ck = str(tmp_path / "ck")
    tsur.run_surrogate(tcfg, _quadratic_eval, rounds=2, device="cpu",
                       checkpoint_dir=ck, settings=json.dumps({"a": 1}))
    with pytest.raises(ValueError, match="other settings.*differing: a"):
        tsur.run_surrogate(tcfg, _quadratic_eval, rounds=3, device="cpu",
                           checkpoint_dir=ck, settings=json.dumps({"a": 2}))


def test_service_mode_is_not_ported_yet():
    """The service mode is ported now (tests/test_torch_service.py); given
    both an environment and a service, run_surrogate raises, as the
    reference's does."""
    _, tcfg = _cfgs(q=4, n_init=8)
    with pytest.raises(ValueError, match="either environment= or service="):
        tsur.run_surrogate(tcfg, _quadratic_eval, rounds=1, device="cpu",
                           service=object(), environment=object())


def test_explorer_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsur.SurrogateExplorer(tsur.SurrogateConfig(bounds=UNIT2))


# ---------------------------------------------------------------------------
# the ants objective and the CLI
# ---------------------------------------------------------------------------
def _replayed_gumbel(keys, ticks, population):
    """The Gumbel draws the reference simulator makes from lane keys
    ``keys`` (as in tests/test_torch_ants.py)."""
    def body(rng, _):
        k = jax.vmap(jax.random.split)(rng)
        g = jax.vmap(lambda kk: jax.random.gumbel(kk, (population, 8)))(
            k[:, 1])
        return k[:, 0], g

    return jax.lax.scan(body, keys, None, length=ticks)[1]


def test_ants_scalar_eval_with_the_reference_gumbel_stream(monkeypatch):
    genomes = np.array([[30.0, 10.0], [75.0, 45.0]], np.float32)
    keys = jax.random.split(jax.random.key(3), 2)
    reps = 2
    expect = np.asarray(jax.jit(jexplore.ants_scalar_eval(True, reps))(
        keys, jnp.asarray(genomes)))
    flat_keys = jax.vmap(lambda k: jax.random.split(k, reps))(keys).reshape(
        len(genomes) * reps)
    noise = _t(jax.jit(_replayed_gumbel, static_argnums=(1, 2))(
        flat_keys, J_REDUCED.max_ticks, J_REDUCED.population))
    monkeypatch.setattr(
        explore, "simulate_batch",
        lambda cfg, d, e, generator: model.simulate_batch(cfg, d, e,
                                                          noise=noise))
    got = explore.ants_scalar_eval(True, reps)(None, _t(genomes)).numpy()
    np.testing.assert_array_equal(got, expect)
    assert (expect < REDUCED.max_ticks).any()



def test_ants_scalar_eval_at_config_with_the_reference_gumbel_stream(
        monkeypatch):
    """At the paper's model size (CONFIG), on the first four Sobol genomes
    of a default surrogate run, 3 replicates each: the port's ticks equal
    the reference's. Both return the 1000-tick cap for every genome: at
    CONFIG the nearest food source does not empty within the horizon, so a
    surrogate run there fits a constant objective in either package."""
    genomes = (t_sobol(16, 2, 0)[:4] * 99.0).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), len(genomes))
    reps = 3
    expect = np.asarray(jax.jit(jexplore.ants_scalar_eval(False, reps))(
        keys, jnp.asarray(genomes)))
    flat_keys = jax.vmap(lambda k: jax.random.split(k, reps))(keys).reshape(
        len(genomes) * reps)
    noise = _t(jax.jit(_replayed_gumbel, static_argnums=(1, 2))(
        flat_keys, J_CONFIG.max_ticks, J_CONFIG.population))
    monkeypatch.setattr(
        explore, "simulate_batch",
        lambda cfg, d, e, generator: model.simulate_batch(cfg, d, e,
                                                          noise=noise))
    got = explore.ants_scalar_eval(False, reps)(None, _t(genomes)).numpy()
    np.testing.assert_array_equal(got, expect)
    assert (expect == CONFIG.max_ticks).all()

CLI = ["--method", "surrogate", "--device", "cpu", "--reduced", "--q", "4",
       "--n-init", "4", "--replicates", "1"]


def test_cli_surrogate_writes_resumes_and_refuses_other_settings(tmp_path,
                                                                 capsys):
    out = str(tmp_path)
    explore.main(CLI + ["--rounds", "2", "--out", out])
    with open(tmp_path / "surrogate_result.json") as f:
        result = json.load(f)
    assert set(result) == {"best_genome", "best_objective", "genomes",
                           "objectives", "rounds", "attempts",
                           "repriorities", "fault_rate", "wall_s"}
    assert result["rounds"] == 2 and len(result["objectives"]) == 8
    with open(tmp_path / "provenance.json") as f:
        prov = json.load(f)
    modes = [t["mode"] for t in prov["tasks"]]
    assert modes == ["surrogate"] * 8
    assert all(len(t["inputs_digest"]) == 64 for t in prov["tasks"])
    explore.main(CLI + ["--rounds", "3", "--out", out])
    with open(tmp_path / "surrogate_result.json") as f:
        again = json.load(f)
    assert again["rounds"] == 3
    assert again["objectives"][:8] == result["objectives"]
    assert "2 rounds resumed" in capsys.readouterr().out
    with pytest.raises(ValueError, match="other settings"):
        explore.main(["--method", "surrogate", "--device", "cpu", "--q", "4",
                      "--n-init", "4", "--replicates", "2", "--reduced",
                      "--rounds", "4", "--out", out])


def test_cli_surrogate_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.main(["--method", "surrogate", "--reduced", "--out",
                      str(tmp_path)])
