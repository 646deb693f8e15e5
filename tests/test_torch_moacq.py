"""The port's multi-objective surrogate (``explore/moacq.py``) and local-GP
ensemble (``explore/bigfit.py``) on the CPU against the JAX package's, on
the same numpy inputs: the kd partition, the ensemble's fit and posteriors,
the qEHVI selection and the hypervolume estimate with the reference's box
samples and normals replayed, the candidate pool with its offspring draws
replayed, an explorer told the reference's history; then, within the port,
resume and fault-injection determinism of ``run_surrogate_mo`` and the
``--method surrogate-mo`` CLI.

Where the JAX side would reach a Pallas kernel (``kops.gp_sqdist``) it runs
through its own routing on the CPU, as the JAX package's tests run it; the
port takes its plain versions.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.evolution import archive as jarchive  # noqa: E402
from repro.evolution import nsga2 as jnsga2  # noqa: E402
from repro.explore import bigfit as jbig  # noqa: E402
from repro.explore import moacq as jmo  # noqa: E402
from repro.explore import surrogate as jsur  # noqa: E402
from repro_torch.evolution import nsga2  # noqa: E402
from repro_torch.explore import bigfit as tbig  # noqa: E402
from repro_torch.explore import moacq as tmo  # noqa: E402
from repro_torch.explore import surrogate as tsur  # noqa: E402
from repro_torch.launch import explore  # noqa: E402

from test_torch_selection import _jax_offspring_draws  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _history(n, d=2, seed=0):
    """A seeded history of a rough objective (short fitted lengthscale, well
    conditioned cells)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    y = np.sin(9 * x[:, 0]) * np.cos(7 * x[:, 1]) + 0.3 * x[:, -1]
    return x, y.astype(np.float32)


def mo_objectives(x):
    """Three conflicting objectives of a unit-square genome, with a ripple
    so the GPs fit non-constant surfaces (f32 rows)."""
    f1 = x[:, 0] ** 2 + (x[:, 1] - 1.0) ** 2
    f2 = (x[:, 0] - 1.0) ** 2 + x[:, 1] ** 2
    f3 = (x[:, 0] - 0.5) ** 2 + 0.2 * np.sin(7 * x[:, 1])
    return np.stack([f1, f2, f3], 1).astype(np.float32)


def _scfgs(**kw):
    kw.setdefault("bounds", ((0.0, 1.0), (0.0, 1.0)))
    return jsur.SurrogateConfig(**kw), tsur.SurrogateConfig(**kw)


def _mocfgs(**kw):
    base = dict(bounds=((0.0, 1.0), (0.0, 1.0)), n_objectives=3, q=4,
                n_init=8, mc_samples=16, hv_samples=64, pool_size=16,
                archive_size=16, lengthscales=(0.1, 0.2, 0.4), seed=3)
    base.update(kw)
    return jmo.MOSurrogateConfig(**base), tmo.MOSurrogateConfig(**base)


# ---------------------------------------------------------------------------
# the local-GP ensemble
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_valid,levels", [(200, 3), (37, 2), (64, 0)])
def test_kd_order_equals_the_reference(n_valid, levels):
    """Integer output: the permutation is equal. The coordinates come from a
    grid of 7 values, so the medians split through ties, which both stable
    sorts keep in index order."""
    n_p = 64 if levels == 0 else 2 ** levels * 32
    rng = np.random.default_rng(n_valid)
    x = (rng.integers(0, 7, (n_p, 3)) / 7).astype(np.float32)
    valid = (np.arange(n_p) < min(n_valid, n_p)).astype(np.float32)
    rng.shuffle(valid)
    expect = np.asarray(jbig._kd_order(jnp.asarray(x), jnp.asarray(valid),
                                       levels))
    got = tbig._kd_order(_t(x), _t(valid), levels).numpy()
    np.testing.assert_array_equal(got, expect)


# The ensemble's cells factor 64- to 128-row Matérn matrices, each side in
# its own LAPACK schedule; under jit XLA also contracts the reference's
# distance products into FMAs, where the port's are exact (the same
# difference as gp_chol's, ROADMAP C). The factors' trailing entries then
# differ by up to ~7e-4 (CHOL_ATOL 1e-3); the posteriors built from them
# agree to 2e-4 (absolute, standardized units, whose scale is 1).
CHOL_ATOL = 1e-3
ENS_ATOL = 2e-4


@pytest.mark.parametrize("n,expert,k", [(300, 64, 3), (100, 128, 1)])
def test_fit_ensemble_and_posteriors_match_the_reference(n, expert, k):
    """Multi-expert (300 points in 8 cells of 64, 3 merged) and one expert
    (100 points in one cell of 128)."""
    jcfg, tcfg = _scfgs(n_max_exact=32, big_method="ensemble",
                        expert_size=expert, n_experts_predict=k)
    x, y = _history(n, seed=n)
    # the reference's functions jitted, as its explorer runs them
    js = jax.jit(functools.partial(jsur.gp_fit, jcfg))(jnp.asarray(x),
                                                       jnp.asarray(y))
    ts = tsur.gp_fit(tcfg, _t(x), _t(y))
    assert isinstance(js, jbig.EnsembleGPState)
    assert isinstance(ts, tbig.EnsembleGPState)
    assert float(ts.lengthscale) == float(js.lengthscale)
    np.testing.assert_array_equal(ts.x.numpy(), _np(js.x))
    np.testing.assert_array_equal(ts.valid.numpy(), _np(js.valid))
    np.testing.assert_allclose(ts.centroid.numpy(), _np(js.centroid),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.chol.numpy(), _np(js.chol),
                               atol=CHOL_ATOL)
    for f in ("y_mean", "y_std", "best"):
        np.testing.assert_allclose(float(getattr(ts, f)),
                                   float(getattr(js, f)), rtol=1e-6)
    # the batch's nearest experts and the merged posteriors; xq near one
    # corner, so the batch centroid selects a strict subset of the experts
    xq = (np.random.default_rng(1).random((6, 2)) * 0.5).astype(np.float32)
    jm, jv = jax.jit(functools.partial(jsur.gp_mean_var, jcfg))(
        js, jnp.asarray(xq))
    tm, tv = tsur.gp_mean_var(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=ENS_ATOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ENS_ATOL)
    jm, jc = jax.jit(functools.partial(jsur.gp_posterior, jcfg))(
        js, jnp.asarray(xq))
    tm, tc = tsur.gp_posterior(tcfg, ts, _t(xq))
    np.testing.assert_allclose(tm.numpy(), _np(jm), atol=ENS_ATOL)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=ENS_ATOL)


def test_nearest_experts_order_ties_as_the_reference():
    """lax.top_k puts the lower index first among equal distances; the port
    selects the same experts in the same order."""
    _, tcfg = _scfgs(n_experts_predict=3)
    centroid = np.array([[0.5, 0.5], [0.0, 0.0], [1.0, 1.0], [0.5, 0.5],
                         [0.0, 1.0]], np.float32)
    z = torch.zeros(())
    state = tbig.EnsembleGPState(
        x=torch.zeros(5, 1, 2), valid=torch.ones(5, 1),
        chol=torch.ones(5, 1, 1), alpha=torch.zeros(5, 1),
        centroid=_t(centroid), y_mean=z, y_std=z + 1, lengthscale=z + 1,
        best=z)
    xq = _t([[0.5, 0.5], [0.5, 0.5]])
    d2 = ((jnp.asarray(centroid) - 0.5) ** 2).sum(-1)
    _, expect = jax.lax.top_k(-d2, 3)
    got = tbig._nearest_experts(tcfg, state, xq).numpy()
    np.testing.assert_array_equal(got, np.asarray(expect))
    assert got.tolist() == [0, 3, 1]


def test_single_expert_equals_the_exact_gp():
    """E = 1 is the dense GP: one cell holding every point, one expert."""
    _, tcfg = _scfgs(n_max_exact=4096, expert_size=64, n_experts_predict=1,
                     lengthscales=(0.2,))
    x, y = _history(48, seed=7)
    exact = tsur.gp_fit(tcfg, _t(x), _t(y))
    ens = tbig.fit_ensemble(tcfg, _t(x), _t(y),
                            lengthscale=float(exact.lengthscale))
    xq = _t(np.random.default_rng(3).random((10, 2)))
    em, ev = tsur.gp_mean_var(tcfg, exact, xq)
    gm, gv = tbig.mean_var_ensemble(tcfg, ens, xq)
    np.testing.assert_allclose(gm.numpy(), em.numpy(), atol=1e-4)
    np.testing.assert_allclose(gv.numpy(), ev.numpy(), atol=1e-4)


def test_ensemble_explorer_refits_and_rescoring_runs():
    """The archive-scale ensemble through SurrogateExplorer: the ask's state
    is an ensemble, a tell drops it (refit on the next ask), and the
    re-score scores under the round's posterior."""
    _, tcfg = _scfgs(q=4, n_max_exact=64, big_method="ensemble",
                     expert_size=32, n_starts=2, opt_steps=2,
                     mc_samples=16)
    x, y = _history(96, seed=2)
    ex = tsur.SurrogateExplorer(tcfg, device="cpu")
    ex.load_state_arrays({"x01": x, "y": y, "round": np.int32(24)})
    xq = ex.ask()
    assert isinstance(ex.last_state, tbig.EnsembleGPState)
    assert xq.shape == (4, 2) and ((xq >= 0) & (xq <= 1)).all()
    scores = ex.rescore(xq[:2], [0.1, 0.2], xq[2:])
    assert scores.shape == (2,) and np.isfinite(scores).all()
    ex.tell(xq, y[:4])
    assert ex._big_state is None


# ---------------------------------------------------------------------------
# qEHVI and the hypervolume estimate with the reference's draws replayed
# ---------------------------------------------------------------------------
def _qehvi_inputs(p, m, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(p, m)).astype(np.float32)
    var = (rng.random((p, m)) * 0.1 + 0.01).astype(np.float32)
    front = np.full((6, m), 1e30, np.float32)
    front[:3] = rng.normal(size=(3, m)).astype(np.float32) * 0.5
    return mu, var, front


def _qehvi_draws(jcfg, key, p, m):
    k_u, k_z = jax.random.split(jax.random.fold_in(key, 7))
    u = jax.random.uniform(k_u, (jcfg.hv_samples, m), jnp.float32)
    z = jax.random.normal(k_z, (p, jcfg.mc_samples, m), jnp.float32)
    return _t(u), _t(z)


@pytest.mark.parametrize("m,seed", [(2, 0), (3, 5)])
def test_qehvi_select_equals_the_reference_with_its_draws(m, seed):
    """Same inputs and draws: the picks are equal and the gains bitwise (the
    comparisons see the same f32 values on both sides; the +BIG rows pad the
    front)."""
    jcfg, tcfg = _mocfgs(q=5, n_objectives=m)
    p = 12
    mu, var, front = _qehvi_inputs(p, m, seed)
    key = jax.random.key(seed + 11)
    jp, jg = jmo.qehvi_select(jcfg, jnp.asarray(mu), jnp.asarray(var),
                              jnp.asarray(front), None, key)
    u, z = _qehvi_draws(jcfg, key, p, m)
    tp, tg = tmo.qehvi_select(tcfg, _t(mu), _t(var), _t(front), u, z)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tg, jg)
    assert len(set(tp.tolist())) == tcfg.q
    assert all(tg[i] >= tg[i + 1] for i in range(tcfg.q - 1))


def test_hv_estimate_equals_the_reference_with_its_samples():
    """The reference's 4096 box samples replayed: within one f32 rounding of
    the box volume (rtol 1e-6)."""
    rng = np.random.default_rng(4)
    obj = rng.random((9, 3)).astype(np.float32)
    ref_pt = (1.1, 1.2, 1.05)
    seed = 3
    expect = jmo.hv_estimate(obj, ref_pt, seed=seed)
    u = jax.random.uniform(jax.random.key(seed), (4096, 3), jnp.float32)
    got = tmo.hv_estimate(obj, ref_pt, device="cpu", u01=_t(u))
    np.testing.assert_allclose(got, expect, rtol=1e-6)
    assert 0.0 < got
    # its own draws: deterministic in the seed, ordered like the reference's
    own = tmo.hv_estimate(obj, ref_pt, seed=seed, device="cpu")
    assert own == tmo.hv_estimate(obj, ref_pt, seed=seed, device="cpu")
    assert tmo.hv_estimate([[0.5, 0.5]], (1.0, 1.0), seed=2, device="cpu") \
        < tmo.hv_estimate([[0.25, 0.25]], (1.0, 1.0), seed=2, device="cpu")
    assert tmo.hv_estimate([[2.0, 0.5]], (1.0, 1.0), device="cpu") == 0.0


# ---------------------------------------------------------------------------
# the explorer: pool, archive, ask
# ---------------------------------------------------------------------------
def _reference_ask_draws(jcfg, round_):
    """The draws of the reference's ask in round ``round_``, as the port's
    AskDraws."""
    key = jax.random.fold_in(jax.random.key(jcfg.seed), round_)
    n_off = jcfg.pool_size // 2
    ga_cfg = jnsga2.NSGA2Config(
        mu=jcfg.archive_size, genome_dim=jcfg.dim,
        bounds=tuple((0.0, 1.0) for _ in range(jcfg.dim)),
        n_objectives=jcfg.n_objectives, reevaluate=0.0)
    d = _jax_offspring_draws(jax.random.fold_in(key, 3), jcfg.archive_size,
                             n_off, jcfg.dim, ga_cfg)
    off = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    for k in ("cand1", "cand2", "src"):
        off[k] = off[k].to(torch.int64)
    uniform = jax.random.uniform(jax.random.fold_in(key, 4),
                                 (jcfg.pool_size - n_off, jcfg.dim),
                                 jnp.float32)
    u, z = _qehvi_draws(jcfg, key, jcfg.pool_size, jcfg.n_objectives)
    return tmo.AskDraws(nsga2.OffspringDraws(**off), _t(uniform), u, z)


@pytest.fixture(scope="module")
def told_pair():
    """A reference explorer and a port explorer, each told the same three
    rounds of Sobol points and the synthetic objectives."""
    jcfg, tcfg = _mocfgs()
    jex, tex = jmo.MOSurrogateExplorer(jcfg), \
        tmo.MOSurrogateExplorer(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(3):
        xq = rng.random((jcfg.q, 2)).astype(np.float32)
        y = mo_objectives(xq)
        jex.tell(xq, y)
        tex.tell(xq, y)
    return jcfg, tcfg, jex, tex


def _assert_archives_equal(t_arch, j_arch):
    np.testing.assert_array_equal(t_arch.valid.numpy(), np.asarray(j_arch.valid))
    np.testing.assert_array_equal(t_arch.genomes.numpy(),
                                  np.asarray(j_arch.genomes))
    np.testing.assert_array_equal(t_arch.objectives.numpy(),
                                  np.asarray(j_arch.objectives))


def test_explorer_archive_and_pool_equal_the_reference(told_pair):
    """Archive merges: integer ranks, so the archives are equal. The pool's
    bred half from the reference's offspring draws: genomes within 1e-6
    (SBX's powers), its uniform half equal."""
    jcfg, tcfg, jex, tex = told_pair
    _assert_archives_equal(tex.archive, jex.archive)
    jmask = np.asarray(jax.jit(jarchive.pareto_front)(jex.archive))
    from repro_torch.evolution import archive as tarchive
    np.testing.assert_array_equal(
        tarchive.pareto_front(tex.archive).numpy(), jmask)
    key = jax.random.fold_in(jax.random.key(jcfg.seed), tex.round)
    expect = np.asarray(jax.jit(jex._pool)(key))
    got = tex._pool(_reference_ask_draws(jcfg, tex.round)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[jcfg.pool_size // 2:],
                                  expect[jcfg.pool_size // 2:])


# The ask fits three GPs per side (each factor to ~1e-4, see
# test_torch_surrogate.py); a posterior mean that moves by that much can
# flip a posterior sample against a box cell, which moves a slot's gain by
# 1 / (mc_samples * hv_samples) = 1/1024 here. Tolerance: 4 flips a slot.
GAIN_ATOL = 4.0 / (16 * 64)


def test_explorer_told_the_reference_history_gives_its_ask(told_pair):
    jcfg, tcfg, jex, tex = told_pair
    expect = jex.ask()
    got = tex.ask(_reference_ask_draws(jcfg, tex.round))
    np.testing.assert_allclose(tex.last_gains, jex.last_gains,
                               atol=GAIN_ATOL)
    # picks: equal wherever the reference's slot gain leads the next slot's
    # by more than the tolerance (a near-tie may swap two candidates)
    jg = np.asarray(jex.last_gains)
    for s in range(jcfg.q):
        if s == jcfg.q - 1 or jg[s] - jg[s + 1] > GAIN_ATOL:
            np.testing.assert_allclose(got[s], expect[s], rtol=1e-6,
                                       atol=1e-7, err_msg=f"slot {s}")
    front_g, front_o = tex.front()
    jg_, jo_ = jex.front()
    np.testing.assert_array_equal(front_o, np.asarray(jo_))
    np.testing.assert_allclose(front_g, np.asarray(jg_), rtol=1e-6)


def test_reference_history_replays_to_the_reference_archive(told_pair):
    """load_state_arrays replays the archive from a history the reference
    wrote: equal to the archive the told explorer carries."""
    jcfg, tcfg, jex, _ = told_pair
    tex = tmo.MOSurrogateExplorer(tcfg, device="cpu")
    tex.load_state_arrays(jax.tree.map(np.asarray, jex.state_arrays()))
    assert tex.round == jex.round
    _assert_archives_equal(tex.archive, jex.archive)


# ---------------------------------------------------------------------------
# the ask/tell loop within the port
# ---------------------------------------------------------------------------
def _mo_eval(generator, genomes):
    noise = torch.rand((len(genomes), 1), generator=generator,
                       device=genomes.device) * 1e-3
    return torch.from_numpy(mo_objectives(genomes.cpu().numpy())) + noise


def test_run_surrogate_mo_resumes_bitwise_and_the_pool_changes_nothing(
        tmp_path):
    from repro_torch.core.scheduler import RunRecord
    _, tcfg = _mocfgs()
    straight = tmo.run_surrogate_mo(tcfg, _mo_eval, rounds=3, device="cpu")
    assert not straight.interrupted and straight.genomes.shape == (12, 2)
    assert straight.hv > 0 and len(straight.front_objectives) >= 1
    ck = str(tmp_path / "ck")
    cut = tmo.run_surrogate_mo(tcfg, _mo_eval, rounds=3, device="cpu",
                               checkpoint_dir=ck, stop_after_rounds=2)
    assert cut.interrupted and cut.rounds_done == 2 and cut.hv is None
    resumed = tmo.run_surrogate_mo(tcfg, _mo_eval, rounds=3, device="cpu",
                                   checkpoint_dir=ck)
    assert resumed.resumed_rounds == 2
    for f in ("genomes", "objectives", "front_genomes", "front_objectives"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(straight, f), err_msg=f)
    assert resumed.hv == straight.hv
    record = RunRecord(workflow="mo", scheduler="ask-tell",
                       environment="pool", started_at="")
    pool = explore.make_init_pool(0.3, backoff_s=0.0)
    try:
        pooled = tmo.run_surrogate_mo(tcfg, _mo_eval, rounds=3,
                                      environment=pool, device="cpu",
                                      record=record)
    finally:
        pool.shutdown()
    np.testing.assert_array_equal(pooled.genomes, straight.genomes)
    np.testing.assert_array_equal(pooled.objectives, straight.objectives)
    assert pooled.hv == straight.hv and pooled.attempts > 12
    assert [t.mode for t in record.tasks] == ["surrogate-mo"] * 12


MO_CLI = ["--method", "surrogate-mo", "--device", "cpu", "--reduced",
          "--q", "2", "--n-init", "2", "--replicates", "1"]


def test_cli_surrogate_mo_writes_resumes_and_refuses_other_settings(
        tmp_path, capsys):
    out = str(tmp_path)
    explore.main(MO_CLI + ["--rounds", "2", "--out", out])
    with open(tmp_path / "surrogate_mo_result.json") as f:
        result = json.load(f)
    assert set(result) == {"front_genomes", "front_objectives",
                           "hypervolume", "genomes", "objectives", "rounds",
                           "attempts", "fault_rate", "wall_s"}
    assert result["rounds"] == 2 and len(result["objectives"]) == 4
    assert all(len(o) == 3 for o in result["objectives"])
    with open(tmp_path / "provenance.json") as f:
        modes = [t["mode"] for t in json.load(f)["tasks"]]
    assert modes == ["surrogate-mo"] * 4
    explore.main(MO_CLI + ["--rounds", "3", "--out", out])
    with open(tmp_path / "surrogate_mo_result.json") as f:
        again = json.load(f)
    assert again["rounds"] == 3
    assert again["objectives"][:4] == result["objectives"]
    assert "2 rounds resumed" in capsys.readouterr().out
    with pytest.raises(ValueError, match="other settings"):
        explore.main(MO_CLI[:-1] + ["2", "--rounds", "4", "--out", out])


def test_cli_surrogate_mo_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.main(["--method", "surrogate-mo", "--reduced", "--out",
                      str(tmp_path)])
