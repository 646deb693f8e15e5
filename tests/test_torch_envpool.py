"""The port's environment layer on the CPU: fault injection, retries,
timeouts, corruption checks, speculation and load balancing of
``LocalEnvironment`` and ``EnvironmentPool``; their decisions and digests
against the JAX package's; and the accounting invariant
``submitted == completed + failed + hung + corrupted`` of every member."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cache as jcache  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.prototype import Val as JVal  # noqa: E402
from repro.core.task import PyTask as JPyTask  # noqa: E402
from repro_torch.core import (Context, EnvironmentPool, FaultSpec,  # noqa: E402
                              LocalEnvironment, PyTask, TaskError, Val)
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.faults import corrupt_output  # noqa: E402

x = Val("x", float)
y = Val("y", float)
SQ = PyTask("sq", lambda ctx: {"y": ctx["x"] ** 2}, inputs=(x,),
            outputs=(y,))


def make_pool(*envs, **kw):
    kw.setdefault("backoff_s", 0.0)
    return EnvironmentPool(list(envs), **kw)


def assert_member_invariant(pool):
    """Every attempt submitted to a member ended as exactly one of
    completed/failed/hung/corrupted; the pool has nothing in flight."""
    for name, s in pool.member_stats().items():
        assert s["submitted"] == (s["completed"] + s["failed"]
                                  + s["hung"] + s["corrupted"]), (name, s)
    snap = pool.stats.snapshot()
    assert snap["in_flight"] == 0
    assert snap["submitted"] == snap["completed"] + snap["failed"]


# ---------------------------------------------------------------------------
# against the reference: fault decisions and digests are the same functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    dict(fail_rate=0.35, seed=0), dict(fail_rate=0.5, fail_limit=None, seed=3),
    dict(hang_rate=0.2, corrupt_rate=0.2, fail_rate=0.2, seed=1)])
def test_fault_decisions_equal_the_reference(spec):
    ours, theirs = FaultSpec(**spec), jfaults.FaultSpec(**spec)
    jobs = [f"propose_eval:{i:040x}" for i in range(64)]
    assert [ours.decide(j, a) for j in jobs for a in range(3)] == \
        [theirs.decide(j, a) for j in jobs for a in range(3)]


def test_digests_equal_the_reference():
    ctx = {"round": 3, "slot": 1, "x": (12.5, 80.25)}
    assert cache.hash_context(ctx) == jcache.hash_context(ctx)
    ours = PyTask("propose_eval", lambda c: {}, inputs=(Val("round", int),))
    theirs = JPyTask("propose_eval", lambda c: {},
                     inputs=(JVal("round", int),))
    assert cache.inputs_digest(ours, Context(ctx)) == \
        jcache.inputs_digest(theirs, ctx)
    # the fingerprint follows the function's code
    other = PyTask("propose_eval", lambda c: {"y": 1.0},
                   inputs=(Val("round", int),))
    assert cache.fingerprint_task(ours) != cache.fingerprint_task(other)
    assert cache.fingerprint_task(ours) == cache.fingerprint_task(
        PyTask("propose_eval", lambda c: {}, inputs=(Val("round", int),)))


@pytest.mark.parametrize("out", [
    {"y": 4.0}, {"objectives": np.arange(6.0).reshape(2, 3)},
    {"t": torch.arange(4.0)}])
def test_corrupt_output_changes_fingerprint(out):
    ctx = Context(out)
    assert cache.hash_context(corrupt_output(ctx)) != cache.hash_context(ctx)


# ---------------------------------------------------------------------------
# one environment
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault,outcomes,counter", [
    (dict(fail_rate=1.0, fail_limit=1), ["fail", "ok"], "failed"),
    (dict(corrupt_rate=1.0, corrupt_limit=1), ["corrupt", "ok"],
     "corrupted"),
    (dict(hang_rate=1.0, hang_limit=1, hang_s=5.0), ["hang", "ok"], "hung"),
])
def test_one_fault_is_retried_to_the_clean_result(fault, outcomes, counter):
    env = LocalEnvironment(retries=3, backoff_s=0.0, timeout_s=0.15,
                           faults=FaultSpec(**fault))
    t0 = time.monotonic()
    out, meta = env.submit_traced(SQ, Context(x=3.0))
    env.release_hangs()
    assert out["y"] == 9.0
    assert time.monotonic() - t0 < 5.0, "a retry must beat the injected hang"
    assert [a["outcome"] for a in meta["attempts"]] == outcomes
    assert getattr(env.stats, counter) == 1 and meta["retries"] == 1


def test_fail_always_exhausts_retries():
    env = LocalEnvironment(retries=2, backoff_s=0.0,
                           faults=FaultSpec(fail_rate=1.0, fail_limit=None))
    with pytest.raises(RuntimeError, match="failed after 3 attempts"):
        env.submit(SQ, Context(x=3.0))
    assert env.stats.failed == 3


def test_declaration_bugs_never_retry():
    bad = PyTask("bad", lambda ctx: {}, outputs=(y,))
    env = LocalEnvironment(retries=5, backoff_s=0.0,
                           faults=FaultSpec(fail_rate=0.0))
    with pytest.raises(TaskError, match="missing outputs"):
        env.submit(bad, Context())
    assert env.stats.retried == 0


def test_single_environment_speculation_and_async():
    env = LocalEnvironment(speculative=3)
    out, meta = env.submit_traced(SQ, Context(x=3.0))
    assert out["y"] == 9.0 and meta["speculative"] is True
    fut = LocalEnvironment().submit_async(SQ, Context(x=5.0))
    assert fut.result(timeout=30)[0]["y"] == 25.0


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
def test_pool_routes_around_a_fail_always_member():
    bad = LocalEnvironment(name="bad", capacity=2,
                           faults=FaultSpec(fail_rate=1.0, fail_limit=None))
    good = LocalEnvironment(name="good", capacity=2)
    pool = make_pool(bad, good, retries=4)
    try:
        out, meta = pool.submit_traced(SQ, Context(x=6.0))
        assert out["y"] == 36.0
        envs = [(a["environment"], a["outcome"]) for a in meta["attempts"]]
        assert ("good", "ok") in envs
        assert all(o == "fail" for e, o in envs if e == "bad")
        assert pool.stats.resubmissions == sum(o != "ok" for _, o in envs)
        assert_member_invariant(pool)
    finally:
        pool.shutdown()


@pytest.mark.parametrize("rate", [0.0, 0.35])
def test_pool_async_jobs_bit_exact_under_failures(rate):
    """The surrogate's pool (3 thread workers of capacity 2, as
    ``launch.explore.make_init_pool`` builds it) returns the clean results
    under a 35 % injected failure rate, and balances its accounting."""
    from repro_torch.launch.explore import make_init_pool
    pool = make_init_pool(rate, backoff_s=0.0)
    try:
        futs = [pool.submit_async(SQ, Context(x=float(i))) for i in range(24)]
        outs = [f.result(timeout=60) for f in futs]
        assert [o["y"] for o, _ in outs] == [float(i) ** 2 for i in range(24)]
        attempts = sum(len(m["attempts"]) for _, m in outs)
        fails = sum(a["outcome"] == "fail" for _, m in outs
                    for a in m["attempts"])
        assert attempts == 24 + fails
        assert (fails > 0) == (rate > 0)
        assert pool.stats.failed_attempts == fails
        assert_member_invariant(pool)
    finally:
        pool.shutdown()


def test_pool_async_jobs_on_heterogeneous_members_bit_exact():
    """Members of capacities 1, 2 and 3, each failing 30 % of attempts: every
    job returns what one clean environment returns, and each failed attempt
    is resubmitted."""
    ctxs = [Context(x=float(i)) for i in range(48)]
    expect = [LocalEnvironment().submit(SQ, c)["y"] for c in ctxs]
    envs = [LocalEnvironment(name=f"w{i}", capacity=i + 1,
                             faults=FaultSpec(fail_rate=0.3, seed=i))
            for i in range(3)]
    pool = make_pool(*envs, retries=6)
    try:
        futs = [pool.submit_async(SQ, c) for c in ctxs]
        assert [f.result(timeout=60)[0]["y"] for f in futs] == expect
        assert pool.stats.completed == len(ctxs)
        assert pool.stats.resubmissions == pool.stats.failed_attempts > 0
        assert_member_invariant(pool)
    finally:
        pool.shutdown()


def test_pool_speculative_submit_returns_on_first_result():
    hang = LocalEnvironment(
        name="hangs", capacity=2,
        faults=FaultSpec(hang_rate=1.0, hang_limit=None, hang_s=3.0))
    fast = LocalEnvironment(name="fast", capacity=2)
    pool = make_pool(hang, fast, retries=2, speculative=2)
    try:
        t0 = time.monotonic()
        out, meta = pool.submit_traced(SQ, Context(x=8.0))
        assert out["y"] == 64.0 and meta["speculative"] is True
        assert time.monotonic() - t0 < 2.0
    finally:
        pool.shutdown()


def test_pool_hang_member_with_timeout_and_corruption():
    hang = LocalEnvironment(
        name="hangs", capacity=1, timeout_s=0.1,
        faults=FaultSpec(hang_rate=1.0, hang_limit=None, hang_s=4.0))
    evil = LocalEnvironment(
        name="evil", capacity=1,
        faults=FaultSpec(corrupt_rate=1.0, corrupt_limit=None))
    good = LocalEnvironment(name="good", capacity=2)
    pool = make_pool(hang, evil, good, retries=6)
    try:
        t0 = time.monotonic()
        metas = []
        for i in range(4):
            out, meta = pool.submit_traced(SQ, Context(x=float(i)))
            assert out["y"] == float(i) ** 2
            metas.append(meta)
        assert time.monotonic() - t0 < 4.0
        outcomes = [a["outcome"] for m in metas for a in m["attempts"]]
        assert pool.stats.hung_attempts == outcomes.count("hang")
        assert pool.stats.corrupt_attempts == outcomes.count("corrupt")
        for m in metas:
            assert m["attempts"][-1] == {**m["attempts"][-1],
                                         "environment": "good",
                                         "outcome": "ok"}
        for m in pool.members:
            m.env.release_hangs()
        assert_member_invariant(pool)
    finally:
        pool.shutdown()


def test_pool_accounting_holds_under_thread_contention():
    """More submitting threads than cores, a short switch interval: the
    pool's counters lose no update."""
    pool = make_pool(*[LocalEnvironment(
        name=f"w{i}", capacity=2,
        faults=FaultSpec(fail_rate=0.3, seed=i)) for i in range(3)],
        retries=8)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = []
    try:
        threads = [threading.Thread(target=lambda k=k: results.extend(
            pool.submit(SQ, Context(x=float(16 * k + i)))["y"]
            for i in range(16))) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sorted(results) == sorted(float(i) ** 2 for i in range(192))
        assert pool.stats.completed == 192
        assert_member_invariant(pool)
    finally:
        sys.setswitchinterval(switch)
        pool.shutdown()
