"""The port's task queue and exploration service (``core/taskqueue.py``,
``core/service.py``) on the CPU, mirroring the reference's
``tests/test_service.py`` (section 4): queue order, re-ranking of pending
work only, idempotent and failed resubmission, journal replay with payload
re-attachment and a torn tail, a journal written by the JAX package's
queue replayed in the port's; the service memoizing one tenant, two
tenants bitwise equal to their serial runs (clean and under chaos), a
restart without re-execution, priorities ordering pending work, the
surrogate and streaming-init tenants bitwise equal to their inline runs,
a failed firing surfacing its error, and ``--method service``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PyTask as JPyTask  # noqa: E402
from repro.core import Val as JVal  # noqa: E402
from repro.core.taskqueue import TaskQueue as JTaskQueue  # noqa: E402
from repro_torch.core import (Context, EnvironmentPool,  # noqa: E402
                              ExplorationService, FaultSpec,
                              LocalEnvironment, PyTask, TaskQueue, Val)
from repro_torch.evolution import ga, nsga2  # noqa: E402
from repro_torch.explore import surrogate as tsur  # noqa: E402
from repro_torch.launch import explore  # noqa: E402

x = Val("x", float)
y = Val("y", float)

SQ = PyTask("sq", lambda ctx: {"y": ctx["x"] ** 2}, inputs=(x,),
            outputs=(y,))


def make_pool(*envs, **kw):
    kw.setdefault("backoff_s", 0.0)
    return EnvironmentPool(list(envs), **kw)


def chaos_members(n=3, hang_s=0.4):
    """Three members under a ~35% per-attempt fault mix (fail + hang +
    corrupt), decorrelated by seed."""
    return [LocalEnvironment(
        name=f"w{i}", capacity=2,
        faults=FaultSpec(fail_rate=0.25, fail_limit=None,
                         hang_rate=0.05, hang_limit=2, hang_s=hang_s,
                         corrupt_rate=0.05, corrupt_limit=2, seed=i))
        for i in range(n)]


def serve(pool=None, **kw):
    pool = pool or make_pool(LocalEnvironment(name="a", capacity=2),
                             LocalEnvironment(name="b", capacity=2))
    return ExplorationService(pool, **kw)


# ---------------------------------------------------------------------------
# TaskQueue
# ---------------------------------------------------------------------------
def test_taskqueue_priority_and_fifo_order():
    q = TaskQueue()
    for i, pri in enumerate([1.0, 3.0, 3.0, 2.0]):
        q.submit("e", f"t{i}", pri, SQ, Context(x=float(i)))
    popped = [q.pop_next(timeout=0.1).task_id for _ in range(4)]
    # highest priority first; FIFO between the two 3.0 ties
    assert popped == ["t1", "t2", "t3", "t0"]


def test_taskqueue_update_priorities_reranks_pending_only(tmp_path):
    journal = str(tmp_path / "queue.jsonl")
    q = TaskQueue(journal)
    for i in range(5):
        q.submit("e", f"t{i}", float(i), SQ, Context(x=float(i)))
    running = q.pop_next(timeout=0.1)               # t4
    finished = q.pop_next(timeout=0.1)              # t3
    q.mark_done(finished)
    failed = q.pop_next(timeout=0.1)                # t2
    q.mark_done(failed, ok=False, error="boom")
    # only the pending t0 counts; t1 keeps its priority
    assert q.update_priorities(
        "e", {"t0": 10.0, "t1": 1.0, "t2": 50.0, "t3": 60.0,
              "t4": 70.0}) == 1
    assert (running.priority, finished.priority, failed.priority) == \
        (4.0, 3.0, 2.0)
    assert running.state == "running"
    assert q.pop_next(timeout=0.1).task_id == "t0"  # re-ranked up
    q.close()
    with open(journal) as f:
        pri_ops = [r for r in map(json.loads, f) if r["op"] == "priority"]
    assert [(r["key"], r["priority"]) for r in pri_ops] == [("e/t0", 10.0)]
    q2 = TaskQueue(journal)                         # replays the same ranks
    assert q2.get("e", "t4").priority == 4.0
    assert q2.get("e", "t0").priority == 10.0
    q2.close()


def test_taskqueue_idempotent_and_failed_resubmit():
    q = TaskQueue()
    e1, created1 = q.submit("e", "t", 1.0, SQ, Context(x=2.0))
    e2, created2 = q.submit("e", "t", 5.0, SQ, Context(x=2.0))
    assert created1 and not created2 and e1 is e2
    assert e1.priority == 1.0               # the original priority stands
    q.mark_done(q.pop_next(timeout=0.1))
    assert q.pop_next(timeout=0.05) is None  # no duplicate run
    assert q.query("e") == {"pending": 0, "running": 0, "done": 1,
                            "failed": 0}
    q.submit("e", "u", 1.0, SQ, Context(x=3.0))
    q.mark_done(q.pop_next(timeout=0.1), ok=False, error="boom")
    assert q.query("e")["failed"] == 1
    q.submit("e", "u", 1.0, SQ, Context(x=3.0))   # a resubmit retries
    again = q.pop_next(timeout=0.1)
    assert again is not None and again.task_id == "u"
    q.close()
    q.mark_done(again)                 # after close: dropped, no raise
    assert again.state == "done"


def test_taskqueue_journal_replay_and_payload_reattach(tmp_path):
    journal = str(tmp_path / "queue.jsonl")
    q = TaskQueue(journal)
    q.submit("e", "t0", 2.0, SQ, Context(x=0.0))
    q.submit("e", "t1", 1.0, SQ, Context(x=1.0))
    q.submit("e", "t2", 20.0, SQ, Context(x=2.0))
    q.update_priorities("e", {"t1": 9.0})
    done = q.pop_next(timeout=0.1)          # t2, the highest
    assert done.task_id == "t2"
    q.mark_done(done)
    claimed = q.pop_next(timeout=0.1)       # t1 claimed, never finished
    assert claimed.task_id == "t1"
    q.close()                               # the driver dies here

    q2 = TaskQueue(journal)                 # restart
    assert q2.query("e") == {"pending": 2, "running": 0, "done": 1,
                             "failed": 0}   # orphaned running -> pending
    assert q2.pop_next(timeout=0.05) is None   # payload-less: not runnable
    for i, tid in enumerate(["t0", "t1", "t2"]):
        _, created = q2.submit("e", tid, 0.5, SQ, Context(x=float(i)))
        assert not created
    assert q2.get("e", "t1").priority == 9.0   # the journaled update
    assert q2.get("e", "t2").state == "done"   # done stays done
    assert [q2.pop_next(timeout=0.1).task_id for _ in range(2)] == \
        ["t1", "t0"]
    assert q2.pop_next(timeout=0.05) is None
    q2.close()
    with open(journal, "a") as f:
        f.write('{"op": "submit", "key": "e/t9"')   # a torn crash write
    q3 = TaskQueue(journal)
    assert len(q3) == 3                     # the torn line is skipped
    q3.close()


def _journal_ops(q, task, ctx_of):
    """The same sequence of queue operations on either package's queue:
    submits, a re-rank, a done, a failure, a claim left running."""
    for i, pri in enumerate([1.0, 4.0, 4.0, 2.0, 3.0, 0.5]):
        q.submit("exp", f"t{i}", pri, task, ctx_of(i))
    q.submit("other", "t0", 7.0, task, ctx_of(9))
    q.update_priorities("exp", {"t0": 5.0, "t5": 4.0})
    order = []
    for ok in (True, False, None):
        e = q.pop_next(timeout=0.1)
        order.append(e.key)
        if ok is not None:
            q.mark_done(e, ok=ok, error=None if ok else "boom")
    q.close()
    return order


def test_journal_of_the_reference_replays_in_the_port(tmp_path):
    """A journal written by repro.core.taskqueue.TaskQueue replays in the
    port's queue to the same counts, priorities and pop order as in the
    reference's own replay (the record schema is the reference's)."""
    from repro.core.prototype import Context as JContext
    jsq = JPyTask("sq", lambda ctx: {"y": ctx["x"] ** 2},
                  inputs=(JVal("x", float),), outputs=(JVal("y", float),))
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    j_order = _journal_ops(JTaskQueue(jpath), jsq,
                           lambda i: JContext(x=float(i)))
    t_order = _journal_ops(TaskQueue(tpath), SQ, lambda i: Context(x=float(i)))
    assert t_order == j_order
    with open(jpath) as f, open(tpath) as g:
        assert f.read() == g.read()         # the port writes the same bytes
    jq, tq = JTaskQueue(jpath), TaskQueue(jpath)
    for eid in (None, "exp", "other"):
        assert tq.query(eid) == jq.query(eid)
    keys = [(e, f"t{i}") for e in ("exp",) for i in range(6)] + \
        [("other", "t0")]
    for eid, tid in keys:
        je, te = jq.get(eid, tid), tq.get(eid, tid)
        assert (te.priority, te.seq, te.state, te.error) == \
            (je.priority, je.seq, je.state, je.error)
    for i in range(6):
        jq.submit("exp", f"t{i}", 0.0, jsq, JContext(x=float(i)))
        tq.submit("exp", f"t{i}", 0.0, SQ, Context(x=float(i)))
    jq.submit("other", "t0", 0.0, jsq, JContext(x=9.0))
    tq.submit("other", "t0", 0.0, SQ, Context(x=9.0))

    def drain(q):
        out = []
        while (e := q.pop_next(timeout=0.05)) is not None:
            out.append(e.key)
        return out

    assert drain(tq) == drain(jq)
    jq.close()
    tq.close()


# ---------------------------------------------------------------------------
# ExplorationService
# ---------------------------------------------------------------------------
def test_service_runs_and_memoizes_one_experiment():
    svc = serve()
    try:
        jobs = [(SQ, Context(x=float(i))) for i in range(10)]
        ids = svc.submit_tasks("exp", jobs, priority=1.0)
        res = svc.wait("exp", ids, timeout=30)
        assert [res[t]["y"] for t in ids] == [float(i) ** 2
                                              for i in range(10)]
        before = svc.pool.stats.snapshot()["submitted"]
        assert svc.submit_tasks("exp", jobs, priority=1.0) == ids
        assert svc.pool.stats.snapshot()["submitted"] == before
        rec = svc.record("exp")
        assert len(rec.tasks) == 10
        assert {t.mode for t in rec.tasks} == {"service"}
        tid, out = svc.submit_and_wait("exp", SQ, Context(x=3.0),
                                       timeout=30)
        assert tid == ids[3] and out["y"] == 9.0
    finally:
        svc.shutdown()
        svc.pool.shutdown()


@pytest.mark.parametrize("chaos", [False, True])
def test_service_two_tenants_bit_exact_vs_serial(chaos):
    pool = make_pool(*chaos_members(), retries=16, speculative=2) \
        if chaos else None
    svc = serve(pool)
    xs = {"A": [float(i) for i in range(20)],
          "B": [float(400 + i) for i in range(20)]}
    results, errors = {}, []

    def tenant(eid):
        try:
            ids = svc.submit_tasks(eid, [(SQ, Context(x=v))
                                         for v in xs[eid]])
            res = svc.wait(eid, ids, timeout=120)
            results[eid] = [res[t]["y"] for t in ids]
        except Exception as e:             # surfaced after join
            errors.append(e)

    try:
        ts = [threading.Thread(target=tenant, args=(e,)) for e in xs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts) and not errors
        # pure tasks: the chaos changes scheduling, not values
        for eid, v in xs.items():
            assert results[eid] == [a ** 2 for a in v]
            assert svc.query(eid)["done"] == 20
    finally:
        svc.shutdown()
        svc.pool.shutdown()


def test_service_restart_resumes_without_reexecution(tmp_path):
    slow_sq = PyTask("slow_sq", lambda ctx: (time.sleep(0.05),
                                             {"y": ctx["x"] ** 2})[1],
                     inputs=(x,), outputs=(y,))
    jobs = [(slow_sq, Context(x=float(i))) for i in range(20)]
    cache_dir, journal = str(tmp_path / "cache"), str(tmp_path / "q.jsonl")
    pool1 = make_pool(LocalEnvironment(name="a", capacity=2))
    svc1 = ExplorationService(pool1, cache=cache_dir, journal=journal,
                              workers=2)
    ids1 = svc1.submit_tasks("exp", jobs)
    deadline = time.monotonic() + 30
    while svc1.query("exp")["done"] < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    svc1.shutdown()                         # the driver dies mid-run
    pool1.shutdown()
    done1 = svc1.query("exp")["done"]
    ran1 = pool1.stats.snapshot()["submitted"]
    assert 0 < done1 < 20

    pool2 = make_pool(LocalEnvironment(name="a", capacity=2))
    svc2 = ExplorationService(pool2, cache=cache_dir, journal=journal)
    try:
        ids = svc2.submit_tasks("exp", jobs)    # idempotent resubmit
        assert ids == ids1                      # the same content addresses
        res = svc2.wait("exp", ids, timeout=60)
        assert [res[t]["y"] for t in ids] == [float(i) ** 2
                                              for i in range(20)]
        ran2 = pool2.stats.snapshot()["submitted"]
        assert ran1 + ran2 == 20, \
            f"restart re-executed completed tasks ({ran1}+{ran2} != 20)"
        rec = svc2.record("exp")
        assert sum(t.cache_hit for t in rec.tasks) >= done1
        assert {t.mode for t in rec.tasks if t.cache_hit} == {"cache"}
    finally:
        svc2.shutdown()
        pool2.shutdown()


def test_service_update_priorities_orders_pending_work():
    gate = PyTask("gate", lambda ctx: (time.sleep(0.5), {"y": 0.0})[1],
                  inputs=(x,), outputs=(y,))
    pool = make_pool(LocalEnvironment(name="a", capacity=1))
    svc = ExplorationService(pool, workers=1)
    try:
        [gate_id] = svc.submit_tasks("exp", [(gate, Context(x=-1.0))],
                                     priority=100.0)
        ids = svc.submit_tasks("exp", [(SQ, Context(x=float(i)))
                                       for i in range(5)])
        # while the gate job holds the single worker, invert the order
        assert svc.update_priorities(
            "exp", {tid: float(i + 1) for i, tid in enumerate(ids)}) == 5
        svc.wait("exp", [gate_id] + ids, timeout=30)
        completion = [tid for tid, _ in svc.pop_completed("exp")]
        assert completion == [gate_id] + list(reversed(ids))
    finally:
        svc.shutdown()
        pool.shutdown()


def test_service_failed_firing_surfaces_error():
    bad = PyTask("always_bad",
                 lambda ctx: (_ for _ in ()).throw(ValueError("no")),
                 inputs=(x,), outputs=(y,))
    pool = make_pool(LocalEnvironment(name="a", capacity=2), retries=1)
    svc = ExplorationService(pool)
    try:
        [tid] = svc.submit_tasks("exp", [(bad, Context(x=1.0))])
        with pytest.raises(RuntimeError, match="failed"):
            svc.wait("exp", [tid], timeout=30)
        assert svc.query("exp")["failed"] == 1
        with pytest.raises(RuntimeError, match="always_bad failed"):
            svc.result("exp", tid)
    finally:
        svc.shutdown()
        pool.shutdown()


# ---------------------------------------------------------------------------
# the two tenants of the launcher, each against its inline run
# ---------------------------------------------------------------------------
def _quadratic_eval(gen, g):
    # the job's own generator: a retried attempt draws alike; the sleep
    # keeps a round's later slots waiting in the queue while one runs
    time.sleep(0.02)
    d, e = g[:, 0], g[:, 1]
    return (d - 30.) ** 2 / 100 + (e - 55.) ** 2 / 100 \
        + 0.05 * torch.randn((g.shape[0],), generator=gen)


SUR = tsur.SurrogateConfig(bounds=((0., 100.), (0., 100.)), q=6, n_init=6,
                           mc_samples=32, n_starts=4, opt_steps=8, seed=0)


def test_service_surrogate_tenant_bit_exact_and_reprioritized():
    ref = tsur.run_surrogate(SUR, _quadratic_eval, rounds=3, device="cpu")
    # one worker: the slots wait in the queue, and every landing re-scores
    # the still-pending ones through update_priorities
    svc = ExplorationService(make_pool(LocalEnvironment(name="a",
                                                        capacity=1)),
                             workers=1)
    try:
        res = tsur.run_surrogate(SUR, _quadratic_eval, rounds=3, service=svc,
                                 experiment_id="sur", device="cpu")
        assert np.array_equal(ref.genomes, res.genomes)
        assert np.array_equal(ref.objectives, res.objectives)
        assert res.repriorities > 0
        assert svc.query("sur")["done"] == 18
        with pytest.raises(ValueError, match="not both"):
            tsur.run_surrogate(SUR, _quadratic_eval, rounds=1, service=svc,
                               environment=svc.pool, device="cpu")
    finally:
        svc.shutdown()
        svc.pool.shutdown()


def test_service_streaming_tenant_bit_exact(tmp_path):
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2,
                            bounds=((0., 100.), (0., 100.)))

    def eval_fn(gen, genomes):
        noise = torch.randn((len(genomes), 3), generator=gen)
        d, e = genomes[:, 0], genomes[:, 1]
        return torch.stack([(d - 30.) ** 2, (d - e).abs(), d + e], 1) + noise

    inline = ga.evaluate_population_streaming(cfg, eval_fn, 0, n_total=300,
                                              chunk=64, device="cpu")
    svc = serve(make_pool(*chaos_members(hang_s=0.2), retries=16),
                cache=str(tmp_path / "cache"))
    try:
        got = ga.evaluate_population_streaming(
            cfg, eval_fn, 0, n_total=300, chunk=64, service=svc,
            experiment_id="init", device="cpu")
        assert np.array_equal(got.objectives, inline.objectives)
        assert np.array_equal(got.genomes, inline.genomes)
        assert got.chunks_done == 5 and svc.query("init")["done"] == 5
        with pytest.raises(ValueError, match="not both"):
            ga.evaluate_population_streaming(
                cfg, eval_fn, 0, n_total=64, chunk=32, service=svc,
                environment=svc.pool, device="cpu")
    finally:
        svc.shutdown()
        svc.pool.shutdown()


SERVICE_CLI = ["--method", "service", "--device", "cpu", "--reduced",
               "--init-population", "64", "--init-chunk", "512",
               "--rounds", "2", "--q", "2", "--n-init", "2",
               "--replicates", "1", "--fault-rate", "0.3"]


def test_cli_service_runs_small_and_resumes_from_its_journal(tmp_path):
    out = str(tmp_path)
    explore.main(SERVICE_CLI + ["--out", out])
    assert {"service_result.json", "provenance_ga-init.json",
            "provenance_surrogate.json", "queue.jsonl", "cache"} <= \
        set(os.listdir(out))
    with open(tmp_path / "service_result.json") as f:
        result = json.load(f)
    assert set(result) == {"init", "surrogate", "queue", "fault_rate",
                           "wall_s"}
    # 64 individuals in chunks capped at 256: one chunk; 2 rounds of q 2
    assert result["queue"] == {"pending": 0, "running": 0, "done": 5,
                               "failed": 0}
    with open(tmp_path / "provenance_surrogate.json") as f:
        assert [t["mode"] for t in json.load(f)["tasks"]] == ["service"] * 4
    explore.main(SERVICE_CLI + ["--out", out])     # a restart: all cached
    with open(tmp_path / "service_result.json") as f:
        again = json.load(f)
    assert again["surrogate"]["best_genome"] == \
        result["surrogate"]["best_genome"]
    for eid in ("ga-init", "surrogate"):
        with open(tmp_path / f"provenance_{eid}.json") as f:
            assert {t["mode"] for t in json.load(f)["tasks"]} == {"cache"}


def test_cli_service_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explore.main(["--method", "service", "--reduced", "--out",
                      str(tmp_path)])
