"""EnvironmentPool — fault-tolerant delegation across heterogeneous
environments. Ported from ``repro.core.envpool`` (thread-backed members).

The paper's GA initialization of 200,000 individuals completed in one hour
on EGI *because* the submission layer assumed unreliable infrastructure:
OpenMOLE oversubmits, resubmits failed jobs, and load-balances across
whatever environments are attached. This module is that layer:

- **Heterogeneous members**: any mix of :class:`~repro.core.environment.
  Environment` instances, each with its own ``capacity`` (concurrent
  slots), ``latency_s``, ``timeout_s``, and injectable ``FaultSpec``.
- **Resubmission**: a failed / hung / corrupted attempt is resubmitted with
  exponential backoff to another member (the failing member is deprioritized
  for that job), up to ``retries`` total resubmissions.
- **Oversubmission / speculation**: ``speculative=k`` dispatches duplicate
  attempts of one job to ``k`` distinct members simultaneously; the first
  verified result wins and the losers are cancelled (EGI's over-submission
  trick). ``map_explore`` additionally duplicates straggler *lanes* onto
  idle members once the queue drains.
- **Load balancing**: each job goes to the member with the most free slots,
  then the fastest drain rate.
- **Work stealing**: ``map_explore`` splits an exploration into lanes,
  deals them to per-member deques weighted by capacity, and lets idle
  members steal queued lanes from the busiest member: lanes flow to
  whichever environment drains fastest, no central coordinator.
- **Integrity**: when faults are active each attempt carries a source-side
  output fingerprint; the pool re-verifies on receipt and treats
  mismatches (in-transit corruption) as one more transient failure.

The pool implements the job interface of an Environment (``submit``,
``submit_traced``, ``submit_async``, ``map_explore``, ``name``, ``stats``)
so the dataflow scheduler and every caller of a single environment (the
surrogate's ask/tell loop among them) accept it in its place. With one
healthy member and no faults the results are bit-identical to that member
alone: members differ only in *where* a pure task runs, never in what it
returns.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.environment import Environment
from repro_torch.core.faults import interruptible_sleep
from repro_torch.core.prototype import Context
from repro_torch.core.task import Task, TaskError


@dataclasses.dataclass
class PoolStats:
    """Aggregate fault-tolerance counters (per-member stats live on each
    member's own ``EnvStats``).

    Every mutation goes through :meth:`inc` under ONE internal lock, so
    concurrent ``submit_traced`` and ``map_explore`` calls lose no
    increments. The invariant a consistent snapshot obeys:

        submitted == completed + failed + in_flight
    """
    submitted: int = 0
    completed: int = 0            # jobs that returned a verified result
    failed: int = 0               # jobs that exhausted every pool round
    in_flight: int = 0            # jobs currently inside the pool
    resubmissions: int = 0        # cross-member retries consumed
    speculative_wins: int = 0     # duplicate dispatches whose copy won
    speculative_losses: int = 0   # duplicates whose result was discarded
    failed_attempts: int = 0
    hung_attempts: int = 0
    corrupt_attempts: int = 0
    lanes_stolen: int = 0         # map_explore lanes stolen by idle members

    def __post_init__(self):
        # not a dataclass field: asdict()/repr()/eq() see counters only
        self._lock = threading.Lock()

    def inc(self, **deltas: int) -> None:
        """Atomically apply counter deltas (the single mutation path)."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def snapshot(self) -> Dict[str, int]:
        """Consistent point-in-time copy of all counters."""
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)}


class _Member:
    """One pool member: the environment plus its dispatch bookkeeping."""

    def __init__(self, env: Environment, name: str):
        self.env = env
        self.name = name
        self.capacity = max(1, int(getattr(env, "capacity", 1)))
        self.executor = cf.ThreadPoolExecutor(
            max_workers=self.capacity,
            thread_name_prefix=f"repro-pool-{name}")
        self.inflight = 0
        self.completed = 0
        self.busy_s = 0.0           # cumulative attempt wall time

    def drain_rate(self) -> float:
        """Completed attempts per busy-second — the balancer's notion of
        'which environment drains fastest'."""
        if self.busy_s <= 0.0:
            return float("inf")     # unproven members get first pickings
        return self.completed / self.busy_s

    def __repr__(self):
        return (f"_Member({self.name}, capacity={self.capacity}, "
                f"inflight={self.inflight})")


class EnvironmentPool:
    """A pluggable pool of heterogeneous execution environments.

    Args:
        environments: the member Environments. Per-member ``capacity``,
            ``latency_s``, ``timeout_s``, and ``faults`` are honoured.
        retries: total cross-member resubmissions per job (on top of
            nothing — member-internal retry loops are bypassed; the pool
            owns the retry policy so provenance sees every attempt).
        backoff_s: base exponential backoff between resubmissions.
        speculative: >1 duplicates each PyTask job onto that many distinct
            members, first verified result wins.
        lane_size: contexts per ``map_explore`` lane (default: sized so
            every member slot gets ~2 lanes — small enough to balance,
            large enough to amortize dispatch).
        name: pool name in provenance records.
    """

    def __init__(self, environments: Sequence[Environment], *,
                 retries: int = 4, backoff_s: float = 0.05,
                 speculative: int = 1, lane_size: Optional[int] = None,
                 name: str = "pool"):
        if not environments:
            raise ValueError("EnvironmentPool needs at least one environment")
        self.name = name
        self.retries = retries
        self.backoff_s = backoff_s
        self.speculative = max(1, speculative)
        self.lane_size = lane_size
        self.stats = PoolStats()
        self._lock = threading.Lock()
        seen: Dict[str, int] = {}
        self.members: List[_Member] = []
        for env in environments:
            base = env.name
            seen[base] = seen.get(base, 0) + 1
            label = base if seen[base] == 1 else f"{base}#{seen[base]}"
            self.members.append(_Member(env, label))
        self._dispatch_pool: Optional[cf.ThreadPoolExecutor] = None

    # ------------------------------------------------------------- accounting
    @property
    def total_capacity(self) -> int:
        return sum(m.capacity for m in self.members)

    def member_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-member snapshot for provenance / debugging.

        Taken under the pool lock AND each member's stats lock so the
        snapshot is never torn by in-flight attempts. At quiescence every
        pool-driven member satisfies
        ``submitted == completed + failed + hung + corrupted``
        (TaskError declaration bugs abort the run and are deliberately
        outside the attempt accounting)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for m in self.members:
                with m.env._lock:
                    out[m.name] = {"capacity": m.capacity,
                                   "completed": m.completed,
                                   "drain_rate": (None if m.busy_s == 0.0
                                                  else round(m.drain_rate(), 3)),
                                   **dataclasses.asdict(m.env.stats)}
        return out

    def _pick(self, exclude: frozenset = frozenset(),
              k: int = 1) -> List[_Member]:
        """Choose the k best members: most free slots, then fastest drain.
        Excluded (recently-failing) members are only used as a last resort."""
        with self._lock:
            def score(m: _Member) -> Tuple:
                return (m.name in exclude,             # healthy first
                        -(m.capacity - m.inflight),    # free slots
                        -m.drain_rate())               # fastest drain
            ranked = sorted(self.members, key=score)
            return ranked[:max(1, min(k, len(ranked)))]

    # ------------------------------------------------------------ single jobs
    def submit(self, task: Task, context: Context) -> Context:
        return self.submit_traced(task, context)[0]

    def submit_traced(self, task: Task, context: Context
                      ) -> Tuple[Context, Dict[str, Any]]:
        """Run one job with cross-member resubmission (and optional
        speculative duplicate dispatch). Returns ``(output, meta)`` with
        per-attempt records in ``meta["attempts"]``.

        The returned ``meta`` is a private copy: a losing speculative
        duplicate that lands AFTER the winner returned appends only to the
        pool's internal attempt trace, never to the meta already handed to
        the caller (TaskRecords built from it must stay immutable)."""
        meta: Dict[str, Any] = {"retries": 0,
                                "speculative": self.speculative > 1,
                                "t0": time.monotonic(), "wall_s": 0.0,
                                "attempts": []}
        self.stats.inc(submitted=1, in_flight=1)
        exclude: set = set()
        err: Optional[BaseException] = None
        for round_i in range(self.retries + 1):
            k = self.speculative if task.kind == "py" else 1
            picked = self._pick(frozenset(exclude), k=k)
            try:
                out = self._race(task, context, picked, round_i, meta)
                self.stats.inc(completed=1, in_flight=-1)
                meta["wall_s"] = time.monotonic() - meta["t0"]
                return out, self._meta_copy(meta)
            except TaskError:
                self.stats.inc(failed=1, in_flight=-1)
                raise                    # declaration bugs never resubmit
            except Exception as e:
                err = e
                exclude.update(m.name for m in picked)
                if len(exclude) >= len(self.members):
                    exclude.clear()      # everyone failed once: forgive
                meta["retries"] += 1
                self.stats.inc(resubmissions=1)
                interruptible_sleep(self.backoff_s * (2 ** round_i), None)
        self.stats.inc(failed=1, in_flight=-1)
        raise RuntimeError(
            f"job {task.name} failed after {self.retries + 1} pool rounds "
            f"across {len(self.members)} environments") from err

    def _meta_copy(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """Snapshot a live meta dict: racing speculative losers append to
        the internal attempts list under ``self._lock``, so the handed-out
        copy is taken under the same lock."""
        with self._lock:
            out = dict(meta)
            out["attempts"] = [dict(a) for a in meta["attempts"]]
        return out

    def _race(self, task: Task, context: Context, picked: List[_Member],
              round_i: int, meta: Dict[str, Any]) -> Context:
        """One dispatch round: the job runs on every picked member and the
        FIRST verified result returns immediately — losers are cancelled
        when still queued, otherwise abandoned (their late results are
        discarded by a completion callback). A copy that hangs must never
        delay the winner: that is the whole point of oversubmission."""
        if len(picked) == 1:
            return self._attempt_on(picked[0], task, context, round_i, meta)
        futures = {m.executor.submit(self._attempt_on, m, task, context,
                                     round_i, meta): m
                   for m in picked}
        err: Optional[BaseException] = None
        for f in cf.as_completed(futures):
            try:
                result = f.result()
            except Exception as e:
                err = e
                continue
            self.stats.inc(speculative_wins=1)

            def _discard(other):
                if not other.cancel():
                    def note_loss(fut):
                        if fut.exception() is None:
                            self.stats.inc(speculative_losses=1)
                    other.add_done_callback(note_loss)

            for other in futures:
                if other is not f:
                    _discard(other)
            return result
        raise err if err is not None else RuntimeError("empty race")

    def _attempt_on(self, m: _Member, task: Task, context: Context,
                    round_i: int, meta: Dict[str, Any]) -> Context:
        """One attempt of one job on one member — delegates timeout,
        fault injection, and fingerprint verification to
        ``Environment.attempt_once``; adds the pool-level bookkeeping
        (balancer accounting, pool stats, per-attempt provenance entry)."""
        a_t0 = time.monotonic()
        err: Optional[BaseException] = None
        with self._lock:
            m.inflight += 1
        # Every attempt counts as submitted — not only the winners —
        # otherwise per-member provenance breaks the invariant
        # submitted == completed + failed + hung + corrupted
        # (attempt_once bumps the three failure counters itself).
        with m.env._lock:
            m.env.stats.submitted += 1
        try:
            out = m.env.attempt_once(task, context, attempt=round_i)
            with m.env._lock:
                m.env.stats.completed += 1
            return out
        except TaskError as e:
            err = e                    # recorded, but never a pool retry
            raise
        except BaseException as e:
            err = e
            counter = {"hang": "hung_attempts", "corrupt": "corrupt_attempts",
                       "fail": "failed_attempts"}[m.env.attempt_outcome(e)]
            self.stats.inc(**{counter: 1})
            raise
        finally:
            wall = time.monotonic() - a_t0
            outcome = m.env.attempt_outcome(err)
            with self._lock:
                m.inflight -= 1
                m.busy_s += wall
                if err is None:
                    m.completed += 1
                meta.setdefault("attempts", []).append({
                    "environment": m.name, "outcome": outcome,
                    "wall_s": wall,
                    "error": None if err is None
                    else f"{type(err).__name__}: {err}"})

    def submit_async(self, task: Task, context: Context) -> "cf.Future":
        """Future-returning variant of :meth:`submit_traced` — resolves to
        the same ``(output, meta)`` pair; the dataflow scheduler harvests
        completions as they land."""
        with self._lock:
            if self._dispatch_pool is None:
                self._dispatch_pool = cf.ThreadPoolExecutor(
                    max_workers=max(2, self.total_capacity),
                    thread_name_prefix=f"repro-{self.name}-dispatch")
        return self._dispatch_pool.submit(self.submit_traced, task, context)

    # --------------------------------------------------------------- fan-outs
    def map_explore(self, task: Task, contexts: Sequence[Context]
                    ) -> List[Context]:
        """Run one task over many contexts via lane-based work stealing.

        The contexts split into lanes; lanes are dealt to per-member deques
        proportionally to capacity; every member slot runs a worker that
        drains its own deque, then steals from the busiest other deque,
        then (speculation) duplicates the oldest unfinished lane. Failed
        lanes are requeued on another member with backoff. Results are
        assembled by lane index, so the output order — and, tasks being
        pure, the output *values* — are independent of the dispatch
        schedule: bit-exact vs. any single member and vs. the serial path.

        A fault-free member runs a lane of a ``torch`` task through its own
        ``map_explore``, all of the lane at once.

        Reentrant: ALL lane state (deques included) is local to this call,
        so any number of concurrent ``map_explore`` fan-outs may share one
        pool — they contend only for member capacity, never for each
        other's lanes.
        """
        contexts = list(contexts)
        if not contexts:
            return []
        n = len(contexts)
        lane_size = self.lane_size or max(
            1, -(-n // (2 * self.total_capacity)))
        lanes = [(i, contexts[lo:lo + lane_size])
                 for i, lo in enumerate(range(0, n, lane_size))]
        n_lanes = len(lanes)

        results: List[Optional[List[Context]]] = [None] * n_lanes
        lane_attempts = [0] * n_lanes
        lane_running: List[int] = [0] * n_lanes
        lane_banned: List[set] = [set() for _ in range(n_lanes)]
        lane_err: List[Optional[BaseException]] = [None] * n_lanes
        done = [0]
        ctx_done = [0]
        fatal: List[BaseException] = []
        cond = threading.Condition()
        self.stats.inc(submitted=n, in_flight=n)

        # per-CALL deques: this fan-out's lanes are invisible to any other
        # concurrent fan-out sharing the pool
        deques: Dict[_Member, collections.deque] = \
            {m: collections.deque() for m in self.members}
        # deal proportionally to capacity, round-robin over slots
        slots = [m for m in self.members for _ in range(m.capacity)]
        for i, lane in enumerate(lanes):
            deques[slots[i % len(slots)]].append(lane)

        def run_lane(m: _Member, lane, stolen: bool, speculated: bool):
            idx, ctxs = lane
            t0 = time.monotonic()
            try:
                if task.kind == "torch" and m.env.faults is None and \
                        len(ctxs) > 1:
                    # fault-free member: the whole lane through the
                    # member's own map_explore
                    with self._lock:
                        m.inflight += 1
                    batch_ok = False
                    try:
                        outs = m.env.map_explore(task, ctxs)
                        batch_ok = True
                    finally:
                        # A raised batch must NOT be credited a completion:
                        # drain_rate() = completed / busy_s steers the
                        # balancer, and crediting failures would rank a
                        # broken member as the fastest drain.
                        with self._lock:
                            m.inflight -= 1
                            m.busy_s += time.monotonic() - t0
                            if batch_ok:
                                m.completed += 1
                else:
                    outs = [self._attempt_on(m, task, c, lane_attempts[idx],
                                             {"attempts": []}) for c in ctxs]
                ok = True
            except TaskError as e:
                with cond:
                    # lane_running gates speculative duplication
                    # (lane_running[i] < self.speculative): every exit path
                    # must undo the worker's increment or the slot leaks.
                    lane_running[idx] -= 1
                    fatal.append(e)
                    cond.notify_all()
                return
            except Exception as e:
                ok = False
                lane_err[idx] = e
            wall = time.monotonic() - t0
            with cond:
                lane_running[idx] -= 1
                if ok:
                    if results[idx] is None:
                        results[idx] = outs
                        done[0] += 1
                        ctx_done[0] += len(outs)
                        self.stats.inc(completed=len(outs),
                                       in_flight=-len(outs))
                        if speculated:
                            self.stats.inc(speculative_wins=1)
                        if stolen:
                            self.stats.inc(lanes_stolen=1)
                    elif speculated:
                        self.stats.inc(speculative_losses=1)
                else:
                    lane_attempts[idx] += 1
                    # deprioritize the member that just failed this lane
                    lane_banned[idx].add(m.name)
                    if len(lane_banned[idx]) >= len(self.members):
                        lane_banned[idx].clear()   # all failed once: forgive
                    if lane_attempts[idx] > self.retries:
                        fatal.append(RuntimeError(
                            f"lane {idx} of {task.name} failed after "
                            f"{lane_attempts[idx]} attempts: {lane_err[idx]}"))
                    elif results[idx] is None:
                        # requeue on the least-loaded non-banned member
                        self.stats.inc(resubmissions=1)
                        cands = [o for o in self.members
                                 if o.name not in lane_banned[idx]] \
                            or [o for o in self.members if o is not m] or [m]
                        target = min(
                            cands,
                            key=lambda o: len(deques[o]) + o.inflight)
                        deques[target].append(lanes[idx])
                cond.notify_all()

        def worker(m: _Member):
            while True:
                lane = None
                stolen = speculated = False
                with cond:
                    if fatal or done[0] == n_lanes:
                        return
                    if deques[m]:
                        lane = deques[m].popleft()
                    else:
                        victim = max((o for o in self.members
                                      if o is not m and any(
                                          m.name not in lane_banned[ln[0]]
                                          for ln in deques[o])),
                                     key=lambda o: len(deques[o]),
                                     default=None)
                        if victim is not None:
                            # steal the newest lane this member may run
                            for ln in reversed(deques[victim]):
                                if m.name not in lane_banned[ln[0]]:
                                    deques[victim].remove(ln)
                                    lane = ln
                                    stolen = True
                                    break
                        elif self.speculative > 1:
                            # duplicate the oldest unfinished lane
                            pending = [i for i in range(n_lanes)
                                       if results[i] is None
                                       and lane_running[i] > 0
                                       and lane_running[i] < self.speculative]
                            if pending:
                                lane = lanes[pending[0]]
                                speculated = True
                    if lane is None:
                        if done[0] == n_lanes or fatal:
                            return
                        cond.wait(timeout=0.02)
                        continue
                    if results[lane[0]] is not None:
                        continue            # won while queued
                    if (m.name in lane_banned[lane[0]]
                            and len(lane_banned[lane[0]]) < len(self.members)):
                        # this member already failed this lane: hand it to a
                        # member that hasn't, rather than burning an attempt
                        cands = [o for o in self.members
                                 if o.name not in lane_banned[lane[0]]]
                        target = min(
                            cands,
                            key=lambda o: len(deques[o]) + o.inflight)
                        deques[target].append(lane)
                        cond.notify_all()
                        continue
                    lane_running[lane[0]] += 1
                run_lane(m, lane, stolen, speculated)

        threads = []
        for m in self.members:
            for _ in range(m.capacity):
                t = threading.Thread(target=worker, args=(m,), daemon=True)
                t.start()
                threads.append(t)
        with cond:
            while done[0] < n_lanes and not fatal:
                cond.wait(timeout=0.1)
        for m in self.members:              # wake injected-hang stragglers
            m.env.release_hangs()
        if fatal:
            # contexts never completed are no longer in flight: failed
            left = n - ctx_done[0]
            if left:
                self.stats.inc(failed=left, in_flight=-left)
            raise fatal[0]
        out: List[Context] = []
        for r in results:
            out.extend(r)                   # type: ignore[arg-type]
        return out

    def shutdown(self) -> None:
        """Release hangs and tear down member executors (tests/benches)."""
        for m in self.members:
            m.env.release_hangs()
            m.executor.shutdown(wait=False, cancel_futures=True)
        if self._dispatch_pool is not None:
            self._dispatch_pool.shutdown(wait=False, cancel_futures=True)

    def __repr__(self):
        return (f"EnvironmentPool({[m.name for m in self.members]}, "
                f"capacity={self.total_capacity})")
