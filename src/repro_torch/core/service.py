"""ExplorationService, an always-on multi-tenant execution service, ported
from ``repro.core.service``.

ONE ``EnvironmentPool`` shared by any number of concurrent experiments (GA
chunks, surrogate rounds, replication sweeps), fronted by the persistent
priority ``TaskQueue`` and backed by the content-addressed ``TaskCache``:

- ``submit_tasks(experiment_id, jobs, priority)`` enqueues firings; the
  task id is the firing's content address, so resubmission (same driver or
  a restarted one) is idempotent and completed work is never re-run.
- ``update_priorities`` re-ranks an experiment's still-pending work
  (OSPREY-style in-flight re-scoring as a queue primitive).
- ``as_completed`` / ``pop_completed`` / ``wait`` harvest results in
  completion order; ``query`` inspects queue state.
- Worker threads drain the queue: cache hit -> immediate completion; miss
  -> ``pool.submit_traced`` (cross-member resubmission, speculation,
  integrity verification) -> ``cache.put`` -> journal ``done``.

The tenants' jobs run on the pool's threads, so several tenants issue CUDA
work from their own threads at once; a job that makes its tensors on the
card hands them to the cache as they are (the disk copy pickles them with
their device, ``core/cache.py``).

Restart story: the queue journals submissions and completions to disk and
the cache pickles outputs per content address. Kill the driver mid-run,
build a new service on the same journal and cache directory, resubmit the
same jobs: completed firings resolve at once from the cache (provenance
mode ``"cache"``), only the remainder executes.

Provenance: every firing appends a ``TaskRecord`` (mode ``"service"``, or
``"cache"`` on a hit) to its experiment's ``RunRecord``.
"""
from __future__ import annotations

import collections
import threading
import time
from datetime import datetime, timezone
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.cache import (TaskCache, cache_key, fingerprint_task,
                              inputs_digest)
from repro_torch.core.prototype import Context
from repro_torch.core.scheduler import RunRecord, TaskRecord
from repro_torch.core.task import Task, TaskError
from repro_torch.core.taskqueue import DONE, FAILED, QueueEntry, TaskQueue


class ExplorationService:
    """Long-lived execution service over one shared environment pool.

    Args:
        pool: the shared execution backend: an ``EnvironmentPool`` or any
            single ``Environment`` (both expose ``submit_traced``).
        cache: :class:`TaskCache`, directory path, or None (in-memory
            cache). Disk-backed caches + a journal give restart-resume.
        journal: optional path for the queue's JSONL journal (see
            ``core/taskqueue.py`` for the format). None = in-memory queue.
        workers: service worker threads draining the queue (default: the
            pool's total capacity, min 2) — each worker drives one
            ``submit_traced`` at a time.
        name: service name in provenance records.
    """

    def __init__(self, pool, *, cache=None, journal: Optional[str] = None,
                 workers: Optional[int] = None, name: str = "service"):
        self.pool = pool
        if isinstance(cache, TaskCache):
            self.cache = cache
        elif isinstance(cache, str):
            self.cache = TaskCache(directory=cache)
        else:
            self.cache = TaskCache()
        self.queue = TaskQueue(journal)
        self.name = name
        self._t0 = time.monotonic()
        self._started_at = datetime.now(timezone.utc).isoformat()
        self._lock = threading.Lock()
        self._done_cond = threading.Condition(self._lock)
        self._results: Dict[str, Tuple[Optional[Context], Optional[str]]] = {}
        self._order: Dict[str, collections.deque] = {}   # completion order
        self._records: Dict[str, List[TaskRecord]] = {}
        self._fp_cache: Dict[int, str] = {}              # id(task) -> fp
        self._closed = False
        n_workers = workers or max(
            2, getattr(pool, "total_capacity", None)
            or getattr(pool, "capacity", 2))
        self._workers = [
            threading.Thread(target=self._worker, name=f"repro-svc-{i}",
                             daemon=True)
            for i in range(n_workers)]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------- submission
    def task_id(self, task: Task, context: Context) -> str:
        """Content address of one firing — fingerprint x inputs digest,
        identical to the TaskCache key (idempotence comes from here)."""
        fp = self._fp_cache.get(id(task))
        if fp is None:
            fp = fingerprint_task(task)
            self._fp_cache[id(task)] = fp
        return cache_key(fp, inputs_digest(task, context))

    def submit_tasks(self, experiment_id: str,
                     jobs: Iterable[Tuple[Task, Context]],
                     priority: float = 0.0) -> List[str]:
        """Enqueue ``(task, context)`` firings for one experiment.

        Returns the task ids in submission order (the driver's handle for
        ``update_priorities`` / ``as_completed`` / result assembly).
        Idempotent: resubmitting a finished firing completes instantly
        from the cache; resubmitting a pending/running one is a no-op.
        """
        if self._closed:
            raise RuntimeError(f"{self.name} is shut down")
        ids = []
        for task, ctx in jobs:
            tid = self.task_id(task, ctx)
            ids.append(tid)
            entry, _created = self.queue.submit(
                experiment_id, tid, priority, task, Context(ctx))
            if entry.state == DONE and not self._have_result(entry):
                # journaled-done from a previous driver: resolve from cache
                out = self.cache.get(tid)
                if out is not None:
                    self._complete(entry, out, rec_mode="cache",
                                   cache_hit=True, wall_s=0.0)
                else:                      # cache lost: run it again
                    self.queue.reset_pending(entry)
        return ids

    def update_priorities(self, experiment_id: str,
                          priorities: Dict[str, float]) -> int:
        """Re-rank an experiment's pending firings (higher = sooner)."""
        return self.queue.update_priorities(experiment_id, priorities)

    def submit_and_wait(self, experiment_id: str, task: Task,
                        context: Context, *, priority: float = 0.0,
                        timeout: Optional[float] = None
                        ) -> Tuple[str, Context]:
        """Submit ONE firing and block for its output — the per-request
        path of live-serving tenants: enqueue under
        ``priority``, wait, return ``(task_id, output)``. Terminal failure
        raises RuntimeError; the journal/cache idempotence story is
        identical to :meth:`submit_tasks`."""
        [tid] = self.submit_tasks(experiment_id, [(task, context)],
                                  priority=priority)
        out = self.wait(experiment_id, [tid], timeout=timeout)[tid]
        return tid, out

    # --------------------------------------------------------------- workers
    def _worker(self) -> None:
        while True:
            entry = self.queue.pop_next(timeout=0.2)
            if entry is None:
                if self._closed:
                    return
                continue
            if self._closed:
                self.queue.requeue(entry)
                return
            self._execute(entry)

    def _execute(self, entry: QueueEntry) -> None:
        hit = self.cache.get(entry.task_id)
        if hit is not None:
            self.queue.mark_done(entry, ok=True)
            self._complete(entry, hit, rec_mode="cache", cache_hit=True,
                           wall_s=0.0)
            return
        a_t0 = time.monotonic()
        try:
            out, meta = self.pool.submit_traced(entry.task, entry.context)
        except (TaskError, Exception) as e:  # terminal for this firing
            self.queue.mark_done(entry, ok=False,
                                 error=f"{type(e).__name__}: {e}")
            self._complete(entry, None, rec_mode="service", cache_hit=False,
                           wall_s=time.monotonic() - a_t0,
                           error=f"{type(e).__name__}: {e}")
            return
        self.cache.put(entry.task_id, out)
        self.queue.mark_done(entry, ok=True)
        self._complete(entry, out, rec_mode="service", cache_hit=False,
                       wall_s=meta.get("wall_s", 0.0),
                       retries=meta.get("retries", 0),
                       attempts=list(meta.get("attempts") or ()) or None)

    def _have_result(self, entry: QueueEntry) -> bool:
        with self._lock:
            return entry.key in self._results

    def _complete(self, entry: QueueEntry, out: Optional[Context], *,
                  rec_mode: str, cache_hit: bool, wall_s: float,
                  retries: int = 0, error: Optional[str] = None,
                  attempts: Optional[List[Dict[str, Any]]] = None) -> None:
        rec = TaskRecord(
            task=entry.task.name if entry.task is not None else "?",
            capsule=entry.seq,
            environment=getattr(self.pool, "name", "pool"),
            inputs_digest=entry.task_id, cache_key=entry.task_id,
            started_s=time.monotonic() - self._t0, wall_s=wall_s,
            retries=retries, cache_hit=cache_hit, mode=rec_mode,
            attempts=attempts)
        with self._lock:
            if entry.key in self._results:
                return                     # raced duplicate completion
            self._results[entry.key] = (out, error)
            self._order.setdefault(entry.experiment_id,
                                   collections.deque()).append(
                                       entry.task_id)
            self._records.setdefault(entry.experiment_id, []).append(rec)
            self._done_cond.notify_all()

    # -------------------------------------------------------------- harvesting
    def result(self, experiment_id: str, task_id: str) -> Optional[Context]:
        """The completed output of one firing (None if not finished);
        raises if the firing terminally failed."""
        with self._lock:
            got = self._results.get(f"{experiment_id}/{task_id}")
        if got is None:
            return None
        out, error = got
        if error is not None:
            raise RuntimeError(
                f"firing {task_id[:12]} of {experiment_id} failed: {error}")
        return out

    def pop_completed(self, experiment_id: str
                      ) -> List[Tuple[str, Optional[Context]]]:
        """Drain this experiment's completions since the last call, in
        completion order, as ``(task_id, output)`` (output None when the
        firing failed — see ``result`` for the error)."""
        with self._lock:
            q = self._order.get(experiment_id)
            drained = []
            while q:
                tid = q.popleft()
                out, _err = self._results[f"{experiment_id}/{tid}"]
                drained.append((tid, out))
            return drained

    def as_completed(self, experiment_id: str,
                     task_ids: Optional[Sequence[str]] = None,
                     timeout: Optional[float] = None
                     ) -> Iterator[Tuple[str, Optional[Context]]]:
        """Yield ``(task_id, output)`` in completion order until all of
        ``task_ids`` (default: everything submitted so far for this
        experiment) have been seen. One consumer per experiment — the
        completion-order queue is drained destructively.

        Raises:
            TimeoutError: ``timeout`` seconds elapsed with nothing new.
        """
        want: Optional[set] = set(task_ids) if task_ids is not None else None
        n_want = (len(want) if want is not None
                  else self._submitted_count(experiment_id))
        seen = 0
        while seen < n_want:
            got = None
            with self._done_cond:
                q = self._order.get(experiment_id)
                if q:
                    got = q.popleft()
                elif not self._done_cond.wait(timeout=timeout or 3600.0):
                    raise TimeoutError(
                        f"as_completed({experiment_id}): no completion "
                        f"within {timeout}s")
            if got is None:
                continue
            if want is not None and got not in want:
                continue                   # an earlier harvest's leftover
            seen += 1
            out, _err = self._results[f"{experiment_id}/{got}"]
            yield got, out

    def _submitted_count(self, experiment_id: str) -> int:
        q = self.queue.query(experiment_id)
        return sum(q.values())

    def wait(self, experiment_id: str, task_ids: Sequence[str],
             timeout: Optional[float] = None) -> Dict[str, Context]:
        """Block until every firing in ``task_ids`` finishes; return
        ``{task_id: output}``. Raises RuntimeError on the first terminally-
        failed firing, TimeoutError past ``timeout`` seconds."""
        targets = set(task_ids)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cond:
            while True:
                missing = [tid for tid in targets
                           if f"{experiment_id}/{tid}" not in self._results]
                if not missing:
                    break
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"wait({experiment_id}): {len(missing)} firings "
                        f"unfinished after {timeout}s")
                self._done_cond.wait(timeout=left if left is not None
                                     else 60.0)
        out: Dict[str, Context] = {}
        for tid in task_ids:
            res, err = self._results[f"{experiment_id}/{tid}"]
            if err is not None:
                raise RuntimeError(
                    f"firing {tid[:12]} of {experiment_id} failed: {err}")
            out[tid] = res
        return out

    # ------------------------------------------------------------- inspection
    def query(self, experiment_id: Optional[str] = None) -> Dict[str, int]:
        """Queue-state counts (pending/running/done/failed)."""
        return self.queue.query(experiment_id)

    def record(self, experiment_id: str) -> RunRecord:
        """WfCommons-style provenance of one experiment's firings so far."""
        with self._lock:
            tasks = list(self._records.get(experiment_id, ()))
        rec = RunRecord(workflow=experiment_id, scheduler="service",
                        environment=getattr(self.pool, "name", "pool"),
                        started_at=self._started_at, tasks=tasks)
        return rec.finalize(time.monotonic() - self._t0)

    # --------------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        """Stop the workers (claimed-but-unstarted work is requeued so a
        successor service on the same journal picks it up) and close the
        journal. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if wait:
            for t in self._workers:
                t.join(timeout=timeout)
        for m in getattr(self.pool, "members", ()):
            m.env.release_hangs()
        self.queue.close()

    def __enter__(self) -> "ExplorationService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
