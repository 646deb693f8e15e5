"""Persistent priority task queue, the submission half of the always-on
exploration service (``core/service.py``), ported from
``repro.core.taskqueue``. Pure host code: it holds task payloads, never
touches a tensor, and writes the reference's journal format, so a journal
written by either package replays in the other.

Many experiments delegate jobs to one submission layer that outlives any
single driver; the queue makes that safe across driver restarts.
Submitters append work, workers drain it, and the two never meet.

- **Entries** are keyed ``(experiment_id, task_id)`` where ``task_id`` is
  the content address ``cache_key(fingerprint_task(task),
  inputs_digest(task, context))``, the same key the ``TaskCache`` memoizes
  under. The identity of a firing is its content address, so resubmission
  after a restart is idempotent by construction.
- **Priorities** are floats, higher runs sooner; ties break FIFO by
  submission sequence. ``update_priorities`` re-ranks *pending* entries
  only (running work is never preempted): the queue primitive that
  OSPREY-style in-flight re-scoring plugs into.
- **Persistence** is a JSONL append journal (one json object per line,
  keys sorted). Ops: ``submit`` (key, priority, seq, task name),
  ``priority`` (key, new priority), ``done`` (key, ok flag, error string).
  Task payloads (the function and its input Context) are not journaled:
  they are code, not data. On replay, entries not ``done`` come back
  *pending* (orphaned running work is requeued) but without a payload; the
  driver resubmits the same jobs and ``submit`` re-attaches payloads to the
  journaled entries under their original seq and priority. ``done`` entries
  stay done: their outputs live in the TaskCache. A torn last line (a crash
  mid-write) is skipped.

The queue is thread-safe: any number of submitter and worker threads may
operate concurrently; one internal Condition serializes state.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.prototype import Context
from repro_torch.core.task import Task

PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"


@dataclasses.dataclass
class QueueEntry:
    """One job in the queue (live, in-memory view of the journaled state)."""
    experiment_id: str
    task_id: str
    priority: float
    seq: int                       # global FIFO tiebreaker
    state: str = PENDING
    task: Optional[Task] = None    # payload — absent on a replayed entry
    context: Optional[Context] = None
    error: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.experiment_id}/{self.task_id}"


class TaskQueue:
    """Priority queue of task firings, journaled to disk.

    Args:
        journal: optional path to the JSONL journal. When the file already
            exists it is replayed: completed entries come back ``done``,
            everything else (including work that was running when the
            previous driver died) comes back ``pending`` awaiting an
            idempotent payload re-attach. ``None`` = in-memory only.
    """

    def __init__(self, journal: Optional[str] = None):
        self._cond = threading.Condition()
        self._entries: Dict[str, QueueEntry] = {}
        self._heap: List[Tuple[float, int, str]] = []  # (-priority, seq, key)
        self._seq = 0
        self._closed = False
        self.journal = journal
        self._journal_f = None
        if journal:
            os.makedirs(os.path.dirname(journal) or ".", exist_ok=True)
            if os.path.exists(journal):
                self._replay(journal)
            self._journal_f = open(journal, "a")

    # ------------------------------------------------------------ persistence
    def _replay(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue               # torn tail write: ignore
                key, op = rec.get("key"), rec.get("op")
                if op == "submit":
                    eid, tid = key.split("/", 1)
                    e = QueueEntry(eid, tid, float(rec["priority"]),
                                   int(rec["seq"]))
                    self._entries[key] = e
                    self._seq = max(self._seq, e.seq + 1)
                elif op == "priority" and key in self._entries:
                    self._entries[key].priority = float(rec["priority"])
                elif op == "done" and key in self._entries:
                    e = self._entries[key]
                    e.state = DONE if rec.get("ok", True) else FAILED
                    e.error = rec.get("error")
        # orphaned running work never journals "done": it is simply still
        # pending here. Payload-less pending entries wait for resubmission;
        # they are not pushed on the heap until a payload arrives.

    def _log(self, rec: Dict[str, Any]) -> None:
        # Callers hold self._cond, but guard the close() race anyway: a
        # live worker finishing a claim as the queue shuts down must drop
        # its journal line, not raise "I/O operation on closed file".
        if self._closed or self._journal_f is None:
            return
        try:
            self._journal_f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._journal_f.flush()
        except ValueError:                 # closed underneath us
            pass

    # -------------------------------------------------------------- submission
    def submit(self, experiment_id: str, task_id: str, priority: float = 0.0,
               task: Optional[Task] = None, context: Optional[Context] = None
               ) -> Tuple[QueueEntry, bool]:
        """Add one job, idempotently.

        Returns ``(entry, created)``. Resubmitting an existing key never
        duplicates work: a ``done`` entry is returned as-is (its output is
        in the TaskCache); a ``failed`` entry is reset to pending (restart
        retries failures); a payload-less replayed entry gets this payload
        attached and becomes runnable under its *journaled* seq/priority.
        """
        key = f"{experiment_id}/{task_id}"
        with self._cond:
            e = self._entries.get(key)
            if e is not None:
                attached = False
                if e.task is None and task is not None:
                    e.task, e.context = task, context
                    attached = True
                if e.state == FAILED and e.task is not None:
                    e.state, e.error = PENDING, None   # resubmit retries
                    attached = True
                if attached and e.state == PENDING:
                    heapq.heappush(self._heap, (-e.priority, e.seq, key))
                    self._cond.notify()
                return e, False
            e = QueueEntry(experiment_id, task_id, float(priority),
                           self._seq, task=task, context=context)
            self._seq += 1
            self._entries[key] = e
            self._log({"op": "submit", "key": key, "priority": e.priority,
                       "seq": e.seq,
                       "task": task.name if task is not None else None})
            if task is not None:
                heapq.heappush(self._heap, (-e.priority, e.seq, key))
                self._cond.notify()
            return e, True

    def update_priorities(self, experiment_id: str,
                          priorities: Dict[str, float]) -> int:
        """Re-rank pending entries of one experiment; running/done entries
        are untouched. Returns how many entries changed rank."""
        n = 0
        with self._cond:
            for tid, pri in priorities.items():
                key = f"{experiment_id}/{tid}"
                e = self._entries.get(key)
                # Non-pending entries keep both their state AND their
                # priority: re-scoring a running/done/failed entry would
                # journal a mutation the docstring promises never happens
                # (and a replay would resurrect it with the wrong rank).
                if e is None or e.state != PENDING or e.priority == pri:
                    continue
                e.priority = float(pri)
                self._log({"op": "priority", "key": key,
                           "priority": e.priority})
                n += 1
                if e.task is not None:
                    # lazy invalidation: stale heap items are skipped at pop
                    heapq.heappush(self._heap, (-e.priority, e.seq, key))
            if n:
                self._cond.notify_all()
        return n

    # ---------------------------------------------------------------- workers
    def pop_next(self, timeout: Optional[float] = None
                 ) -> Optional[QueueEntry]:
        """Claim the highest-priority runnable entry (marks it running).
        Blocks up to ``timeout`` (forever when None); returns None on
        timeout or when the queue has been closed."""
        with self._cond:
            while True:
                while self._heap:
                    neg_pri, seq, key = heapq.heappop(self._heap)
                    e = self._entries.get(key)
                    if (e is None or e.state != PENDING or e.task is None
                            or -neg_pri != e.priority or seq != e.seq):
                        continue           # stale heap item
                    e.state = RUNNING
                    return e
                if self._closed:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return None

    def mark_done(self, entry: QueueEntry, ok: bool = True,
                  error: Optional[str] = None) -> None:
        """Journal completion; ``ok=False`` records a terminal failure."""
        with self._cond:
            entry.state = DONE if ok else FAILED
            entry.error = error
            self._log({"op": "done", "key": entry.key, "ok": ok,
                       "error": error})
            self._cond.notify_all()

    def requeue(self, entry: QueueEntry) -> None:
        """Return a claimed entry to pending (worker shutdown mid-claim)."""
        with self._cond:
            if entry.state == RUNNING:
                entry.state = PENDING
                heapq.heappush(self._heap,
                               (-entry.priority, entry.seq, entry.key))
                self._cond.notify()

    def reset_pending(self, entry: QueueEntry) -> None:
        """Force a journaled-done entry back to pending — the service uses
        this when a ``done`` entry's cached output is unrecoverable (cache
        directory lost) and the firing must re-execute."""
        with self._cond:
            if entry.task is not None:
                entry.state = PENDING
                entry.error = None
                heapq.heappush(self._heap,
                               (-entry.priority, entry.seq, entry.key))
                self._cond.notify()

    # ----------------------------------------------------------------- queries
    def query(self, experiment_id: Optional[str] = None
              ) -> Dict[str, int]:
        """State counts, optionally restricted to one experiment."""
        out = {PENDING: 0, RUNNING: 0, DONE: 0, FAILED: 0}
        with self._cond:
            for e in self._entries.values():
                if experiment_id is None or e.experiment_id == experiment_id:
                    out[e.state] += 1
        return out

    def get(self, experiment_id: str, task_id: str) -> Optional[QueueEntry]:
        with self._cond:
            return self._entries.get(f"{experiment_id}/{task_id}")

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def close(self) -> None:
        """Wake blocked workers and close the journal file."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            if self._journal_f is not None:
                self._journal_f.close()
                self._journal_f = None
