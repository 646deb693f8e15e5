"""Dataflow schedulers: serial (reference) and asynchronous (production),
ported from ``repro.core.scheduler``, with its provenance records.

The paper's engine "transparently distributes the optimisation process":
capsules fire as soon as their input contexts arrive. This module implements
that as an event-driven scheduler over the workflow DAG:

- **Readiness** is per incoming transition: a capsule fires once every one
  of its incoming transitions has delivered (i.e. all upstream capsules
  completed). Independent branches share no transitions, so they fire
  concurrently on the scheduler's thread pool.
- **Execution** of one capsule consumes a list of input contexts. Multi-
  context ``torch`` capsules go through ``Environment.map_explore`` (lanes);
  multi-context ``py`` capsules fan out as futures via
  ``Environment.submit_async`` (thread pool, retry/speculation preserved);
  single contexts run inline on the capsule worker.
- **Memoization**: when a ``TaskCache`` is active, each (task fingerprint,
  inputs digest) firing is looked up first and skipped on a hit
  (core/cache.py), so repeated explorations and restarted runs only pay
  for new points.
- **Provenance**: every firing appends a ``TaskRecord`` (task, inputs
  digest, environment, wall time, retries, cache hit/miss) to the run's
  ``RunRecord``, exported as JSON with the reference's schema
  (``repro-run-record/v1``), so the port's ``provenance.json`` reads like
  the reference's.

Determinism: both schedulers assemble each capsule's inbox in the same
order — incoming transitions sorted by (topological index of source,
transition declaration index) — which is exactly the order the serial loop
produces. The async scheduler therefore yields results identical to
``scheduler="serial"`` for pure tasks, bit for bit on the card too, as long
as each task draws its random numbers from a generator it builds from its
inputs.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import datetime
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.cache import (TaskCache, cache_key, fingerprint_task,
                                    inputs_digest, resolve_cache)
from repro_torch.core.prototype import Context


@dataclasses.dataclass
class TaskRecord:
    """Provenance of one task firing (one input context through one task)."""
    task: str                      # task name
    capsule: int                   # capsule id (scheduling slot)
    environment: str               # environment name it ran on
    inputs_digest: str             # sha256 of the effective input context
    started_s: float               # offset from run start (monotonic)
    wall_s: float                  # execution wall time (0.0 for cache hits)
    retries: int                   # transient-failure retries consumed
    cache_hit: bool                # True when served from the memo cache
    mode: str                      # "submit" | "lanes" | "cache"
    cache_key: Optional[str] = None  # content address (None when cache off)
    attempts: Optional[List[Dict[str, Any]]] = None


@dataclasses.dataclass
class RunRecord:
    """Provenance of one workflow run — WfCommons-informed JSON export."""
    workflow: str
    scheduler: str
    environment: str
    started_at: str                            # ISO-8601 UTC
    makespan_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    tasks: List[TaskRecord] = dataclasses.field(default_factory=list)

    def finalize(self, makespan_s: float) -> "RunRecord":
        self.makespan_s = makespan_s
        self.cache_hits = sum(1 for t in self.tasks if t.cache_hit)
        self.cache_misses = sum(1 for t in self.tasks if not t.cache_hit)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "repro-run-record/v1",
            "workflow": self.workflow,
            "scheduler": self.scheduler,
            "environment": self.environment,
            "started_at": self.started_at,
            "makespan_s": self.makespan_s,
            "cache": {"hits": self.cache_hits, "misses": self.cache_misses},
            "tasks": [dataclasses.asdict(t) for t in self.tasks],
        }

    def save(self, path: str) -> None:
        """Write the record as JSON (directories created as needed)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


# ------------------------------------------------------------------- execution
def _fire_capsule(capsule, contexts, cenv, cache: Optional[TaskCache],
                  use_async: bool, run_t0: float
                  ) -> Tuple[List[Context], List[TaskRecord]]:
    """Run one capsule over its input contexts.

    Returns (merged output contexts, one TaskRecord per context). Cache
    lookups happen per context; only misses execute. Hooks fire on every
    merged context, hits included (hooks are observational, and a resumed
    run should display/save the same rows as the original).
    """
    task = capsule.task
    n = len(contexts)
    outs: List[Optional[Context]] = [None] * n
    recs: List[Optional[TaskRecord]] = [None] * n
    fp = fingerprint_task(task) if cache is not None else None
    misses: List[Tuple[int, str, Optional[str]]] = []
    for i, ctx in enumerate(contexts):
        digest = inputs_digest(task, ctx)
        key = cache_key(fp, digest) if cache is not None else None
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                outs[i] = hit
                recs[i] = TaskRecord(
                    task=task.name, capsule=capsule.id, environment=cenv.name,
                    inputs_digest=digest, cache_key=key,
                    started_s=time.monotonic() - run_t0, wall_s=0.0,
                    retries=0, cache_hit=True, mode="cache")
                continue
        misses.append((i, digest, key))

    if misses:
        miss_ctxs = [contexts[i] for i, _, _ in misses]
        if task.kind == "torch" and len(miss_ctxs) > 1:
            t0 = time.monotonic()
            lane_outs = cenv.map_explore(task, miss_ctxs)
            dt = time.monotonic() - t0
            for (i, digest, key), out in zip(misses, lane_outs):
                outs[i] = out
                recs[i] = TaskRecord(
                    task=task.name, capsule=capsule.id, environment=cenv.name,
                    inputs_digest=digest, cache_key=key,
                    started_s=t0 - run_t0, wall_s=dt, retries=0,
                    cache_hit=False, mode="lanes")
        else:
            if use_async and len(miss_ctxs) > 1:
                # harvest on completion events (not submission order): a
                # straggler point never blocks collection of the others;
                # results land by index so output order stays serial-exact.
                futures = {cenv.submit_async(task, c): j
                           for j, c in enumerate(miss_ctxs)}
                traced: List[Any] = [None] * len(miss_ctxs)
                for f in cf.as_completed(futures):
                    traced[futures[f]] = f.result()
            else:
                traced = [cenv.submit_traced(task, c) for c in miss_ctxs]
            for (i, digest, key), (out, meta) in zip(misses, traced):
                outs[i] = out
                recs[i] = TaskRecord(
                    task=task.name, capsule=capsule.id, environment=cenv.name,
                    inputs_digest=digest, cache_key=key,
                    started_s=meta["t0"] - run_t0, wall_s=meta["wall_s"],
                    retries=meta["retries"], cache_hit=False, mode="submit",
                    attempts=list(meta.get("attempts") or ()) or None)
        if cache is not None:
            for i, _digest, key in misses:
                cache.put(key, outs[i])

    merged = [ctx.merged(out) for ctx, out in zip(contexts, outs)]
    for m in merged:
        for h in capsule.hooks:
            h(m)
    return merged, recs  # type: ignore[return-value]


def _routed(transition, merged: List[Context]) -> List[Context]:
    """Apply one transition to a capsule's merged outputs; returns the
    contexts delivered to the destination (identical to the serial loop)."""
    from repro_torch.core.workflow import _aggregate
    flowing = [m for m in merged
               if transition.condition is None or transition.condition(m)]
    if transition.kind == "simple":
        return flowing
    if transition.kind == "exploration":
        return [m.merged(sample) for m in flowing
                for sample in transition.sampling.contexts(m)]
    if transition.kind == "aggregation":
        return [_aggregate(flowing)]
    raise ValueError(transition.kind)


# ------------------------------------------------------------------ schedulers
def run_workflow(workflow, initial: Context, environment, *,
                 scheduler: str = "async", cache=None,
                 max_workers: Optional[int] = None):
    """Execute ``workflow`` and return ``(results, RunRecord)``.

    Args:
        workflow: the Workflow DAG to execute.
        initial: seed Context delivered to every root capsule.
        environment: default Environment (per-capsule ``.on`` overrides win).
        scheduler: "async" (event-driven, concurrent branches) or
            "serial" (the reference topological loop; bit-exact baseline).
        cache: memoization control — see ``core.cache.resolve_cache``.
        max_workers: thread-pool width for the async scheduler (default:
            one thread per capsule, capped at 32).
    """
    cache = resolve_cache(cache)
    if scheduler == "serial":
        return _run_serial(workflow, initial, environment, cache)
    if scheduler == "async":
        return _run_async(workflow, initial, environment, cache, max_workers)
    raise ValueError(f"unknown scheduler {scheduler!r} "
                     "(expected 'async' or 'serial')")


def _run_serial(workflow, initial, environment, cache):
    """The paper-faithful reference loop: capsules in topological order,
    one at a time. Kept for bit-exact comparison against the async path."""
    order = workflow._topo_order()
    record = RunRecord(workflow=workflow.name, scheduler="serial",
                       environment=environment.name, started_at=_utcnow())
    run_t0 = time.monotonic()
    inbox: Dict[Any, List[Context]] = {c: [] for c in workflow.capsules}
    for c in order:
        if not any(t.dst is c for t in workflow.transitions):
            inbox[c].append(initial)
    results: Dict[Any, List[Context]] = {}
    for c in order:
        cenv = c.environment or environment
        merged, recs = _fire_capsule(c, inbox[c], cenv, cache,
                                     use_async=False, run_t0=run_t0)
        record.tasks.extend(recs)
        results[c] = merged
        for t in workflow.transitions:
            if t.src is c:
                inbox[t.dst].extend(_routed(t, merged))
    record.finalize(time.monotonic() - run_t0)
    return results, record


def _run_async(workflow, initial, environment, cache, max_workers):
    """Event-driven execution: a capsule is submitted to the pool the
    moment its last incoming transition delivers. Independent branches of
    the DAG overlap; inbox assembly order matches the serial loop, so the
    results are identical for pure tasks."""
    order = workflow._topo_order()
    topo_index = {c: i for i, c in enumerate(order)}
    transitions = workflow.transitions
    incoming: Dict[Any, List[int]] = {c: [] for c in workflow.capsules}
    outgoing: Dict[Any, List[int]] = {c: [] for c in workflow.capsules}
    for ti, t in enumerate(transitions):
        incoming[t.dst].append(ti)
        outgoing[t.src].append(ti)

    record = RunRecord(workflow=workflow.name, scheduler="async",
                       environment=environment.name, started_at=_utcnow())
    run_t0 = time.monotonic()
    pending = {c: len(incoming[c]) for c in workflow.capsules}
    segments: Dict[Any, Dict[int, List[Context]]] = \
        {c: {} for c in workflow.capsules}
    inboxes: Dict[Any, List[Context]] = {}
    results: Dict[Any, List[Context]] = {}
    cond = threading.Condition()
    done = [0]
    error: List[Optional[BaseException]] = [None]
    n_capsules = len(workflow.capsules)
    width = max_workers or min(32, max(1, n_capsules))
    executor = cf.ThreadPoolExecutor(max_workers=width,
                                     thread_name_prefix="repro-sched")

    def assemble_inbox(c) -> List[Context]:
        # serial-equivalent order: transitions sorted by (topo index of
        # their source, declaration index); roots get the initial context
        box: List[Context] = []
        if not incoming[c]:
            box.append(initial)
        for ti in sorted(incoming[c],
                         key=lambda ti: (topo_index[transitions[ti].src], ti)):
            box.extend(segments[c].get(ti, []))
        return box

    def worker(c):
        try:
            cenv = c.environment or environment
            merged, recs = _fire_capsule(c, inboxes[c], cenv, cache,
                                         use_async=True, run_t0=run_t0)
            routed = [(ti, _routed(transitions[ti], merged))
                      for ti in outgoing[c]]
            newly_ready = []
            with cond:
                record.tasks.extend(recs)
                results[c] = merged
                for ti, delivered in routed:
                    dst = transitions[ti].dst
                    segments[dst][ti] = delivered
                    pending[dst] -= 1
                    if pending[dst] == 0:
                        newly_ready.append(dst)
                done[0] += 1
                if error[0] is None:
                    for dst in newly_ready:
                        inboxes[dst] = assemble_inbox(dst)
                cond.notify_all()
            if error[0] is None:
                for dst in newly_ready:
                    executor.submit(worker, dst)
        except BaseException as e:           # noqa: BLE001 — repropagated
            with cond:
                if error[0] is None:
                    error[0] = e
                done[0] += 1
                cond.notify_all()

    roots = [c for c in order if not incoming[c]]
    for c in roots:
        inboxes[c] = assemble_inbox(c)
    for c in roots:
        executor.submit(worker, c)
    try:
        with cond:
            while done[0] < n_capsules and error[0] is None:
                cond.wait(timeout=0.1)
    finally:
        executor.shutdown(wait=False, cancel_futures=True)
    if error[0] is not None:
        raise error[0]
    record.finalize(time.monotonic() - run_t0)
    return results, record
