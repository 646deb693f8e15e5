"""Injectable failure models for chaos-testing the environment layer,
copied from ``repro.core.faults`` (numpy only).

The paper's headline run — 200,000 individuals evaluated in one hour on EGI
— only works because the submission layer *assumes* jobs fail: grid nodes
vanish, queues hang, results arrive corrupted. ``FaultSpec`` makes those
failure modes injectable so the fault-tolerance machinery (resubmission,
oversubmission, work stealing — core/envpool.py) can be driven and asserted
deterministically:

- **fail**: the attempt raises ``InjectedFailure`` (a transient error, like
  a preempted grid node). Retried/resubmitted.
- **hang**: the attempt sleeps ``hang_s`` before completing (a stuck queue
  or straggler node). Detected by per-attempt timeouts and by speculative
  duplicate dispatch; the sleep is interruptible so test suites can never
  wedge on an injected hang.
- **corrupt**: the attempt completes but its payload is perturbed *after*
  the source-side fingerprint was taken (bit-rot in transit). Detected by
  the receiver recomputing the fingerprint (core/environment.py), treated
  as one more transient failure.

Decisions are **pure functions** of (seed, job key, attempt index): the
same spec injects the same faults on every rerun, which is what lets the
chaos suite assert bit-exact results and exact retry counts. PaPaS
(arXiv:1807.09632) uses the same per-environment abstraction for parameter
studies; WfCommons (arXiv:2105.14352) motivates recording the resulting
per-attempt traces (see TaskRecord.attempts in core/scheduler.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Optional

import numpy as np

from repro_torch.core.prototype import Context


class InjectedFailure(RuntimeError):
    """A FaultSpec-injected transient failure (grid node preemption)."""


class ResultCorruption(RuntimeError):
    """Receiver-side fingerprint mismatch: the result was tampered with in
    transit. Transient from the submitter's point of view — resubmit."""


def _unit(seed: int, kind: str, job: str, attempt: int) -> float:
    """Deterministic uniform draw in [0, 1) for one fault decision."""
    h = hashlib.sha256(f"{seed}|{kind}|{job}|{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Failure model of one environment, drawn deterministically per attempt.

    Attributes:
        fail_rate: probability an attempt raises ``InjectedFailure``.
        fail_limit: cap on *which* attempt indices may fail — ``1`` gives
            fail-once semantics (attempt 0 may fail, attempt 1 cannot),
            ``None`` lets every attempt fail (fail-always at rate 1.0).
        hang_rate / hang_limit: same, for hangs.
        hang_s: how long an injected hang sleeps (bounded — a test-suite
            safety property; real hangs are unbounded but a finite sleep
            past the caller's timeout exercises the identical code path).
        corrupt_rate / corrupt_limit: same, for in-transit corruption.
        latency_s: fixed per-attempt latency (environment heterogeneity —
            a slow queue, not a fault; applied before the fault decision).
        seed: decorrelates specs across pool members.
    """

    fail_rate: float = 0.0
    fail_limit: Optional[int] = None
    hang_rate: float = 0.0
    hang_limit: Optional[int] = 1
    hang_s: float = 2.0
    corrupt_rate: float = 0.0
    corrupt_limit: Optional[int] = 1
    latency_s: float = 0.0
    seed: int = 0

    def decide(self, job: str, attempt: int) -> str:
        """Fault decision for one attempt: 'hang' | 'fail' | 'corrupt' | 'ok'.

        Pure in (self, job, attempt) — replaying a workload replays its
        faults, which is what makes chaos tests assert exact retry counts.
        """
        if (self.hang_rate > 0.0
                and (self.hang_limit is None or attempt < self.hang_limit)
                and _unit(self.seed, "hang", job, attempt) < self.hang_rate):
            return "hang"
        if (self.fail_rate > 0.0
                and (self.fail_limit is None or attempt < self.fail_limit)
                and _unit(self.seed, "fail", job, attempt) < self.fail_rate):
            return "fail"
        if (self.corrupt_rate > 0.0
                and (self.corrupt_limit is None
                     or attempt < self.corrupt_limit)
                and _unit(self.seed, "corrupt", job, attempt)
                < self.corrupt_rate):
            return "corrupt"
        return "ok"


def corrupt_output(out: Context) -> Context:
    """Perturb one numeric value of an output Context (simulated bit-rot).

    The perturbation keeps types/shapes valid — corruption must survive
    ``Task.validate_outputs`` and only be caught by the fingerprint check,
    exactly like real in-transit corruption slipping past schema checks.
    """
    tampered = dict(out)
    for k in sorted(tampered, key=str):
        v = tampered[k]
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            tampered[k] = type(v)(v + 1)
            return Context(tampered)
        if isinstance(v, np.ndarray) and v.size and v.dtype.kind in "fiu":
            flipped = np.array(v, copy=True)
            flipped.flat[0] += 1
            tampered[k] = flipped
            return Context(tampered)
        if hasattr(v, "__array__"):
            try:
                arr = np.array(np.asarray(v), copy=True)
            except Exception:
                continue
            if arr.size and arr.dtype.kind in "fiu":
                arr.flat[0] += 1
                tampered[k] = arr
                return Context(tampered)
    # nothing numeric to tamper with: drop a key if possible, else no-op
    if tampered:
        tampered.pop(sorted(tampered, key=str)[0])
    return Context(tampered)


def interruptible_sleep(seconds: float,
                        event: Optional[threading.Event]) -> None:
    """Sleep up to ``seconds``, waking early when ``event`` is set — injected
    hangs must never be able to wedge a test suite past pool shutdown."""
    if seconds <= 0:
        return
    if event is None:
        threading.Event().wait(seconds)
    else:
        event.wait(seconds)
