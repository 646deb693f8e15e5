"""Execution environments — "Users are only expected to select the execution
environment for the tasks of the workflow ... switching from one environment
to another is achieved by modifying a single line" (paper §2.2). Ported from
``repro.core.environment``: the base ``Environment`` (retries, per-attempt
timeouts, injected faults, speculation, futures) and the thread-backed
``LocalEnvironment``. A task that launches work on the card does so from
the attempt's thread, on the caller's CUDA device.

GridScale's over-submission trick (submit a job to several queues, keep the
first result) survives as ``speculative`` execution for host-side PyTasks;
retries with backoff handle transient failures; ``map_explore`` runs an
exploration fan-out. ``DeviceEnvironment`` is a pool member that owns a
set of devices and runs each attempt on one of them;
``make_device_members`` splits the local devices into such members.
``MeshEnvironment`` shards an exploration's lanes over the ranks of a mesh,
and ``EGIEnvironment`` is the paper's name for the two-pod one.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.faults import (FaultSpec, InjectedFailure, ResultCorruption,
                               corrupt_output, interruptible_sleep)
from repro_torch.core.prototype import Context
from repro_torch.core.task import Task, TaskError


@dataclasses.dataclass
class EnvStats:
    submitted: int = 0
    completed: int = 0
    retried: int = 0
    speculative_wins: int = 0
    failed: int = 0        # attempts lost to (injected or real) failures
    hung: int = 0          # attempts abandoned past timeout_s
    corrupted: int = 0     # attempts rejected by fingerprint verification


class Environment:
    """Base execution environment: local execution with retry, speculation,
    and a futures-based async submission path for the dataflow scheduler.

    Args:
        retries: transient-failure retries per task submission (exponential
            backoff; ``TaskError`` declaration bugs never retry).
        backoff_s: base backoff between retries (doubles per attempt).
        speculative: >1 over-submits host-side PyTasks that many times and
            keeps the first result (GridScale's EGI trick).
        async_workers: thread-pool width for ``submit_async`` (default 8).
        capacity: concurrent-task slots this environment offers to an
            ``EnvironmentPool`` (core/envpool.py) — a 2-core worker vs a
            whole queue of grid slots.
        latency_s: fixed per-attempt submission latency (heterogeneous
            environments differ in queue latency, not only capacity).
        timeout_s: per-attempt wall-clock budget; an attempt exceeding it
            counts as hung and is resubmitted (the abandoned attempt's
            late result is discarded).
        faults: optional injectable failure model (core/faults.py) used by
            the chaos tests and the ``egi_200k_init`` benchmark.
        name: override the environment's display name (pool members need
            distinguishable names in provenance records).
    """

    name = "local"

    def __init__(self, *, retries: int = 2, backoff_s: float = 0.1,
                 speculative: int = 1, async_workers: int = 8,
                 capacity: int = 8, latency_s: float = 0.0,
                 timeout_s: Optional[float] = None,
                 faults: Optional[FaultSpec] = None,
                 name: Optional[str] = None):
        self.retries = retries
        self.backoff_s = backoff_s
        self.speculative = speculative
        self.async_workers = async_workers
        self.capacity = capacity
        self.latency_s = latency_s
        self.timeout_s = timeout_s
        self.faults = faults
        if name is not None:
            self.name = name
        self.stats = EnvStats()
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._async_pool: Optional[cf.ThreadPoolExecutor] = None
        self._attempt_pool: Optional[cf.ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        # Injected hangs sleep on this event so pool shutdown (or test
        # teardown) can wake stragglers instead of wedging on them.
        self._wake = threading.Event()
        # Per-attempt wake events of timeout-bounded attempts currently in
        # flight: an abandoned (timed-out) attempt is woken individually so
        # it cannot pin its _attempt_pool slot for the injected hang's full
        # duration. release_hangs() sets these too.
        self._attempt_wakes: set = set()

    # -- single task ---------------------------------------------------------
    def submit(self, task: Task, context: Context) -> Context:
        """Run one task synchronously (with retry/speculation).

        Args:
            task: the Task to execute.
            context: its input Context.

        Returns:
            The task's validated output Context (outputs only, not merged
            with the inputs — the workflow layer does the union).
        """
        return self.submit_traced(task, context)[0]

    def submit_traced(self, task: Task, context: Context
                      ) -> Tuple[Context, Dict[str, Any]]:
        """Like :meth:`submit`, but also returns execution metadata.

        Returns:
            ``(output, meta)`` where ``meta`` has keys ``retries`` (int),
            ``speculative`` (bool), ``t0`` (monotonic start time),
            ``wall_s`` (float), and ``attempts`` (one dict per attempt:
            environment, outcome, wall_s) — consumed by the scheduler's
            per-attempt provenance records (core/scheduler.py).
        """
        meta: Dict[str, Any] = {"retries": 0, "speculative": False,
                                "t0": time.monotonic(), "wall_s": 0.0,
                                "attempts": []}
        with self._lock:
            self.stats.submitted += 1
        if task.kind == "py" and self.speculative > 1:
            out = self._speculative_run(task, context, meta)
            meta["speculative"] = True
        else:
            out = self._run_with_retry(task, context, meta)
        with self._lock:
            self.stats.completed += 1
        meta["wall_s"] = time.monotonic() - meta["t0"]
        # Hand out a COPY: losing speculative attempts may still be running
        # and will append to the internal attempts list after we return —
        # they must not mutate meta already aliased into TaskRecords.
        out_meta = dict(meta)
        out_meta["attempts"] = [dict(a) for a in list(meta["attempts"])]
        return out, out_meta

    def submit_async(self, task: Task, context: Context) -> "cf.Future":
        """Submit one task to the environment's thread pool.

        Returns:
            A future resolving to ``(output Context, meta dict)`` exactly as
            :meth:`submit_traced` would return; the surrogate's ask/tell
            loop streams its evaluation jobs through it.
        """
        with self._lock:
            if self._async_pool is None:
                self._async_pool = cf.ThreadPoolExecutor(
                    max_workers=self.async_workers,
                    thread_name_prefix=f"repro-env-{self.name}")
        return self._async_pool.submit(self.submit_traced, task, context)

    # -- attempt machinery ---------------------------------------------------
    def _job_key(self, task: Task, context: Context) -> str:
        """Stable identity of one (task, inputs) job for fault decisions.
        Only computed when a FaultSpec is active (hashing costs)."""
        from repro_torch.core.cache import inputs_digest
        return f"{task.name}:{inputs_digest(task, context)}"

    def run_attempt(self, task: Task, context: Context, *, attempt: int = 0,
                    job: Optional[str] = None,
                    wake: Optional[threading.Event] = None
                    ) -> Tuple[Context, Optional[str]]:
        """Execute ONE attempt of a task on this environment.

        Applies the environment's latency and — when a :class:`FaultSpec`
        is installed — the deterministic fault decision for ``(job,
        attempt)``: injected failures raise, injected hangs sleep
        (interruptibly) before completing, injected corruption perturbs the
        output *after* the source-side fingerprint was taken.

        Args:
            wake: optional per-attempt event that interrupts this attempt's
                sleeps (in addition to the environment-wide ``_wake``);
                :meth:`attempt_once` sets it when it abandons the attempt
                at timeout so the executor slot drains promptly.

        Returns:
            ``(output, fingerprint)`` — fingerprint is the sha256 of the
            output as computed at the source, or None when no faults are
            active (verification is then unnecessary). The caller detects
            corruption by recomputing the fingerprint on receipt
            (:meth:`verify_result`).
        """
        w = wake if wake is not None else self._wake
        if self.latency_s:
            interruptible_sleep(self.latency_s, w)
        f = self.faults
        decision = "ok"
        if f is not None:
            job = job or self._job_key(task, context)
            decision = f.decide(job, attempt)
            if f.latency_s:
                interruptible_sleep(f.latency_s, w)
        if decision == "fail":
            raise InjectedFailure(
                f"injected failure: {task.name} attempt {attempt} "
                f"on {self.name}")
        if decision == "hang":
            interruptible_sleep(f.hang_s, w)
        out = task.run(context)
        if f is None:
            return out, None
        from repro_torch.core.cache import hash_context
        digest = hash_context(out)
        if decision == "corrupt":
            out = corrupt_output(out)
        return out, digest

    @staticmethod
    def verify_result(out: Context, digest: Optional[str]) -> Context:
        """Receiver-side integrity check: recompute the output fingerprint
        and reject mismatches as :class:`ResultCorruption` (transient —
        the caller resubmits)."""
        if digest is not None:
            from repro_torch.core.cache import hash_context
            if hash_context(out) != digest:
                raise ResultCorruption("output fingerprint mismatch")
        return out

    def release_hangs(self) -> None:
        """Wake every injected hang currently sleeping on this environment
        (pool shutdown / test teardown); late results are discarded by
        their abandoned futures."""
        self._wake.set()
        self._wake = threading.Event()
        with self._lock:
            wakes = list(self._attempt_wakes)
        for w in wakes:                    # timeout-bounded attempts sleep
            w.set()                        # on their own per-attempt event

    def attempt_once(self, task: Task, context: Context, *, attempt: int = 0,
                     job: Optional[str] = None) -> Context:
        """One timeout-bounded, integrity-verified attempt — the shared
        primitive under both the single-environment retry loop and the
        pool's cross-member resubmission (core/envpool.py).

        Raises:
            TimeoutError: the attempt exceeded ``timeout_s`` (counted as
                hung; the late result is discarded).
            ResultCorruption: receiver-side fingerprint mismatch.
            TaskError: declaration bug — callers must not retry it.
            Exception: whatever the task raised (counted as failed).
        """
        try:
            if self.timeout_s is not None:
                with self._lock:
                    if self._attempt_pool is None:
                        self._attempt_pool = cf.ThreadPoolExecutor(
                            max_workers=max(self.capacity, 2),
                            thread_name_prefix=f"repro-att-{self.name}")
                begun = threading.Event()
                wake = threading.Event()
                with self._lock:
                    self._attempt_wakes.add(wake)

                def _attempt():
                    begun.set()
                    return self.run_attempt(task, context, attempt=attempt,
                                            job=job, wake=wake)

                fut = self._attempt_pool.submit(_attempt)
                try:
                    # The timeout budget opens when the attempt BEGINS
                    # executing — time spent queued behind a saturated
                    # _attempt_pool does not count against it.
                    while not begun.wait(timeout=0.02):
                        if fut.done():
                            break          # raced a cancel/error: surface it
                    out, digest = fut.result(timeout=self.timeout_s)
                except cf.TimeoutError:
                    # Abandon the attempt AND drain its executor slot: the
                    # per-attempt wake interrupts its (injected-hang or
                    # latency) sleeps so the worker returns promptly and the
                    # fixed-width pool is not pinned by abandoned attempts.
                    wake.set()
                    fut.cancel()           # late result discarded
                    with self._lock:
                        self.stats.hung += 1
                    raise TimeoutError(
                        f"task {task.name} attempt {attempt} exceeded "
                        f"{self.timeout_s}s on {self.name}") from None
                finally:
                    with self._lock:
                        self._attempt_wakes.discard(wake)
            else:
                out, digest = self.run_attempt(task, context,
                                               attempt=attempt, job=job)
        except (TaskError, TimeoutError):
            raise
        except Exception:                  # transient (I/O, preemption)
            with self._lock:
                self.stats.failed += 1
            raise
        try:
            return self.verify_result(out, digest)
        except ResultCorruption:
            with self._lock:
                self.stats.corrupted += 1
            raise

    @staticmethod
    def attempt_outcome(err: Optional[BaseException]) -> str:
        """Classify an :meth:`attempt_once` exception for provenance."""
        if err is None:
            return "ok"
        if isinstance(err, TimeoutError):
            return "hang"
        if isinstance(err, ResultCorruption):
            return "corrupt"
        return "fail"

    def _run_with_retry(self, task: Task, context: Context,
                        meta: Optional[Dict[str, Any]] = None) -> Context:
        err = None
        job = self._job_key(task, context) if self.faults is not None else None
        for attempt in range(self.retries + 1):
            a_t0 = time.monotonic()
            try:
                out = self.attempt_once(task, context, attempt=attempt,
                                        job=job)
                self._note_attempt(meta, "ok", a_t0)
                return out
            except TaskError:
                raise                      # declaration bugs don't retry
            except Exception as e:
                err = e
            self._note_attempt(meta, self.attempt_outcome(err), a_t0, err)
            with self._lock:
                self.stats.retried += 1
            if meta is not None:
                meta["retries"] += 1
            interruptible_sleep(self.backoff_s * (2 ** attempt), self._wake)
        raise RuntimeError(
            f"task {task.name} failed after {self.retries + 1} attempts") \
            from err

    def _note_attempt(self, meta, outcome: str, a_t0: float,
                      err: Optional[BaseException] = None) -> None:
        if meta is None:
            return
        meta.setdefault("attempts", []).append({
            "environment": self.name, "outcome": outcome,
            "wall_s": time.monotonic() - a_t0,
            "error": None if err is None else f"{type(err).__name__}: {err}"})

    def _speculative_run(self, task: Task, context: Context,
                         meta: Optional[Dict[str, Any]] = None) -> Context:
        """First-result-wins over `speculative` duplicate submissions —
        straggler mitigation exactly as OpenMOLE over-submits on EGI."""
        with self._lock:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(max_workers=8)
            pool = self._pool
        job = self._job_key(task, context) if self.faults is not None else None

        def one(i):
            a_t0 = time.monotonic()
            try:
                out = self.attempt_once(task, context, attempt=i, job=job)
            except BaseException as e:
                self._note_attempt(meta, self.attempt_outcome(e), a_t0, e)
                raise
            self._note_attempt(meta, "ok", a_t0)
            return out

        futures = [pool.submit(one, i) for i in range(self.speculative)]
        err = None
        for f in cf.as_completed(futures):
            try:
                result = f.result()
                with self._lock:
                    self.stats.speculative_wins += 1
                for other in futures:
                    other.cancel()
                return result
            except Exception as e:
                err = e
        raise RuntimeError(f"all speculative copies of {task.name} failed") \
            from err

    # -- exploration fan-outs ------------------------------------------------
    def map_explore(self, task: Task, contexts: Sequence[Context]
                    ) -> List[Context]:
        """Run one task over many contexts (an exploration fan-out).

        Returns a list of output Contexts in the same order. The base
        environment runs them one by one, one submit per context, as the
        reference's does; an ``EnvironmentPool`` deals them out as lanes.
        """
        return [self.submit(task, c) for c in contexts]

    def jit(self, fn, **kw):
        """The identity: PyTorch runs eagerly, so there is nothing to
        compile (kept so that callers written for the reference's
        interface run unchanged)."""
        return fn

    def __repr__(self):
        return f"{type(self).__name__}()"


class LocalEnvironment(Environment):
    pass


# ---------------------------------------------------------------------------
# Device-set pool members
# ---------------------------------------------------------------------------
_PINNED = threading.local()


def pinned_device() -> Optional[torch.device]:
    """The device the calling thread's current attempt is pinned to by a
    ``DeviceEnvironment``, or None outside one."""
    return getattr(_PINNED, "device", None)


@contextlib.contextmanager
def _pin(device: torch.device):
    """Run the block on ``device``: it becomes this thread's current CUDA
    device (CUDA's current device is per thread), so a task that makes its
    tensors on the bare ``"cuda"`` device makes them there."""
    before = pinned_device()
    _PINNED.device = device
    try:
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield
    finally:
        _PINNED.device = before


def local_devices(device="cuda") -> List[torch.device]:
    """Every local device of ``device``'s type: each CUDA card (raises
    without one), or the CPU."""
    from repro_torch.runtime.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [torch.device(dev.type)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceEnvironment(Environment):
    """A pool member that owns a **set of local devices** (ported from the
    reference's ``DeviceEnvironment``).

    * attempts (``run_attempt``: the streaming init's chunk jobs, the
      surrogate's evaluation jobs) run with one of the member's devices,
      picked round-robin under the lock, as the worker thread's current
      CUDA device. A task that names a fixed device index escapes the pin:
      tasks make their tensors on the bare ``"cuda"`` device;
    * batched ``TorchTask`` lanes (``map_explore``) split into contiguous
      blocks, one per device, when they divide evenly, and otherwise run
      on one device, round-robin; ``last_lane_devices`` records where.

    Every knob of ``Environment`` applies unchanged. ``capacity`` defaults
    to ``2 * len(devices)``, so each device keeps one attempt in flight
    while the next waits.
    """

    def __init__(self, devices: Sequence[Any], *,
                 capacity: Optional[int] = None, **kw):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("DeviceEnvironment requires at least one device")
        kw.setdefault("name", "dev[" + ",".join(map(_device_id, devices))
                      + "]")
        super().__init__(capacity=(2 * len(devices) if capacity is None
                                   else capacity), **kw)
        self.devices = devices
        self._rr_cursor = 0
        self.last_lane_devices: Optional[Tuple[torch.device, ...]] = None

    def _next_device(self) -> torch.device:
        with self._lock:
            d = self.devices[self._rr_cursor % len(self.devices)]
            self._rr_cursor += 1
        return d

    def run_attempt(self, task: Task, context: Context, *, attempt: int = 0,
                    job: Optional[str] = None,
                    wake: Optional[threading.Event] = None
                    ) -> Tuple[Context, Optional[str]]:
        with _pin(self._next_device()):
            return super().run_attempt(task, context, attempt=attempt,
                                       job=job, wake=wake)

    def map_explore(self, task: Task, contexts: Sequence[Context]
                    ) -> List[Context]:
        """``TorchTask`` lanes placed on the member's own devices."""
        if task.kind != "torch" or not contexts:
            return super().map_explore(task, contexts)
        n, devs = len(contexts), self.devices
        if len(devs) > 1 and n % len(devs) == 0:
            b = n // len(devs)
            blocks = [(d, contexts[i * b:(i + 1) * b])
                      for i, d in enumerate(devs)]
        else:
            blocks = [(self._next_device(), list(contexts))]
        out = []
        for d, block in blocks:
            with _pin(d):
                out.extend(task.run(c) for c in block)
        self.last_lane_devices = tuple(d for d, _ in blocks)
        with self._lock:
            self.stats.submitted += n
            self.stats.completed += n
        return out

    def __repr__(self):
        return (f"DeviceEnvironment(devices=["
                f"{','.join(map(_device_id, self.devices))}])")


def _device_id(d: torch.device) -> str:
    return str(d.index) if d.index is not None else d.type


def make_device_members(devices=None, k: int = 2, *, device="cuda",
                        **kw) -> List[DeviceEnvironment]:
    """Split the local devices into ``k`` disjoint ``DeviceEnvironment``
    pool members, contiguously, the remainder to the earliest members.

    devices: a device sequence, a ``runtime.sharding.Mesh`` (this rank's
    device), or None for every local device of ``device``'s type
    (``local_devices``). ``**kw`` goes to every member; ``faults`` may be a
    callable ``i -> FaultSpec`` for per-member seeds. Members are named
    ``dev{i}[ids]``."""
    from repro_torch.runtime.sharding import Mesh
    if devices is None:
        devices = local_devices(device)
    elif isinstance(devices, Mesh):
        devices = [devices.device]
    devices = [torch.device(d) for d in devices]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > len(devices):
        raise ValueError(
            f"cannot partition {len(devices)} device(s) into {k} members")
    faults = kw.pop("faults", None)
    q, r = divmod(len(devices), k)
    members, start = [], 0
    for i in range(k):
        sub = devices[start:start + q + (1 if i < r else 0)]
        start += len(sub)
        members.append(DeviceEnvironment(
            sub, name=f"dev{i}[{','.join(map(_device_id, sub))}]",
            faults=faults(i) if callable(faults) else faults, **kw))
    return members


# ---------------------------------------------------------------------------
# Mesh environments
# ---------------------------------------------------------------------------
class MeshEnvironment(Environment):
    """Delegates ``TorchTask``s to the ranks of a mesh
    (``runtime.sharding.Mesh``): an exploration's contexts become lanes
    sharded over the data axes, one grid job a lane (the reference's
    ``MeshEnvironment``).

    ``mesh=None`` builds the production mesh
    (``launch.mesh.make_production_mesh``: 16 x 16 ranks, 2 x 16 x 16 with
    ``multi_pod``) on ``device``; it raises in a process group of another
    size. ``jit`` installs the mesh (``runtime.sharding.use_mesh``) around
    the call.

    ``map_explore`` of a ``TorchTask`` stacks the contexts' values into
    lanes, as the reference does; ragged contexts (other keys, values that
    do not stack) and other tasks go to the base class. The lane axis
    resolves by the ``"island"`` rule over the mesh (``logical_to_spec``).
    Sharded lanes: each rank runs its contiguous block of the contexts on
    its device, one context at a time, then the outputs are all-gathered,
    so every rank returns every context's outputs, in order; tensors come
    back on this rank's device. Replicated lanes (a one-rank mesh, or a
    lane count that does not divide over the data axes): every rank runs
    every context. ``last_lanes`` is the range of contexts this rank ran.

    Not vmapped: the reference runs the lanes as one ``jax.vmap``ped
    program. A ``TorchTask`` draws from a ``torch.Generator`` built inside
    its function, which ``torch.func.vmap`` cannot batch, so a block runs
    context by context.
    """

    def __init__(self, mesh=None, *, multi_pod: bool = False,
                 device="cuda", **kw):
        super().__init__(**kw)
        if mesh is None:
            from repro_torch.launch.mesh import make_production_mesh
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        self._mesh = mesh
        self.name = "multipod" if multi_pod else "pod"
        self.last_lanes: Optional[range] = None

    @property
    def mesh(self):
        return self._mesh

    def jit(self, fn, **kw):
        from repro_torch.runtime.sharding import use_mesh
        mesh = self._mesh

        def wrapped(*args, **kwargs):
            with use_mesh(mesh):
                return fn(*args, **kwargs)

        return wrapped

    def map_explore(self, task: Task, contexts: Sequence[Context]
                    ) -> List[Context]:
        from repro_torch.runtime.sharding import logical_to_spec, use_mesh
        if task.kind != "torch" or not contexts:
            return super().map_explore(task, contexts)
        names = sorted(contexts[0].keys())
        if any(sorted(c.keys()) != names for c in contexts):
            return super().map_explore(task, contexts)   # ragged -> host
        try:
            batched = {k: torch.stack([torch.as_tensor(c[k])
                                       for c in contexts]) for k in names}
        except (TypeError, ValueError, RuntimeError):
            return super().map_explore(task, contexts)
        n, mesh = len(contexts), self._mesh
        shape = next(iter(batched.values())).shape if batched else (n,)
        with use_mesh(mesh):
            lane = logical_to_spec(("island",) + (None,) * (len(shape) - 1),
                                   shape, mesh)[0]
        if lane is None:
            start, stop = 0, n
        else:
            axes = (lane,) if isinstance(lane, str) else lane
            block = n // math.prod(mesh.shape[a] for a in axes)
            start = _lane_shard(mesh, axes) * block
            stop = start + block
        with _pin(mesh.device):
            mine = [task.run(c) for c in contexts[start:stop]]
        self.last_lanes = range(start, stop)
        out = mine if lane is None else _gather_lanes(mesh, mine, start, n)
        with self._lock:
            self.stats.submitted += n
            self.stats.completed += n
        return out

    def __repr__(self):
        return f"MeshEnvironment(mesh={self._mesh.shape})"


def _lane_shard(mesh, axes) -> int:
    """This rank's index along the mesh axes ``axes`` (mesh order, major
    first): rank r sits at flat position r of the row-major mesh."""
    coord, r = {}, mesh.rank
    for name, size in reversed(mesh.axes):
        coord[name] = r % size
        r //= size
    shard = 0
    for a in axes:
        shard = shard * mesh.shape[a] + coord[a]
    return shard


class _Sent(NamedTuple):
    """A tensor output on its way to the other ranks: a host copy (its
    bits unchanged) and whether it was off the CPU."""
    tensor: torch.Tensor
    on_device: bool


def _send(v):
    if isinstance(v, torch.Tensor):
        return _Sent(v.cpu(), v.device.type != "cpu")
    return v


def _receive(v, device):
    if not isinstance(v, _Sent):
        return v
    return v.tensor.to(device) if v.on_device else v.tensor


def _gather_lanes(mesh, mine: List[Context], start: int, n: int
                  ) -> List[Context]:
    """Every rank's block of outputs, in lane order, on every rank: one
    ``all_gather_object`` over the mesh's ranks. Tensors travel as host
    copies and land on this rank's device; ranks that hold the same block
    (replicated over the mesh's other axes) send equal blocks, and the
    first is kept."""
    import torch.distributed as dist
    sent = [{k: _send(v) for k, v in c.items()} for c in mine]
    got: List[Any] = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(got, (start, sent), group=mesh.group)
    out: List[Optional[Context]] = [None] * n
    for s, block in got:
        for i, c in enumerate(block):
            if out[s + i] is None:
                out[s + i] = Context({k: _receive(v, mesh.device)
                                      for k, v in c.items()})
    out[start:start + len(mine)] = mine
    return out


def EGIEnvironment(*args, **kw):
    """The paper's ``EGIEnvironment("biomed", ...)``: on cards the closest
    analogue is the two-pod mesh. The grid's own arguments (the VO,
    ``openMOLEMemory``, ``wallTime``) are dropped, so the paper's listings
    port line for line."""
    kw.pop("vo", None)
    kw.pop("openMOLEMemory", None)
    kw.pop("wallTime", None)
    return MeshEnvironment(multi_pod=True, **kw)
