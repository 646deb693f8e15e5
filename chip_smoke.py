"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version on the card, drives the island-model calibration of the ants model
at the paper's full model size, measures one chunk of the streaming init,
and prints one JSON object per line.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build    nvcc builds every csrc/*.cu, one process per source at once.
  2. kernels  each kernel against its plain version at the main path's
              shapes, dominance also with the +BIG rows that ranking
              writes for empty slots (diffusion bitwise, dominance
              equal). "ms" is the kernel's time on the card
              (torch.profiler's CUDA kernel records), beside its plain
              version's and, where one PyTorch call computes the same
              thing, that call's; "call_ms" is the
              per-call time of back-to-back calls between CUDA events,
              which the host's launch cost sets for small kernels.
  3. parity   simulate_batch on the card against the CPU plain path, same
              Gumbel noise, REDUCED config: first-empty ticks equal.
  4. calibrate  launch.explore.calibrate(device="cuda", reduced=False) at
              the reference's defaults for 2 epochs, launch counts read
              around it; evaluation count and front checked.
  5. chunk    one replicated_batch(simulate_batch) chunk at CONFIG:
              4096 genomes x 5 replicates = 20480 lanes.
  6. the kernels line, the card's name and power limit, and the last line
     {"ok": true, "device": {...}}.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DIFFUSION_OPS_PER_PATCH = 30     # 8 x (2 mul + add) + 2 mul + mul, sub, add, mul


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def call_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Per-call time seen by a caller: median over ``reps`` samples of
    ``inner`` back-to-back calls between two CUDA events, after a warm-up.
    For a small kernel this is the host's launch cost, not the card's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def profiled(torch, fn, reps: int = 1):
    """(wall ms, summed CUDA kernel time ms) of ``reps`` calls of ``fn``
    under torch.profiler (CUPTI kernel records)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, busy_us / 1e3


def device_ms(torch, fn, reps: int = 20) -> float:
    """Time on the card per call of ``fn``: the summed time of the CUDA
    kernels it launches, averaged over ``reps`` calls after a warm-up."""
    for _ in range(3):
        fn()
    busy = profiled(torch, fn, reps)[1]
    require(busy > 0, "the profiler recorded no device time")
    return busy / reps


def device_busy_share(torch, fn) -> dict:
    """Run ``fn`` once under torch.profiler: the summed device time of the
    CUDA kernels over the wall time of the window."""
    wall, busy = profiled(torch, fn)
    return {"window_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.ants import model
    from repro_torch.configs.ants_netlogo import CONFIG, REDUCED
    from repro_torch.evolution import nsga2
    from repro_torch.kernels import build, diffusion, dominance, ops, ref
    from repro_torch.launch import explore

    t_start = time.monotonic()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. build ----------------------------------------------------------
    t0 = time.monotonic()
    secs = build.build()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "per_source_s": secs,
          "ptxas": {name: [line.strip() for line in build.build_log(name)
                           .splitlines() if "registers" in line]
                    for name in build.SOURCES}})

    # -- 2. kernels against their plain versions ----------------------------
    def field(n, w=72):
        chem = torch.rand((n, w, w), generator=gen, device=dev) * 100.0
        rate = torch.rand((n,), generator=gen, device=dev)
        evap = torch.rand((n,), generator=gen, device=dev) * 0.5
        return chem, rate, evap

    stencil = torch.ones((1, 1, 3, 3), device=dev)
    stencil[0, 0, 1, 1] = 0.0
    ncount = ref.neighbor_counts(72, dev)

    def library_diffusion(chem, rate, evap):
        share = chem * rate[:, None, None] * 0.125
        acc = F.conv2d(share[:, None], stencil, padding=1)[:, 0]
        return (chem - share * ncount + acc) * (1.0 - evap[:, None, None])

    results = {}
    for n in (640, 20480):
        chem, rate, evap = field(n)
        got = diffusion.diffuse_evaporate(chem, rate, evap)
        plain = ref.diffuse_evaporate_ref(chem, rate, evap)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        lib_err = (library_diffusion(chem, rate, evap) - plain).abs().max()
        require(torch.equal(got, plain), f"diffuse_evaporate bitwise at "
                f"({n},72,72), max abs err {err}")
        b_ms, b_by = bound_ms(2 * chem.numel() * 4 + 2 * n * 4,
                              chem.numel() * DIFFUSION_OPS_PER_PATCH)
        r = {"kernel": "diffuse_evaporate", "shape": [n, 72, 72],
             "bitwise": True, "max_abs_err": err,
             "ms": device_ms(torch, lambda: diffusion.diffuse_evaporate(
                 chem, rate, evap)),
             "call_ms": call_ms(torch, lambda: diffusion.diffuse_evaporate(
                 chem, rate, evap)),
             "plain_ms": device_ms(torch, lambda: ref.diffuse_evaporate_ref(
                 chem, rate, evap)),
             "library_ms": device_ms(torch, lambda: library_diffusion(
                 chem, rate, evap)),
             "library_max_abs_err": lib_err.item(),
             "bound_ms": b_ms, "bound_by": b_by}
        results[("diffuse_evaporate", n)] = r
        emit({"phase": "kernels", **r})

    def objectives(n):
        # first-empty ticks: integers in [0, 1000], many ties
        return torch.randint(0, 1001, (n, 3), generator=gen,
                             device=dev).to(torch.float32)

    # (rows, grouped, rows set to +BIG, those rows first): the GA pool ranks
    # 8 islands x 32 grouped; pareto_front ranks the 256-row archive with
    # its empty rows at +BIG; the first merge ranks the 256 empty archive
    # rows ahead of 64 new ones
    for n, grouped, n_big, big_first in (
            (256, True, 0, False), (128, True, 0, False),
            (256, False, 128, False), (320, False, 0, False),
            (320, False, 256, True), (2048, False, 0, False),
            (8192, False, 0, False)):
        rows = objectives(n)
        at = (torch.arange(n_big, device=dev) if big_first else
              torch.randperm(n, generator=gen, device=dev)[:n_big])
        rows[at] = nsga2.BIG
        groups = (torch.arange(8, device=dev, dtype=torch.int32)
                  .repeat_interleave(n // 8)) if grouped else None
        counts, bitmap = dominance.dominance_pass(rows, groups=groups)
        pc, pb = ref.dominance_pass_ref(rows, groups=groups)
        torch.cuda.synchronize()
        require(torch.equal(counts, pc) and torch.equal(bitmap, pb),
                f"dominance_pass equal at n={n} grouped={grouped} "
                f"big={n_big}")
        words = -(-n // 32)
        b_ms, b_by = bound_ms(
            2 * n * 3 * 4 + (2 * n * 4 if grouped else 0) + n * 4
            + n * words * 4, n * n * 2 * 3)
        r = {"kernel": "dominance_pass", "shape": [n, 3], "grouped": grouped,
             "big_rows": n_big, "equal": True, "max_abs_err": 0.0,
             "ms": device_ms(torch, lambda: dominance.dominance_pass(
                 rows, groups=groups)),
             "call_ms": call_ms(torch, lambda: dominance.dominance_pass(
                 rows, groups=groups)),
             "plain_ms": device_ms(torch, lambda: ref.dominance_pass_ref(
                 rows, groups=groups), reps=5),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        results[("dominance_pass", n, grouped, n_big)] = r
        emit({"phase": "kernels", **r})

    rows = objectives(2048)
    got = dominance.dominated_counts(rows)
    require(torch.equal(got, ref.dominated_counts_ref(rows)),
            "dominated_counts equal at n=2048")
    b_ms, b_by = bound_ms(2048 * 3 * 4 + 2048 * 4, 2048 * 2048 * 2 * 3)
    r = {"kernel": "dominated_counts", "shape": [2048, 3], "equal": True,
         "max_abs_err": 0.0,
         "ms": device_ms(torch, lambda: dominance.dominated_counts(rows)),
         "call_ms": call_ms(torch, lambda: dominance.dominated_counts(rows)),
         "plain_ms": device_ms(torch, lambda: ref.dominated_counts_ref(rows),
                               reps=5),
         "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    results[("dominated_counts", 2048)] = r
    emit({"phase": "kernels", **r})

    # -- 3. the card against the CPU plain path on a small input -------------
    rates = torch.tensor([10.0, 30.0, 50.0, 70.0, 90.0, 20.0, 60.0, 95.0])
    evaps = torch.tensor([5.0, 10.0, 20.0, 5.0, 40.0, 15.0, 2.0, 60.0])
    noise = model.draw_gumbel(torch.Generator().manual_seed(1),
                              (REDUCED.max_ticks, 8, REDUCED.population, 8),
                              "cpu")
    on_card = model.simulate_batch(REDUCED, rates.to(dev), evaps.to(dev),
                                   noise=noise.to(dev)).cpu()
    on_cpu = model.simulate_batch(REDUCED, rates, evaps, noise=noise)
    require(torch.equal(on_card, on_cpu),
            f"simulate_batch card vs CPU: {on_card.tolist()} vs "
            f"{on_cpu.tolist()}")
    emit({"phase": "parity", "config": "REDUCED", "lanes": 8,
          "ticks_empty_equal": True, "ticks_empty": on_card.tolist()})

    # -- 4. the main path: calibrate at the paper's model size ---------------
    flags = dict(n_islands=8, mu=16, lam=16, steps_per_epoch=4, epochs=2,
                 replicates=5, archive_size=256, merge_top_k=8)
    with tempfile.TemporaryDirectory() as out:
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, front = explore.calibrate(
            reduced=False, out_dir=out, device="cuda",
            printer=lambda s: emit({"phase": "calibrate", "log": s}),
            **flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(out).iterdir())
    n_sims = 1 + flags["epochs"] * flags["steps_per_epoch"]
    evals = flags["n_islands"] * (
        flags["epochs"] * flags["steps_per_epoch"] * flags["lam"]
        + flags["mu"])
    require(front["evaluations"] == evals == state.total_evaluations,
            f"evaluations {front['evaluations']} != {evals}")
    obj = torch.tensor(front["objectives"])
    gen_ = torch.tensor(front["genomes"])
    require(len(obj) > 0, "empty Pareto front")
    require(bool(torch.isfinite(obj).all()) and obj.min() >= 0
            and obj.max() <= CONFIG.max_ticks, "front objectives in range")
    require(bool(((gen_ >= 0) & (gen_ <= 99)).all()), "front genomes in bounds")
    require(not ref.dominance_pass_ref(obj)[0].any(),
            "front mutually non-dominated")
    require(launches["diffuse_evaporate"] == n_sims * CONFIG.max_ticks,
            f"diffuse_evaporate launches {launches['diffuse_evaporate']}")
    require(launches["dominance_pass"] > 0, "dominance_pass never launched")
    require({"pareto_front.json", "provenance.json", "populations"}
            <= set(files), f"outputs {files}")
    cal_cfg = dataclasses.replace(CONFIG, max_ticks=20)
    g640 = torch.rand((640,), device=dev, generator=gen) * 99
    cal_busy = device_busy_share(torch, lambda: model.simulate_batch(
        cal_cfg, g640, g640, generator=gen))
    emit({"phase": "calibrate", "config": "CONFIG", **flags,
          "wall_s": wall, "evaluations": evals,
          "evaluations_per_hour": evals / wall * 3600,
          "simulated_lane_ticks": n_sims * 640 * CONFIG.max_ticks,
          "front_size": len(obj), "launches": launches,
          "profile_20_ticks_640_lanes": cal_busy})

    # -- 5. one chunk of the streaming init ---------------------------------
    genomes = torch.rand((4096, 2), generator=gen, device=dev) * 99
    eval_fn = explore.ants_eval_fn(CONFIG, 5)
    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunk_obj = eval_fn(gen, genomes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(tuple(chunk_obj.shape) == (4096, 3)
            and bool(torch.isfinite(chunk_obj).all()), "chunk objectives")
    lanes = 4096 * 5
    chunk_busy = device_busy_share(torch, lambda: model.simulate_batch(
        cal_cfg, genomes.repeat_interleave(5, 0)[:, 0],
        genomes.repeat_interleave(5, 0)[:, 1], generator=gen))
    emit({"phase": "chunk", "config": "CONFIG", "genomes": 4096,
          "replicates": 5, "lanes": lanes, "wall_s": wall,
          "lane_ticks_per_s": lanes * CONFIG.max_ticks / wall,
          "evaluations_per_hour": 4096 / wall * 3600,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": ops.kernel_launch_counts(),
          "profile_20_ticks_20480_lanes": chunk_busy})

    # -- 6. the kernels line, the card, the contract line --------------------
    main_shapes = {"diffuse_evaporate": ("diffuse_evaporate", 640),
                   "dominance_pass": ("dominance_pass", 256, True, 0),
                   "dominated_counts": ("dominated_counts", 2048)}
    meta = {
        "diffuse_evaporate": ("src/repro_torch/csrc/diffusion.cu",
                              "src/repro/kernels/diffusion.py:89"),
        "dominance_pass": ("src/repro_torch/csrc/dominance.cu",
                           "src/repro/kernels/dominance.py:154"),
        "dominated_counts": ("src/repro_torch/csrc/dominance.cu",
                             "src/repro/kernels/dominance.py:101"),
    }
    kernels = []
    for name, key in main_shapes.items():
        r = results[key]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
