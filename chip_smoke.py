"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version on the card, drives the island-model calibration and the
surrogate-assisted calibration of the ants model at the paper's full model
size, the surrogate's archive-scale fit at 50,000 points, the streaming
init through the fault-tolerant pool seeding a pipelined island run, the
GP factorization sweep, flash attention at smollm-135m's full width and the
paper's Listings 2-5 through the workflow DSL, the island run over two
ranks, the multi-objective qEHVI surrogate, the exploration service with
its two tenants, LM serving (smollm-135m at full width, every arch of
the zoo at REDUCED, four at CONFIG), LM training (smollm-135m at full
width), bandit-routed serving with the surrogate loop, explorations
through MeshEnvironment and tasks packaged through torch.export, and
prints one JSON object per line.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build    nvcc builds every csrc/*.cu, one process per source at once;
              a second build line lists each flash kernel's registers,
              spills, dynamic shared memory (bf16) and HGMMA/HMMA count
              from cuobjdump -sass (a bf16 kernel with none fails, and so
              does a spill of the f32 dQ kernel at any D); a third
              the same of cholesky.cu's kernels (registers, spills, dynamic
              shared memory), which must be exactly the expected four; a
              fourth the registers and spills of diffusion.cu's and
              trisolve.cu's kernels, which must be exactly the expected
              seven; a fifth the registers, spills, static shared memory
              and SASS opcode counts (DOMINANCE_OPCODES) of dominance.cu's
              kernels, which must be exactly the expected 29; a sixth the
              registers, spills, static shared memory, MUFU count and row
              loop's SASS instructions of gp.cu's kernels, which must be
              exactly the expected 15 (gp_build_report).
  2. package  two tasks packaged through torch.export on the card
              (core/packaging.py), saved, loaded back without their code
              and run: the ants model's apply form at CONFIG's world, 640
              lanes, PACKAGE_TICKS ticks, and one dominance_pass over 2048
              rows; each bitwise equal to the direct run, launching B1 (once
              a tick) or B2 (once) through its custom op (the "package"
              path; see package_phase), in a child process started
              before the build, whose exports overlap it (PackageChild).
  3. kernels  each kernel against its plain version at the main paths'
              shapes, dominance also with the +BIG rows that ranking
              writes for empty slots (diffusion and the GP assembly
              bitwise, dominance equal, the triangular solve and the
              blocked Cholesky within stated tolerances, the fused
              assemble-and-factor bitwise equal to the blocked Cholesky of
              the plainly assembled matrix, and ops.chol_factor / gp_chol,
              which pad only to a multiple of 64 on the card, bitwise equal
              to the factor padded to the block). "ms" is the kernel's time on
              the card (torch.profiler's CUDA kernel records), beside its
              plain version's and, where one PyTorch call computes the
              same thing, that call's (the GP assembly also beside its
              issue floor, at the gp_chol path's shape too, and its
              launch from gp.launch_config); "call_ms" is the per-call time of
              back-to-back calls between CUDA events, which the host's
              launch cost sets for small kernels. For the blocked
              Cholesky (two streams, two launches per 64-wide step), "ms"
              and "library_ms" (cuSOLVER) are the wrapper's and
              cholesky_ex's times between CUDA events, taken in turns
              (median of 20 samples, with min and max), beside the
              profiler's summed kernel time, the union of its kernel
              intervals, and the time by kernel (factor_timing). For the
              diffusion stencil and the triangular solve, "ms" and
              "library_ms" (F.conv2d; trsm) are medians of 20 samples taken
              in turns, each sample 10 (library 3) back-to-back calls
              queued behind a spinning card (turns_ms with hold_cycles),
              so that they read the card's time and not the host's launch
              cost; beside them the stencil's GB/s and both kernels' share
              of their bound, the profiler's time ("profiler_ms" for the
              stencil; for the solve its two kernels, the pack kernel with
              the diagonal tiles' inverses and the solve, by kernel), and
              the stencil once more on its cp.async route (a world of odd
              width; a field off a 16-byte boundary). B2 and B3 have no
              library call: "ms" is the median of 20 queued samples of 10
              calls, beside the profiler's time, the bound and the issue
              floor (the pairs over the rate of B2's inner loop alone, from
              dominance.issue_probe, which also runs the same pairs as float
              compares); then the section 4.5 sorting benchmark's ranking
              (8192 x 3 uniform): the fused ranking and the peeling
              baseline, ranks equal, ms a ranking, the kernel's share,
              fronts, launch counts read around one of each (the
              "ranking" path of the kernels line); last, the host time a
              call of B1 and B2 through its custom op adds to a direct
              call of its launcher (custom_op_overhead).
  4. parity   simulate_batch on the card against the CPU plain path, same
              Gumbel noise, REDUCED config: first-empty ticks equal; and
              gp_fit on the card against the CPU plain path at n = 80.
  5. calibrate  launch.explore.calibrate(device="cuda", reduced=False) at
              the reference's defaults for 2 epochs, launch counts read
              around it; evaluation count and front checked.
  6. surrogate  launch.explore.calibrate_surrogate(device="cuda",
              reduced=False) through the environment pool: 3 rounds of q=8
              (2 Sobol, 1 GP; depth cut from 4 to make room for phases
              train and bandit), launch counts read around it. At CONFIG every
              evaluation returns the 1000-tick cap, in the reference as in
              the port (tests/test_torch_surrogate.py holds the two equal
              there): the GP rounds fit a constant objective, so this phase
              shows that the path runs through the pool and the kernels, not
              that the GP steers. Then the same run's first round
              through a pool of one worker of one slot (the same rows
              required), and 6
              evaluations cut to 100 ticks under torch.profiler through
              both pools: where the pool's wall time goes.
  7. surrogate_big  a SurrogateExplorer on the card holding 50,000 told
              points of the archive benchmark's synthetic objective: a
              cold ask (the inducing-point fit: gp_sqdist and tri_solve),
              a tell of 8, a warm ask; launch counts read around it.
  8. chunk    one replicated_batch(simulate_batch) chunk at CONFIG:
              4096 genomes x 5 replicates = 20480 lanes.
  9. init     the streaming init at CONFIG, 5 replicates, chunks of 4096
              genomes, 14336 individuals: inline, through the 3 x 2 pool at
              35 % injected failures, and stopped after 2 chunks then
              resumed (all three bitwise equal); walls, evaluations/hour,
              the pool leg's peak memory, the idle share over one chunk,
              the 200k wall projected; then calibrate seeded by that init
              through the pool, pipelined, for 2 epochs, launch counts read
              around it (see init_phase).
 10. gp_chol  the archive-scale GP factorization of the reference's
              bench_gp_chol at full size: 4096 points in 8 dimensions,
              Matern-5/2, nugget 1e-4, block 512, five lengthscales, one
              ops.gp_chol each (the fused kernel), then the same sweep
              assembled by ops.gp_matrix and factored by ops.chol_factor
              (bitwise the same factors required); each factor within 2e-4
              of cuSOLVER's of the assembled matrix; launch counts read
              around both sweeps.
 11. flash    the four flash-attention kernels (B8; B9's forward, dQ and
              dK/dV) through ops.flash_attention_gqa / _or_ref / _gqa_diff
              and a smollm-135m GQA layer's gqa_apply(allow_flash=True), at
              the model's full width (H 9, KH 3, D 64), (4, 4096) in bf16
              and f32 and (1, 32768) in bf16; launch counts read around the
              path, the f32 ones apart (one launch of each wrapper, its own
              rows in the kernels line); each kernel against its plain
              version (the 32k forward
              against SDPA), the layer against its _sdpa branch; times
              beside the bound, each kernel in turns with SDPA (median and
              min/max), and the layer's time split into projections + RoPE,
              copies and the kernel (see flash_phase).
 12. dsl      the paper's Listings 2-5 written against the port's
              workflow DSL at CONFIG: Listing 2 (one TorchTask run, equal to
              a direct simulate, 1000 diffuse_evaporate launches), Listing 3
              (seed replication + median, serial == async == cached bitwise,
              no launch from the cache), both also on a cut REDUCED world
              whose first source empties within 60 ticks (there Listing 3
              also runs through a pool that fails every first attempt),
              Listing 4 (run_generational at mu 10, lam 10, 5 replicates, 10
              generations), Listing 5 (an island capsule on an environment,
              its saved population equal to the archive), the two kernels
              against their plain versions at those shapes, dominance_pass
              also on seeded objectives with ties and +BIG rows, launch
              counts read around each Listing (the "dsl" path of the
              kernels line; see dsl_phase).
 13. mesh     several ranks on the one card: two spawned processes joined
              by gloo, both on cuda:0, run the row-sharded dominance sweep
              at three shapes (8192 x 3; the archive merge's 320-row pool;
              997 rows in 3 groups, padded) equal to the single pass and
              its plain version, each rank's rectangular launch against its
              plain version and timed, and calibrate over a data=2 mesh
              bitwise equal to phase calibrate's one-rank run; then the
              streaming init through make_init_pool(0.35, pool_devices=1),
              bitwise equal to phase init's inline leg; MeshEnvironment
              exploring an ants TorchTask over the two ranks and over one,
              each context bitwise equal to LocalEnvironment's (see
              mesh_phase; its launches are the "mesh" and "meshenv" paths
              of the kernels line).
 14. surrogate_mo  the multi-objective qEHVI surrogate: calibrate_
              surrogate_mo at CONFIG (2 Sobol rounds and 1 qEHVI round of
              4, 3 replicates) through make_init_pool(0.35), the
              launcher's default 3 x 2 pool, resumed inline from its
              round-2 commit (bitwise equal); an ask at 64 told points
              of a synthetic 3-objective history on the card and on the
              CPU (equal archives, gains and picks within the
              stated tolerance); the ask at 8192 told points through the
              inducing fit (gp_sqdist and tri_solve) and the local-GP
              ensemble (16 experts of 512); dominance_pass at the box
              sweeps' shapes against its plain version (see
              surrogate_mo_phase; the calibrate run and its resume give
              the "surrogate_mo" path of the kernels line, the 8192-point
              asks the "surrogate_mo_big" path).
 15. service  calibrate_service at CONFIG: a 1024-individual GA init and a
              3-round surrogate as two tenants of one ExplorationService
              over make_init_pool(0.35, pool_devices=1) (some firing
              retried), the GA tenant's best 128 ranked;
              a second service on the same journal and cache (no
              diffuse_evaporate launch, every record "cache", the same
              results); the GA tenant bitwise equal to an inline streaming
              init, the surrogate tenant to phase surrogate's first 24
              evaluations (see service_phase; the "service" path).
 16. serve    LM serving through launch.serve.serve_once (engine.generate
              over Model.prefill / decode, _sdpa attention as the
              reference serves, so no kernel of the port runs: every launch
              count must stay 0): smollm-135m at CONFIG, batch 4, prompt
              16, 24 new tokens, greedy, in f32 and bf16 (cold / warm s,
              tok/s, peak memory, idle share over one warm generate), the
              f32 run's tokens teacher-forced through the card and the CPU
              (logits within SERVE_TOL, tokens equal where the CPU's top-2
              margin exceeds it); the ten archs at REDUCED, each held to
              the CPU the same way; SERVE_CONFIG_ARCHS at CONFIG (finite
              logits, tokens in range). See serve_phase; its (a) gives the
              "serve" path of the kernels line.
 17. train    LM training through launch.train.train_loop (make_train_step
              over Model.loss, _sdpa attention as the reference trains: no
              kernel of the port runs, every launch count must stay 0):
              smollm-135m at CONFIG in f32, 16 x 2048 tokens a step in 8
              microbatches, 6 steps (loss, grad norm, lr and seconds a step,
              tokens/s, model FLOP/s, peak memory, idle share over one more
              step), the same run killed after its step-3 checkpoint and
              resumed (bitwise equal, both under deterministic algorithms),
              one step on the card against the CPU at CONFIG and for every
              arch at REDUCED, two bf16 steps. See train_phase.
 18. bandit   bandit-routed serving through launch.bandit_serve.run_bandit
              at smollm-135m CONFIG (24 requests, three arms, UCB, the
              surrogate every 8): inline, its launches the "bandit" path
              (gp_sqdist once a GP fit, nothing else); at lat_weight 0
              inline and through 35 % injected failures (journals equal
              but for latency); gp_sqdist bitwise at the fits' shapes. See
              bandit_phase.
 19. the kernels line, the card's name and power limit, and the last line
     {"ok": true, "device": {...}}.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
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
BF16_TENSOR_OPS_PER_S = 989e12
DIFFUSION_OPS_PER_PATCH = 30     # 8 x (2 mul + add) + 2 mul + mul, sub, add, mul


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def call_ms(torch, fn, reps: int = 15, inner: int = 10,
            warmup: int = 3) -> float:
    """Per-call time seen by a caller: median over ``reps`` samples of
    ``inner`` back-to-back calls between two CUDA events, after a warm-up.
    For a small kernel this is the host's launch cost, not the card's."""
    for _ in range(warmup):
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


def turns_ms(torch, kernel, library, reps: int = 10, inner: int = 3,
             warmup: int = 2, hold_cycles: int = 0,
             library_inner: int = None) -> tuple:
    """``kernel`` and its ``library`` yardstick timed in turns (kernel,
    library, library, kernel) ``reps`` times, each sample ``inner``
    back-to-back calls between two CUDA events: -> ({"median", "min",
    "max", "n"} ms per call of the kernel, the same of the library, or
    None where ``library`` is None and the kernel is sampled alone).
    With ``hold_cycles``, the card spins that many cycles
    (torch.cuda._sleep) before each sample, while the host queues the
    sample's calls behind it: the events then read the card's time for
    the calls, not the host's time to launch them (small kernels launch
    slower than they run)."""
    def sample(fn, n):
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    lib_inner = inner if library_inner is None else library_inner
    for _ in range(warmup):
        kernel()
        if library is not None:
            library()
    ks, ls = [], []
    for _ in range(reps):
        ks.append(sample(kernel, inner))
        if library is not None:
            ls.extend((sample(library, lib_inner),
                       sample(library, lib_inner)))
        ks.append(sample(kernel, inner))
    return tuple({"median": statistics.median(x), "min": min(x),
                  "max": max(x), "n": len(x)} if x else None
                 for x in (ks, ls))


HOLD_CYCLES = 2_000_000     # ~1 ms of a spinning card: the host queues a
                            # sample's calls meanwhile


def flash_build_report(build) -> dict:
    """Every flash kernel of the built library: registers and spills
    (ptxas -v), the dynamic shared memory it is launched with, and the
    count of tensor-core instructions (HGMMA, HMMA) in its SASS. Fails
    unless every bf16 kernel has some, or if the f32 dQ kernel spills at
    any head dim."""
    import ctypes
    import re
    lib = build.load("flash")
    for entry in (lib.flash_bf16_smem_bytes, lib.flash_f32_smem_bytes):
        entry.argtypes = [ctypes.c_int, ctypes.c_int]
    # name -> (C entry of its shared memory, its index there)
    kernels = {"flash_fwd_wgmma_kernel": (lib.flash_bf16_smem_bytes, 0),
               "flash_dq_wgmma_kernel": (lib.flash_bf16_smem_bytes, 1),
               "flash_dkv_wgmma_kernel": (lib.flash_bf16_smem_bytes, 2),
               "flash_fwd_kernel": (lib.flash_f32_smem_bytes, 0),
               "flash_dq_kernel": (lib.flash_f32_smem_bytes, 1),
               "flash_dkv_kernel": (lib.flash_f32_smem_bytes, 2)}
    resources = build.kernel_resources(build.build_log("flash"))
    rows = {}
    for mangled, counts in build.sass_counts(build.sass("flash"),
                                             ("HGMMA", "HMMA")).items():
        # the name as mangled (its length, then it) and the head dim D
        names = [k for k in kernels if f"{len(k)}{k}ILi" in mangled]
        m = re.search(r"ILi(\d+)E", mangled)
        require(len(names) == 1 and m is not None,
                f"unknown kernel {mangled} in flash.cu")
        kernel, d = names[0], int(m.group(1))
        smem, which = kernels[kernel]
        rows[f"{kernel}<{d}>"] = {**resources.get(mangled, {}), **counts,
                                  "smem_bytes": smem(which, d)}
        if "wgmma" in kernel:
            require(counts["HGMMA"] + counts["HMMA"] > 0,
                    f"bf16 kernel {kernel}<{d}> runs no tensor-core "
                    f"instruction")
        if kernel == "flash_dq_kernel":
            spills = [rows[f"{kernel}<{d}>"].get(k, 0)
                      for k in ("spill_stores", "spill_loads")]
            require(spills == [0, 0], f"{kernel}<{d}> spills "
                    f"{spills[0]} / {spills[1]} bytes (stores / loads)")
    want = {f"{k}<{d}>" for k in kernels for d in (16, 32, 64, 128)}
    require(set(rows) == want, f"flash.cu kernels: expected {sorted(want)}, "
            f"got {sorted(rows)}")
    return rows


def kernel_name(raw: str) -> str:
    """A CUDA kernel's name as the profiler reports it, without namespace,
    template or argument list."""
    name = raw.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split("::")[-1]
    return name.split()[-1]


def kernel_intervals(torch, prof) -> list:
    """[(kernel name, start us, end us)] of every CUDA kernel record of a
    torch.profiler window, in the order the profiler lists them."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(kernel_name(e.name), e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def busy_union_ms(intervals) -> float:
    """Time the card ran at least one kernel: the length of the union of
    the kernel intervals, ms. Kernels on two streams overlap, so a sum of
    their times can exceed the wall time of the window."""
    total, end = 0.0, None
    for _, start, stop in sorted(intervals, key=lambda r: r[1]):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e3


def kernel_breakdown(intervals, reps: int = 1) -> dict:
    """{kernel name: {"ms": summed time per rep, "launches": launches per
    rep, "median_us", "min_us", "max_us": one launch's time}} of the
    kernel records of ``reps`` runs of the same work."""
    by = {}
    for name, start, stop in intervals:
        by.setdefault(name, []).append(stop - start)
    return {name: {"ms": sum(d) / 1e3 / reps, "launches": len(d) / reps,
                   "median_us": statistics.median(d), "min_us": min(d),
                   "max_us": max(d)} for name, d in sorted(by.items())}


CHOL_KERNELS = ("chol_step_kernel", "chol_trailing_kernel")


def chol_build_report(build) -> dict:
    """Every kernel of cholesky.cu, for the plain and the fused-assembly
    path: registers and spills (ptxas -v) and the dynamic shared memory of
    its launch. Fails unless the kernels are exactly the expected ones, so
    a renamed kernel cannot drop out of the breakdown unseen."""
    import ctypes
    import re
    lib = build.load("cholesky")
    lib.chol_smem_bytes.argtypes = [ctypes.c_int]
    rows = {}
    for mangled, res in build.kernel_resources(
            build.build_log("cholesky")).items():
        m = re.search(r"\d+([a-z_]+_kernel)ILb([01])E", mangled)
        if m is None:
            continue
        kernel = m.group(1)
        require(kernel in CHOL_KERNELS,
                f"unknown kernel {kernel} in cholesky.cu")
        rows[f"{kernel}<{'fused' if m.group(2) == '1' else 'plain'}>"] = {
            **res, "smem_bytes": lib.chol_smem_bytes(
                CHOL_KERNELS.index(kernel))}
    want = {f"{k}<{v}>" for k in CHOL_KERNELS for v in ("plain", "fused")}
    require(set(rows) == want, f"cholesky.cu kernels: expected "
            f"{sorted(want)}, got {sorted(rows)}")
    return rows


def stencil_solve_build_report(build) -> dict:
    """Every kernel of diffusion.cu (each route, with a ring of two
    worlds or one world) and trisolve.cu (the pack kernel, which also
    inverts the diagonal tiles, and the solve at each strip width):
    registers and spills (ptxas -v). Fails unless the kernels are exactly
    the expected ones."""
    import re
    want = {f"diffuse_evaporate_kernel<{route},{ring}>"
            for route in ("bulk", "cp_async") for ring in ("ring", "one")}
    want |= {"trisolve_pack_kernel"} | {f"trisolve_kernel<{w}>"
                                        for w in (16, 64)}
    rows = {}
    for source in ("diffusion", "trisolve"):
        for mangled, res in build.kernel_resources(
                build.build_log(source)).items():
            m = re.search(r"diffuse_evaporate_kernelILb([01])ELb([01])E",
                          mangled)
            if m:
                name = (f"diffuse_evaporate_kernel<"
                        f"{'bulk' if m.group(1) == '1' else 'cp_async'},"
                        f"{'ring' if m.group(2) == '1' else 'one'}>")
            elif "trisolve_pack_kernel" in mangled:
                name = "trisolve_pack_kernel"
            elif (m := re.search(r"trisolve_kernelILi(\d+)E", mangled)):
                name = f"trisolve_kernel<{m.group(1)}>"
            else:
                name = mangled
            require(name in want, f"unknown kernel {name} in {source}.cu")
            rows[name] = res
    require(set(rows) == want, f"diffusion.cu / trisolve.cu kernels: "
            f"expected {sorted(want)}, got {sorted(rows)}")
    return rows


DOMINANCE_OPCODES = ("FADD", "FSETP", "LOP3", "SHF", "IADD3", "IMAD", "LDS",
                     "POPC", "STG", "BRA")


def dominance_build_report(build) -> dict:
    """Every kernel of dominance.cu: dominance_kernel<M,groups,bitmap> for
    M = 1..8 and the generic M (0), grouped and ungrouped with the bitmap
    (B2) and ungrouped counts alone (B3), and the issue probe in both
    forms; with registers, spills and static shared memory (ptxas -v) and
    the count of each of DOMINANCE_OPCODES in its SASS. Fails unless the
    kernels are exactly the expected ones."""
    import re
    want = {f"dominance_kernel<{m},{g},{b}>" for m in range(9)
            for g, b in ((0, 1), (1, 1), (0, 0))}
    want |= {"dominance_probe_kernel<subtract>",
             "dominance_probe_kernel<compare>"}
    counts = build.sass_counts(build.sass("dominance"), DOMINANCE_OPCODES)
    rows = {}
    for mangled, res in build.kernel_resources(
            build.build_log("dominance")).items():
        if (m := re.search(r"dominance_kernelILi(\d+)ELb([01])ELb([01])E",
                           mangled)):
            name = f"dominance_kernel<{m.group(1)},{m.group(2)},{m.group(3)}>"
        elif (m := re.search(r"dominance_probe_kernelILb([01])E", mangled)):
            name = ("dominance_probe_kernel<"
                    f"{'subtract' if m.group(1) == '1' else 'compare'}>")
        else:
            name = mangled
        require(name in want, f"unknown kernel {name} in dominance.cu")
        rows[name] = {**res, **counts.get(mangled, {})}
    require(set(rows) == want, f"dominance.cu kernels: expected "
            f"{sorted(want)}, got {sorted(rows)}")
    return rows


def gp_build_report(build) -> dict:
    """Every kernel of gp.cu (``gp.KERNEL_NAMES``: D 2 and 8 with 16-byte
    and scalar stores, the generic D with scalar stores, each epilogue):
    registers, spills and static shared memory (ptxas -v), the MUFU
    instructions in its SASS, and the SASS instructions of its row loop
    (``gp.row_loop_instructions``; one trip writes 4 outputs a thread).
    Fails unless the kernels are exactly the expected ones and each has a
    row loop."""
    from repro_torch.kernels import gp
    text = build.sass("gp")
    loops = gp.row_loop_instructions(text)
    mufu = build.sass_counts(text, ("MUFU",))
    rows = {}
    for mangled, res in build.kernel_resources(build.build_log("gp")).items():
        name = gp.kernel_name(mangled)
        require(name in gp.KERNEL_NAMES, f"unknown kernel {mangled} in gp.cu")
        require(mangled in loops, f"{name}: no row loop in its SASS")
        rows[name] = {**res, **mufu.get(mangled, {}),
                      "row_loop_instructions": loops[mangled],
                      "per_output": loops[mangled] / gp.VEC}
    require(set(rows) == gp.KERNEL_NAMES, f"gp.cu kernels: expected "
            f"{sorted(gp.KERNEL_NAMES)}, got {sorted(rows)}")
    return rows


def profiled(torch, fn, reps: int = 1, tries: int = 3):
    """(wall ms, summed CUDA kernel time ms, {kernel name: summed ms},
    [(kernel name, start us, end us)]) of ``reps`` calls of ``fn`` under
    torch.profiler (CUPTI kernel records; names without namespace,
    template or argument list). A window that comes back with no kernel
    records at all (it happens now and then with short windows) is run
    again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = kernel_name(e.key)
                by_kernel[name] = by_kernel.get(name, 0.0) \
                    + e.self_device_time_total / 1e3
        busy_ms = sum(by_kernel.values())
        if busy_ms > 0:
            break
    intervals = kernel_intervals(torch, prof)
    require(busy_ms == 0 or intervals,
            "the profiler summed kernel time but listed no kernel records")
    return wall * 1e3, busy_ms, by_kernel, intervals


def factor_timing(torch, run, library, n_b: int, reps: int = 5) -> dict:
    """A blocked factor (B5 or B6, ``n_b`` 64-wide steps) beside cuSOLVER's
    ``library`` call: both timed in turns (``turns_ms``: median, min and
    max of 20 samples, each 3 back-to-back calls between CUDA events), then
    ``reps`` factors under torch.profiler: per factor the summed kernel time
    and the union of the kernel intervals (the step kernels and the
    trailing updates run on two streams and overlap), the breakdown by
    kernel (chol_step_kernel: the column update left from step k-1, the
    diagonal tile's factor and the panel; chol_trailing_kernel: the rest
    of the trailing update), and the median step kernel of the last 8
    steps, beside which only small trailing updates run."""
    kt, lt = turns_ms(torch, run, library)
    _, kernel_sum, _, intervals = profiled(torch, run, reps)
    steps = sorted((r for r in intervals if r[0] == "chol_step_kernel"),
                   key=lambda r: r[1])
    late = [stop - start for i, (_, start, stop) in enumerate(steps)
            if i % n_b >= n_b - 8]
    return {"timed_by": "cuda_events_in_turns", "ms": kt["median"],
            "ms_min_max": [kt["min"], kt["max"]], "samples": kt["n"],
            "library_ms": lt["median"],
            "library_min_max": [lt["min"], lt["max"]],
            "ratio_to_library": kt["median"] / lt["median"],
            "kernel_sum_ms": kernel_sum / reps,
            "device_busy_ms": busy_union_ms(intervals) / reps,
            "kernel_breakdown": kernel_breakdown(intervals, reps),
            "step_late_median_us": statistics.median(late) if late else None}


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Time on the card per call of ``fn``: the summed time of the CUDA
    kernels it launches, averaged over ``reps`` calls after a warm-up."""
    for _ in range(warmup):
        fn()
    busy = profiled(torch, fn, reps)[1]
    require(busy > 0, "the profiler recorded no device time")
    return busy / reps


def device_busy_share(torch, fn) -> dict:
    """Run ``fn`` once under torch.profiler: the time the card ran at least
    one kernel (the union of the kernel intervals) over the wall time of
    the window, beside the summed kernel time (larger where streams
    overlap)."""
    wall, kernel_sum, _, intervals = profiled(torch, fn)
    busy = busy_union_ms(intervals)
    return {"window_ms": wall, "device_busy_ms": busy,
            "kernel_sum_ms": kernel_sum,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def light_busy_share(torch, fn, tries: int = 3) -> dict:
    """``device_busy_share`` for a window of tens of thousands of kernels:
    CUDA activity alone, read from the profiler's raw records. Building its
    event list for one eager ``generate`` of smollm-135m (~48,600 kernels)
    took ~45 s on the H100's host; the raw records give the same busy time
    in under a second."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        intervals = [("", e.start_ns() / 1e3,
                      (e.start_ns() + e.duration_ns()) / 1e3)
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda]
        if intervals:
            break
    require(bool(intervals), "the profiler recorded no kernel")
    busy = busy_union_ms(intervals)
    return {"window_ms": wall, "device_busy_ms": busy,
            "kernel_sum_ms": sum(b - a for _, a, b in intervals) / 1e3,
            "kernels": len(intervals),
            "idle_share": max(0.0, 1.0 - busy / wall)}


def layer_split_ms(torch, cfg, params, x, positions, reps: int = 10,
                   warmup: int = 2) -> dict:
    """The flash branch of ``gqa_apply`` taken apart, its steps run in its
    order between CUDA events: the q/k/v projections and RoPE (``_qkv``),
    the copies of q, k, v to contiguous (B, H, S, D) that ``ops`` and the
    wrapper make, the kernel (B8) and the output projection (an einsum
    over the kernel's transposed output). Medians over ``reps`` passes
    after ``warmup``, ms: projections_rope (_qkv plus the output
    projection), copies, kernel, and their sum beside the whole pass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    steps = {"qkv_rope": [], "copies": [], "kernel": [], "out_proj": [],
             "whole": []}
    with torch.no_grad():
        for i in range(warmup + reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            q, k, v = attention._qkv(cfg, params, x, positions)
            ev[1].record()
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ev[2].record()
            out = fa.flash_attention(q, k, v, causal=True)
            ev[3].record()
            torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), params["wo"])
            ev[4].record()
            ev[4].synchronize()
            if i < warmup:
                continue
            for j, name in enumerate(("qkv_rope", "copies", "kernel",
                                      "out_proj")):
                steps[name].append(ev[j].elapsed_time(ev[j + 1]))
            steps["whole"].append(ev[0].elapsed_time(ev[4]))
    med = {name: statistics.median(t) for name, t in steps.items()}
    return {"projections_rope": med["qkv_rope"] + med["out_proj"],
            "qkv_rope": med["qkv_rope"], "out_proj": med["out_proj"],
            "copies": med["copies"], "kernel": med["kernel"],
            "sum_of_parts": med["qkv_rope"] + med["copies"] + med["kernel"]
            + med["out_proj"], "whole_pass": med["whole"], "reps": reps}


def flash_phase(torch, dev, gen) -> tuple:
    """Phase ``flash``: the four flash kernels (B8, B9's forward, dQ and
    dK/dV) through the reference's own entry points at smollm-135m's
    attention (H 9, KH 3, D 64), in bfloat16 (the config's dtype) and f32.

    The path, with the launch counts set to 0 just before it and read just
    after (the f32 calls' launches also counted apart, as
    ``<wrapper>_f32``): ``ops.flash_attention_gqa`` at train_4k's sequence
    (B 4, S 4096, causal) in both types and at prefill_32k's (B 1, S 32768,
    bf16);
    ``ops.flash_attention_or_ref`` once; a smollm-135m CONFIG GQA layer
    (``gqa_apply(allow_flash=True)`` through ``GQAttention``, weights from
    ``gqa_init``) on x (4, 4096, 576) bf16, one ``flash_attention`` launch;
    and ``ops.flash_attention_gqa_diff`` forward and backward of
    ``(out * w).sum()`` with a fixed random w in both types. Then each
    result is held against its plain version on the card (TF32 off): B8
    and B9's out against ``flash_attention_ref`` / ``flash_attention_fwd_ref``
    (f32 within 2e-5, bf16 within 2e-2, the reference's own sweep
    tolerances), lse within 1e-5, the dQ and dK/dV kernels against
    ``flash_attention_bwd_ref`` on the same out and lse (f32 2e-4, bf16
    2e-2), the gradients against autograd through ``flash_attention_ref``
    (f32 2e-4, the reference's; bf16 2e-2 of the largest gradient: the
    plain side differentiates the uncast output, the kernels take dsum
    from the bf16 one), the layer against ``allow_flash=False`` (``_sdpa``,
    bf16 2e-2), and the 32k forward against SDPA (bf16 2e-2; its plain
    version's f32 scores alone would take 38.7 GB). Times: CUDA events
    around back-to-back calls, for the kernels, the plain versions, SDPA
    and the layer alike; each kernel and the 32k forward in turns with
    SDPA (``turns_ms``), and the layer's flash branch step by step
    (``layer_split_ms``).
    Returns ({(kernel name, dtype): row}, launch counts of the path)."""
    import torch.nn.functional as F

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.smollm_135m import CONFIG as LM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 off for the plain versions")
    t_phase = time.monotonic()
    seq = {shape.name: shape.seq_len for shape in SHAPES}
    b, s, s_long = 4, seq["train_4k"], seq["prefill_32k"]
    h, kh, d = LM.n_heads, LM.n_kv_heads, LM.resolved_head_dim
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def heads(x):               # (B, S, H, D) -> contiguous (B, H, S, D)
        return x.transpose(1, 2).contiguous()

    def sdpa(q_, k_, v_):       # the library yardstick, never on the path
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True,
                                              enable_gqa=True)

    inputs = {dt: (randn((b, s, h, d), dt), randn((b, s, kh, d), dt),
                   randn((b, s, kh, d), dt), randn((b, s, h, d)))
              for dt in (f32, bf16)}
    long_in = tuple(randn((1, s_long, n, d), bf16) for n in (h, kh, kh))
    layer = attention.GQAttention(LM, attention.gqa_init(LM, gen,
                                                         device=dev))
    x = randn((b, s, LM.d_model), bf16)
    positions = torch.arange(s, device=dev).expand(b, s)
    mask = torch.ones((s, s), dtype=torch.bool, device=dev).tril()

    # -- the path -----------------------------------------------------------
    f32_launches = {}

    def run(dt, fn):
        """fn(), its f32 launches counted apart as "<wrapper>_f32"."""
        before = ops.kernel_launch_counts()
        result = fn()
        for name, n in ops.kernel_launch_counts().items():
            if dt == f32 and n > before[name]:
                key = f"{name}_f32"
                f32_launches[key] = f32_launches.get(key, 0) + n - before[name]
        return result

    def diff(q, k, v, w):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention_gqa_diff(*leaves, causal=True)
        (o.float() * w).sum().backward()
        return (o.detach(), *(t.grad for t in leaves))

    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {}
    with torch.no_grad():
        for dt, (q, k, v, _) in inputs.items():
            out["b8", dt] = run(dt, lambda: ops.flash_attention_gqa(
                q, k, v, causal=True))
        out["long"] = ops.flash_attention_gqa(*long_in, causal=True)
        q, k, v, _ = inputs[bf16]
        out["or_ref"] = ops.flash_attention_or_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        before = ops.kernel_launch_counts()["flash_attention"]
        out["layer"] = layer(x, positions, mask, allow_flash=True)
        layer_launches = ops.kernel_launch_counts()["flash_attention"] - before
    for dt, (q, k, v, w) in inputs.items():
        out["diff", dt] = run(dt, lambda: diff(q, k, v, w))
    torch.cuda.synchronize()
    path_wall = time.perf_counter() - t0
    launches = ops.kernel_launch_counts()
    require(layer_launches == 1, f"gqa_apply(allow_flash=True) launched "
            f"flash_attention {layer_launches} times (want 1)")
    require(launches["flash_attention"] == 5
            and launches["flash_attention_fwd"] == 2
            and launches["flash_attention_dq"] == 2
            and launches["flash_attention_dkv"] == 2,
            f"flash path launches {launches}")
    require(f32_launches == {f"{name}_f32": 1 for name in (
        "flash_attention", "flash_attention_fwd", "flash_attention_dq",
        "flash_attention_dkv")}, f"flash path f32 launches {f32_launches}")

    # -- each result against its plain version on the card -----------------
    tol = {f32: 2e-5, bf16: 2e-2}
    grad_tol = {f32: 2e-4, bf16: 2e-2}
    errs, scales = {}, {}

    def hold(name, got, want, rtol, atol=None):
        errs[name] = err = (got.float() - want.float()).abs().max().item()
        scales[name] = want.float().abs().max().item()
        atol = rtol if atol is None else atol
        require(torch.allclose(got.float(), want.float(), rtol=rtol,
                               atol=atol),
                f"{name}: max abs err {err} (rtol {rtol}, atol {atol}), "
                f"max |want| {scales[name]}")

    rows = {}
    for dt, (q, k, v, w) in inputs.items():
        tag = "bf16" if dt == bf16 else "f32"
        qh, kh_, vh = heads(q), heads(k), heads(v)
        with torch.no_grad():
            plain = ref.flash_attention_ref(qh, kh_, vh)
            hold(f"b8_{tag}", heads(out["b8", dt]), plain, tol[dt])
            o_fwd, lse = fab.flash_attention_fwd(qh, kh_, vh)
            out_plain, lse_plain = ref.flash_attention_fwd_ref(qh, kh_, vh)
            hold(f"fwd_out_{tag}", o_fwd, out_plain, tol[dt])
            hold(f"fwd_lse_{tag}", lse, lse_plain, 1e-5)
            require(torch.equal(o_fwd, heads(out["b8", dt])),
                    f"B9's forward and B8 differ ({tag})")
            do = heads(w).to(dt)
            dsum = (do.float() * o_fwd.float()).sum(-1)
            got_bwd = fab.flash_attention_bwd(qh, kh_, vh, o_fwd, lse, do)
            want_bwd = ref.flash_attention_bwd_ref(qh, kh_, vh, o_fwd, lse,
                                                   do)
            for name, g_, w_ in zip(("dq", "dk_h", "dv_h"), got_bwd,
                                    want_bwd):
                hold(f"bwd_{name}_{tag}", g_, w_, grad_tol[dt])
            del got_bwd, want_bwd
        leaves = [t.detach().requires_grad_() for t in (qh, kh_, vh)]
        (ref.flash_attention_ref(*leaves).float() * heads(w)).sum().backward()
        got = out["diff", dt]
        hold(f"diff_out_{tag}", heads(got[0]), plain, tol[dt])
        for name, g_, leaf in zip(("dq", "dk", "dv"), got[1:], leaves):
            want = leaf.grad
            scale = want.float().abs().max().item()
            atol = grad_tol[dt] * (scale if dt == bf16 else 1.0)
            hold(f"grad_{name}_{tag}", heads(g_), want, grad_tol[dt], atol)
        del leaves, plain, out_plain, lse_plain

        # times at the path's shapes, on contiguous (B, H, S, D) inputs,
        # every column between CUDA events around back-to-back calls (each
        # call keeps the card busy for 0.2-25 ms, far above its launch
        # cost), each kernel in turns with its SDPA yardstick (kernel,
        # SDPA, SDPA, kernel; 10 rounds). Not torch.profiler: at these
        # sizes it has dropped kernel records of a call and has returned
        # windows with no records at all (PERF.md §6)
        ops_per_s = BF16_TENSOR_OPS_PER_S if dt == bf16 else F32_OPS_PER_S
        flops = 2 * b * h * s * s * d           # causal forward
        item = torch.finfo(dt).bits // 8
        qo_bytes = b * h * s * d * item          # q, out, dO, dq, dk_h, dv_h
        kv_bytes = b * kh * s * d * item         # k, v
        row_bytes = b * h * s * 4                # lse, dsum
        ql, kl, vl = (t.detach().requires_grad_() for t in (qh, kh_, vh))
        o_lib = sdpa(ql, kl, vl)

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(qh, kh_, vh)

        def sdpa_bwd():
            torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True)

        plain_bwd_ms = call_ms(torch, lambda: ref.flash_attention_bwd_ref(
            qh, kh_, vh, o_fwd, lse, do), reps=3, inner=1, warmup=1)
        for name, run, plain_run, work, n_bytes, lib_run, checks in (
                ("flash_attention", lambda: fa.flash_attention(qh, kh_, vh),
                 lambda: ref.flash_attention_ref(qh, kh_, vh), 1.0,
                 2 * qo_bytes + 2 * kv_bytes, sdpa_fwd, ("b8",)),
                ("flash_attention_fwd",
                 lambda: fab.flash_attention_fwd(qh, kh_, vh),
                 lambda: ref.flash_attention_fwd_ref(qh, kh_, vh), 1.0,
                 2 * qo_bytes + 2 * kv_bytes + row_bytes, sdpa_fwd,
                 ("fwd_out", "fwd_lse")),
                # Q K^T, dO V^T, dS K: three of the backward's five products
                ("flash_attention_dq", lambda: fab.flash_attention_dq(
                    qh, kh_, vh, do, lse, dsum), None, 1.5,
                 3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes, sdpa_bwd,
                 ("bwd_dq",)),
                # Q K^T, dO V^T, P^T dO, dS^T Q
                ("flash_attention_dkv", lambda: fab.flash_attention_dkv(
                    qh, kh_, vh, do, lse, dsum), None, 2.0,
                 4 * qo_bytes + 2 * kv_bytes + 2 * row_bytes, sdpa_bwd,
                 ("bwd_dk_h", "bwd_dv_h"))):
            b_ms, b_by = bound_ms(n_bytes, work * flops, ops_per_s)
            k_t, lib_t = turns_ms(torch, run, lib_run)
            r = {"kernel": name, "dtype": tag, "shape": [b, s, h, kh, d],
                 "causal": True, "timed_by": "cuda_events, in turns",
                 "ms": k_t["median"], "ms_min_max": [k_t["min"], k_t["max"]],
                 "plain_ms": (plain_bwd_ms if plain_run is None else
                              call_ms(torch, plain_run, reps=3, inner=1,
                                      warmup=1)),
                 "plain_computes": ("dq, dk_h and dv_h together"
                                    if plain_run is None else name),
                 "library_ms": lib_t["median"],
                 "library_ms_min_max": [lib_t["min"], lib_t["max"]],
                 "samples": k_t["n"],
                 "library": ("SDPA backward, enable_gqa (dq, dk, dv)"
                             if plain_run is None else
                             "SDPA forward, enable_gqa"),
                 "bound_ms": b_ms, "bound_by": b_by, "flops": work * flops,
                 "tflops": work * flops / k_t["median"] / 1e9,
                 "bound_share": b_ms / k_t["median"],
                 "max_abs_err": max(errs[f"{c}_{tag}"] for c in checks)}
            rows[name, tag] = r
            emit({"phase": "flash", **r})
        del o_lib, ql, kl, vl
        del o_fwd, lse, do, dsum

    # the 32k forward against SDPA, and the layer against its _sdpa branch
    ql, kl, vl = (heads(t) for t in long_in)
    with torch.no_grad():
        hold("b8_32k_vs_sdpa_bf16", heads(out["long"]), sdpa(ql, kl, vl),
             tol[bf16])
        require(torch.equal(out["or_ref"], heads(out["b8", bf16])),
                "flash_attention_or_ref differs from flash_attention_gqa")
        layer_plain = layer(x, positions, mask, allow_flash=False)
        hold("gqa_apply_flash_vs_sdpa_bf16", out["layer"], layer_plain,
             tol[bf16])
        long_t, long_sdpa_t = turns_ms(
            torch, lambda: fa.flash_attention(ql, kl, vl),
            lambda: sdpa(ql, kl, vl), reps=5, inner=2, warmup=1)
        layer_ms = {flag: call_ms(torch, lambda: layer(
            x, positions, mask, allow_flash=flag), reps=5, inner=2)
            for flag in (True, False)}
        layer_parts = layer_split_ms(torch, LM, layer.params(), x,
                                     positions)
    for t_ in out["layer"], layer_plain, out["long"]:
        require(bool(torch.isfinite(t_).all()), "flash outputs finite")
    long_bound = bound_ms((2 * h + 2 * kh) * s_long * d * 2,
                          2 * h * s_long * s_long * d,
                          BF16_TENSOR_OPS_PER_S)
    emit({"phase": "flash", "config": LM.name, "heads": h, "kv_heads": kh,
          "head_dim": d, "path_wall_s": path_wall, "launches": launches,
          "launches_f32": f32_launches,
          "layer_flash_launches": layer_launches, "max_abs_err": errs,
          "max_abs_want": scales,
          "tolerance": {"out_f32": tol[f32], "out_bf16": tol[bf16],
                        "lse": 1e-5, "grad_f32": grad_tol[f32],
                        "grad_bf16": f"{grad_tol[bf16]} x max |grad|"},
          "prefill_32k": {"shape": [1, s_long, h, kh, d], "dtype": "bf16",
                          "ms": long_t["median"],
                          "ms_min_max": [long_t["min"], long_t["max"]],
                          "sdpa_ms": long_sdpa_t["median"],
                          "sdpa_ms_min_max": [long_sdpa_t["min"],
                                              long_sdpa_t["max"]],
                          "bound_ms": long_bound[0],
                          "bound_by": long_bound[1]},
          "gqa_layer_ms": {"allow_flash": layer_ms[True],
                           "sdpa_branch": layer_ms[False],
                           "allow_flash_split": layer_parts},
          "backward_bound_ms_bf16": bound_ms(
              0, 2.5 * 2 * b * h * s * s * d, BF16_TENSOR_OPS_PER_S)[0],
          "seconds": time.monotonic() - t_phase})
    return rows, {**launches, **f32_launches}


def max_in_flight(tasks) -> int:
    """Most jobs running at once, from TaskRecords' start offsets and wall
    times (a job's span covers its retries)."""
    edges = sorted([(t.started_s, 1) for t in tasks]
                   + [(t.started_s + t.wall_s, -1) for t in tasks],
                   key=lambda e: (e[0], e[1]))
    most = now = 0
    for _, step in edges:
        now += step
        most = max(most, now)
    return most


def init_phase(torch, dev, gen) -> tuple:
    """Phase ``init``: the paper's streaming init (section 4.6) at the
    model's full size (CONFIG: 72 x 72 world, 125 ants, 1000 ticks) with 5
    replicates, chunks of 4096 genomes (20480 lanes), depth cut to 14336
    individuals (3 full chunks and a 2048 remainder). Three legs through
    ``ga.evaluate_population_streaming``, which must agree bit for bit:
    (a) inline; (b) through ``make_init_pool(0.35)``, the 3 x 2 pool at
    35 % injected failures (more attempts than chunks required; every
    chunk on the card at once); (c) the same pool stopped after 2 chunks
    into a checkpoint directory, then resumed (2 chunks resumed required).
    Each leg's wall, evaluations/hour and process CPU time; (b)'s peak
    memory and the most chunks in flight; the device idle share over one
    chunk job under torch.profiler; the 200,000-individual wall projected
    from the measured legs. The kernels at the init's call sites against
    their plain versions: ``diffuse_evaporate`` on the remainder chunk's
    10240 lanes (bitwise), ``dominance_pass`` on a 2048-row block of leg
    (a)'s objectives (integer ticks, many ties: equal), and the top-k's
    launches. Then ``explore.calibrate(reduced=False, init_population=14336,
    init_chunk=4096, fault_rate=0.35, pipeline=True, epochs=2)`` with the
    calibrate phase's other flags, launch counts set to 0 just before it
    and read just after: evaluations 14336 + 8 * 2 * 4 * 16, a finite,
    in-bounds, mutually non-dominated front with ``front["init"]``, one
    ``diffuse_evaporate`` launch a tick of every chunk and every step.
    Returns the launch counts of that run and leg (a)'s result."""
    import numpy as np

    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.core import Context
    from repro_torch.core.scheduler import RunRecord, _utcnow
    from repro_torch.evolution import ga
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import explore

    n_total, chunk, reps = 14336, 4096, 5
    sizes = ga.chunk_sizes(n_total, chunk)
    n_chunks = len(sizes)
    cfg = explore.NSGA2Config(mu=16, genome_dim=2, bounds=explore.BOUNDS)
    eval_fn = explore.ants_eval_fn(CONFIG, reps)

    def leg(**kw):
        torch.cuda.synchronize()
        c0, t0 = time.process_time(), time.perf_counter()
        res = ga.evaluate_population_streaming(
            cfg, eval_fn, 0, n_total=n_total, chunk=chunk, device=dev, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, time.process_time() - c0

    def row(name, res, wall, cpu, **extra):
        emit({"phase": "init", "leg": name, "config": "CONFIG",
              "n_total": n_total, "chunk": chunk, "replicates": reps,
              "chunks": res.chunks_total, "attempts": res.attempts,
              "resumed_chunks": res.resumed_chunks, "wall_s": wall,
              "evaluations_per_hour": n_total / wall * 3600,
              "process_cpu_s": cpu, **extra})

    ops.reset_kernel_launch_counts()
    a, wall_a, cpu_a = leg()
    launches_a = ops.kernel_launch_counts()
    obj = a.objectives
    require(obj.shape == (n_total, 3) and a.genomes.shape == (n_total, 2)
            and bool(np.isfinite(obj).all()) and obj.min() >= 0
            and obj.max() <= CONFIG.max_ticks
            and bool(((a.genomes >= 0) & (a.genomes < 99)).all()),
            "init leg (a): objectives and genomes")
    require(launches_a["diffuse_evaporate"] == n_chunks * CONFIG.max_ticks,
            f"init leg (a): diffuse_evaporate launches "
            f"{launches_a['diffuse_evaporate']}")
    row("a_inline", a, wall_a, cpu_a, launches=launches_a)

    pool = explore.make_init_pool(0.35)
    rec = RunRecord(workflow="init", scheduler="stream", environment="pool",
                    started_at=_utcnow())
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        b, wall_b, cpu_b = leg(environment=pool, record=rec)
        peak_b = torch.cuda.max_memory_allocated()
        with tempfile.TemporaryDirectory() as ck:
            c1, wall_c1, cpu_c1 = leg(environment=pool, checkpoint_dir=ck,
                                      stop_after_chunks=2)
            c, wall_c2, cpu_c2 = leg(environment=pool, checkpoint_dir=ck)
        stats = pool.stats.snapshot()
    finally:
        pool.shutdown()
    for name, res in (("b", b), ("c", c)):
        require(np.array_equal(res.objectives, a.objectives)
                and np.array_equal(res.genomes, a.genomes),
                f"init leg ({name}) differs from leg (a)")
    require(b.attempts > b.chunks_total == n_chunks,
            f"init leg (b): {b.attempts} attempts for {b.chunks_total} "
            f"chunks at 35 % failures")
    require(c1.interrupted and c1.chunks_done == 2
            and c.resumed_chunks == 2 and not c.interrupted,
            f"init leg (c): {c1.chunks_done} chunks before the stop, "
            f"{c.resumed_chunks} resumed")
    row("b_pool_3x2_fail_0.35", b, wall_b, cpu_b,
        peak_memory_gb=peak_b / 1e9, memory_before_gb=base / 1e9,
        max_chunks_in_flight=max_in_flight(rec.tasks),
        pool_capacity=pool.total_capacity,
        pool_stats_after_legs_b_c=stats)
    row("c_stop_after_2_then_resume", c, wall_c1 + wall_c2, cpu_c1 + cpu_c2,
        first_wall_s=wall_c1, first_attempts=c1.attempts,
        resume_wall_s=wall_c2,
        resume_cost_s=wall_c1 + wall_c2 - wall_b)

    # the device's idle share over one chunk job, as a pool worker runs it
    task = ga.make_chunk_task(cfg, eval_fn, 0, dev)
    busy = device_busy_share(torch, lambda: task.run(
        Context(chunk=0, size=chunk)))
    emit({"phase": "init", "what": "profile_one_chunk", "lanes": chunk * reps,
          "ticks": CONFIG.max_ticks, **busy})

    # the kernels at the init's call sites against their plain versions
    chem = torch.rand((sizes[-1] * reps, 72, 72), generator=gen,
                      device=dev) * 100.0
    rate = torch.rand((len(chem),), generator=gen, device=dev)
    evap = torch.rand((len(chem),), generator=gen, device=dev) * 0.5
    require(torch.equal(ops.diffuse_evaporate(chem, rate, evap),
                        ref.diffuse_evaporate_ref(chem, rate, evap)),
            "diffuse_evaporate at the remainder chunk's lanes")
    block = torch.from_numpy(obj[:2048]).to(dev)
    got, want = ops.dominance_pass(block), ref.dominance_pass_ref(block)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "dominance_pass on a block of the init's objectives")
    ops.reset_kernel_launch_counts()
    top_g, top_o = ga.select_top_streaming(cfg, a.genomes, a.objectives,
                                           8 * 16, device=dev)
    topk_launches = ops.kernel_launch_counts()["dominance_pass"]
    blocks = -(-n_total // 2048)
    require(topk_launches == blocks + 1 and top_g.shape == (128, 2),
            f"select_top_streaming: {topk_launches} dominance_pass launches "
            f"for {blocks} blocks and the final round")
    emit({"phase": "init", "what": "kernels_at_init_shapes",
          "diffuse_evaporate_lanes": len(chem), "diffuse_bitwise": True,
          "dominance_pass_rows": 2048, "dominance_equal": True,
          "top_k": 128, "top_k_dominance_launches": topk_launches})

    # the 200k wall, projected from the measured legs (not measured)
    per_ind = {"a_inline": wall_a / n_total, "b_pool": wall_b / n_total}
    emit({"phase": "init", "what": "projection_200k", "projection": True,
          "basis": "measured legs (a) and (b) at 14336 individuals",
          **{f"projected_200k_wall_s_{k}": v * 200000
             for k, v in per_ind.items()}})

    # the main path: calibrate seeded by the streaming init, pipelined
    flags = dict(n_islands=8, mu=16, lam=16, steps_per_epoch=4, epochs=2,
                 replicates=reps, archive_size=256, merge_top_k=8)
    with tempfile.TemporaryDirectory() as out:
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, front = explore.calibrate(
            reduced=False, out_dir=out, device="cuda",
            init_population=n_total, init_chunk=chunk, fault_rate=0.35,
            pipeline=True,
            printer=lambda s: emit({"phase": "init", "log": s}), **flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(out).iterdir())
    evals = n_total + flags["n_islands"] * flags["epochs"] \
        * flags["steps_per_epoch"] * flags["lam"]
    require(front["evaluations"] == evals == state.total_evaluations,
            f"init calibrate evaluations {front['evaluations']} != {evals}")
    fobj = torch.tensor(front["objectives"])
    fgen = torch.tensor(front["genomes"])
    require(len(fobj) > 0 and bool(torch.isfinite(fobj).all())
            and fobj.min() >= 0 and fobj.max() <= CONFIG.max_ticks,
            "init calibrate front objectives in range")
    require(bool(((fgen >= 0) & (fgen <= 99)).all()),
            "init calibrate front genomes in bounds")
    require(not ref.dominance_pass_ref(fobj)[0].any(),
            "init calibrate front mutually non-dominated")
    require(front.get("init", {}).get("n_individuals") == n_total,
            f"front['init'] {front.get('init')}")
    n_sims = n_chunks + flags["epochs"] * flags["steps_per_epoch"]
    require(launches["diffuse_evaporate"] == n_sims * CONFIG.max_ticks,
            f"init calibrate diffuse_evaporate launches "
            f"{launches['diffuse_evaporate']}")
    require(launches["dominance_pass"] > topk_launches,
            f"init calibrate dominance_pass launches "
            f"{launches['dominance_pass']}")
    require({"pareto_front.json", "provenance.json", "populations",
             "init_checkpoints"} <= set(files), f"outputs {files}")
    emit({"phase": "init", "what": "calibrate", "config": "CONFIG",
          **flags, "init_population": n_total, "init_chunk": chunk,
          "fault_rate": 0.35, "pipeline": True, "wall_s": wall,
          "evaluations": evals, "evaluations_per_hour": evals / wall * 3600,
          "init": front["init"], "front_size": len(fobj),
          "launches": launches})
    return launches, a


def dsl_phase(torch, dev) -> dict:
    """Phase ``dsl``: the paper's Listings 2-5 written against the port's
    workflow DSL, at CONFIG (the paper's 72 x 72 world, 125 ants, 1000
    ticks) on the card. Each Listing's launch counts are set to 0 just
    before it and read just after; the comparisons run outside those
    windows.

    Listing 2: one ``TorchTask`` run of ``simulate`` (seed 42, diffusion 50,
    evaporation 10) in a capsule hooked with ``ToStringHook``: objectives
    bitwise equal to a direct ``simulate`` with the same seed, exactly
    ``max_ticks`` ``diffuse_evaporate`` launches. Listing 3: ``head >>
    explore(SeedSampling(seed, 5, seed=7)) >> model >> aggregate() >>
    StatisticTask(median)``, serial, async with ``cache=True`` (bitwise
    equal; it fills the cache) and async with ``cache=True`` again (every
    model firing a hit, no launch, bitwise equal). At CONFIG every run
    gives the 1000-tick cap, so both Listings run again on REDUCED's world
    cut to 60 ticks with sources of radius 1 and 256 ants, where the first
    source empties within the horizon and the five seeds must give
    different runs; there Listing 3 runs a fourth time with its model on an
    ``EnvironmentPool`` of 3 x 2 slots whose members fail every lane's
    first attempt (each of the 5 lanes requeued once, bitwise equal).
    Listing 4: ``run_generational`` at the paper's settings (mu 10, lam 10,
    5 replicates through ``replicated_batch``, 10 generations, reevaluate
    0.01), evaluations 10 + 10 * 10. Listing 5: a capsule running
    ``run_islands`` (4 islands, mu 10, lam 10, 1 step an epoch, 2 epochs,
    5 replicates) placed ``.on(LocalEnvironment())`` and hooked with
    ``SavePopulationHook``: the saved rows equal the archive's. Then the two
    kernels at the Listings' shapes against their plain versions:
    ``diffuse_evaporate`` at 1, 50 and 200 lanes (bitwise),
    ``dominance_pass`` on Listing 4's populations and Listing 5's islands
    and archive, and at the same shapes and groupings (20 rows in one
    group, 40 rows in 4 groups, 128 rows ungrouped) on seeded objectives
    with ties and +BIG rows (equal). Returns the launch counts summed over
    the Listings' windows."""
    import csv
    import dataclasses as dc

    import numpy as np

    from repro_torch.ants import simulate
    from repro_torch.configs.ants_netlogo import BOUNDS, CONFIG, REDUCED
    from repro_torch.core import (Capsule, EnvironmentPool, FaultSpec,
                                  LocalEnvironment, PyTask,
                                  SavePopulationHook, ToStringHook,
                                  TorchTask, Val, aggregate, explore, puzzle)
    from repro_torch.evolution import (NSGA2Config, nsga2, run_islands,
                                       run_generational)
    from repro_torch.explore import SeedSampling, StatisticTask, median
    from repro_torch.kernels import diffusion, dominance, ops, ref
    from repro_torch.launch.explore import ants_eval_fn
    from repro_torch.runtime.device import make_generator

    t_phase = time.monotonic()
    total = {}
    by_listing = {}

    def window(name, fn):
        """fn() with the launch counts set to 0 just before and read just
        after; (result, wall s, launches)."""
        torch.cuda.synchronize()
        ops.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.kernel_launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        by_listing[name] = {k: v for k, v in launches.items() if v}
        return out, wall, launches

    seed = Val("seed", int)
    foods = [Val(f"food{i}", float) for i in (1, 2, 3)]
    meds = [Val(f"medNumberFood{i}", float) for i in (1, 2, 3)]

    def ants_task(cfg):
        def ants_fn(gDiffusionRate, gEvaporationRate, seed):
            # a generator of its own, from the seed, on every call
            obj = simulate(cfg, gDiffusionRate, gEvaporationRate,
                           generator=make_generator(int(seed), dev),
                           device=dev)
            return {"food1": obj[0], "food2": obj[1], "food3": obj[2]}

        return TorchTask(
            "ants", ants_fn,
            inputs=(Val("gDiffusionRate", float),
                    Val("gEvaporationRate", float), seed),
            outputs=tuple(foods),
            defaults={"seed": 42, "gDiffusionRate": 50.0,
                      "gEvaporationRate": 10.0}, device=dev)

    # no source empties within the horizon at CONFIG or REDUCED with these
    # rates, so every run gives the cap; on REDUCED's world cut to 60 ticks
    # with sources of radius 1 and 256 ants the first source empties, and
    # the seeds give different ticks
    small = dc.replace(REDUCED, max_ticks=60, food_radius=1.0,
                       population=256)

    # -- Listing 2 ---------------------------------------------------------
    def listing2(cfg, name):
        shown = []
        res, wall, launches = window(f"listing2_{name}", lambda: puzzle(
            Capsule(ants_task(cfg)).hook(ToStringHook(
                *foods, printer=shown.append))).run())
        (ctx,) = list(res.values())[0]
        got = torch.stack([ctx[f.name] for f in foods])
        want = simulate(cfg, 50.0, 10.0, generator=make_generator(42, dev),
                        device=dev)
        require(got.device.type == dev.type and torch.equal(got, want),
                f"Listing 2 {name}: {got.tolist()} against a direct "
                f"simulate {want.tolist()}")
        require(launches["diffuse_evaporate"] == cfg.max_ticks,
                f"Listing 2 {name}: {launches['diffuse_evaporate']} "
                f"diffuse_evaporate launches, not {cfg.max_ticks}")
        require(len(shown) == 1,
                f"Listing 2 {name}: ToStringHook showed {shown}")
        emit({"phase": "dsl", "listing": 2, "config": name, "wall_s": wall,
              "objectives": got.tolist(), "shown": shown[0],
              "at_cap": bool((got == cfg.max_ticks).all()),
              "equals_direct_simulate": True,
              "launches": by_listing[f"listing2_{name}"]})

    listing2(CONFIG, "CONFIG")
    listing2(small, "REDUCED_small_sources")

    # -- Listing 3 ---------------------------------------------------------
    def listing3(cfg, name, pool=None):
        # the async run fills the process-global cache (cache=True), and
        # the run after it finds every firing there; with a pool, a fourth
        # run places the model on it, without the cache
        kinds = [("serial", dict(scheduler="serial")),
                 ("async", dict(scheduler="async", cache=True)),
                 ("cached", dict(scheduler="async", cache=True))]
        if pool is not None:
            kinds.append(("pool", dict(scheduler="async")))
        runs = []
        for kind, kw in kinds:
            p, model, stat = puzzle_and_roles(
                cfg, pool if kind == "pool" else None)
            res, wall, launches = window(f"{name}_{kind}",
                                         lambda: p.run(**kw))
            modes = sorted({r.mode for r in p.workflow.last_record.tasks
                            if r.task == "ants"})
            runs.append((kind, res[model], res[stat][0], wall, launches,
                         modes))
        first = runs[0]
        objs = torch.stack([torch.stack([c[f.name] for f in foods])
                            for c in first[1]])
        for kind, model_out, stat_out, wall, launches, modes in runs:
            o = torch.stack([torch.stack([c[f.name] for f in foods])
                             for c in model_out])
            m = torch.stack([stat_out[v.name] for v in meds])
            require(torch.equal(o, objs) and torch.equal(
                m, torch.stack([first[2][v.name] for v in meds])),
                f"{name} {kind}: differs from the serial run")
            n_b1 = 0 if kind == "cached" else 5 * cfg.max_ticks
            require(launches["diffuse_evaporate"] == n_b1,
                    f"{name} {kind}: {launches['diffuse_evaporate']} "
                    f"diffuse_evaporate launches, not {n_b1}")
            require(modes == (["cache"] if kind == "cached" else ["lanes"]),
                    f"{name} {kind}: model firings {modes}")
            require(m.device.type == dev.type,
                    f"{name}: medians off the card")
        require(torch.equal(torch.stack([first[2][v.name] for v in meds]),
                            median(objs, axis=0)),
                f"{name}: medians of the five runs")
        distinct = len({tuple(r) for r in objs.tolist()})
        require(cfg is not small or distinct > 1,
                f"{name}: the five seeds gave one run {objs.tolist()}")
        extra = {}
        if pool is not None:
            st = pool.stats
            require(st.resubmissions == st.failed_attempts == 5
                    and st.completed == 5 and st.in_flight == 0,
                    f"{name} pool: {dc.asdict(st)}")
            extra = {"pool_stats": dc.asdict(st)}
        emit({"phase": "dsl", "listing": 3, "config": name, **extra,
              "seeds": [int(c["seed"]) for c in first[1]],
              "objectives": objs.tolist(),
              "medians": [first[2][v.name].item() for v in meds],
              "serial_equals_async_equals_cached": True,
              "at_cap": bool((objs == cfg.max_ticks).all()),
              "distinct_runs": distinct,
              **{f"{r[0]}_wall_s": r[3] for r in runs},
              "launches": {r[0]: by_listing[f"{name}_{r[0]}"] for r in runs}})

    def puzzle_and_roles(cfg, environment=None):
        model = Capsule(ants_task(cfg))
        if environment is not None:
            model.on(environment)
        stat = Capsule(StatisticTask("statistic",
                                     list(zip(foods, meds, [median] * 3))))
        head = Capsule(PyTask("head", lambda ctx: {}))
        return (puzzle(head) >> explore(SeedSampling(seed, 5, seed=7))
                >> model >> aggregate() >> stat), model, stat

    listing3(CONFIG, "CONFIG")
    # every member fails each lane's first attempt (before the model runs)
    # and never its second
    pool = EnvironmentPool(
        [LocalEnvironment(name=f"worker{i}", capacity=2,
                          faults=FaultSpec(fail_rate=1.0, fail_limit=1,
                                           seed=i)) for i in range(3)],
        retries=2, backoff_s=0.0)
    try:
        listing3(small, "REDUCED_small_sources", pool)
    finally:
        pool.shutdown()

    # -- Listing 4 ---------------------------------------------------------
    mu = lam = 10
    gens, reps = 10, 5
    cfg = NSGA2Config(mu=mu, genome_dim=2, bounds=BOUNDS, n_objectives=3,
                      reevaluate=0.01)
    eval_fn = ants_eval_fn(CONFIG, reps)
    states = []
    final, wall4, l4 = window("listing4_generational", lambda: (
        run_generational(cfg, eval_fn, make_generator(0, dev), lam=lam,
                         generations=gens, hooks=[states.append],
                         device=dev)))
    evals = int(final.evaluations)
    require(evals == mu + lam * gens and int(final.generation) == gens,
            f"Listing 4: {evals} evaluations after {int(final.generation)} "
            f"generations")
    require(final.genomes.shape == (mu, 2) and final.objectives.shape
            == (mu, 3) and bool(torch.isfinite(final.objectives).all())
            and bool(((final.genomes >= 0) & (final.genomes <= 99)).all()),
            "Listing 4: population shapes, finite objectives, genomes in "
            "bounds")
    require(l4["diffuse_evaporate"] == (1 + gens) * CONFIG.max_ticks
            and l4["dominance_pass"] == 2 * gens,
            f"Listing 4: launches {l4}")
    emit({"phase": "dsl", "listing": 4, "config": "CONFIG", "mu": mu,
          "lam": lam, "replicates": reps, "generations": gens,
          "reevaluate": 0.01, "evaluations": evals, "wall_s": wall4,
          "evaluations_per_hour": evals / wall4 * 3600,
          "launches": by_listing["listing4_generational"],
          "front_size": int((nsga2.nondominated_ranks(
              final.objectives, final.valid) == 0).sum())})

    # -- Listing 5 ---------------------------------------------------------
    kept = {}

    def island_fn(seed):
        state = run_islands(cfg, eval_fn, make_generator(int(seed), dev),
                            n_islands=4, lam=lam, steps_per_epoch=1,
                            epochs=2, archive_size=128, device=dev)
        kept["state"] = state
        a = state.archive
        return {"generation": state.epoch, "genomes": a.genomes[a.valid],
                "objectives": a.objectives[a.valid]}

    island = TorchTask("island", island_fn, inputs=(seed,),
                       outputs=(Val("generation"), Val("genomes"),
                                Val("objectives")), defaults={"seed": 0},
                       device=dev)
    with tempfile.TemporaryDirectory() as out:
        res, wall5, l5 = window("listing5", lambda: puzzle(
            Capsule(island).on(LocalEnvironment())
            .hook(SavePopulationHook(out))).run())
        latest = json.loads((Path(out) / "latest.json").read_text())
        with open(latest["path"], newline="") as f:
            rows = list(csv.reader(f))
    state = kept["state"]
    a = state.archive
    saved = np.array(rows[1:], dtype=np.float32)
    expect = torch.cat([a.genomes, a.objectives], 1)[a.valid].cpu().numpy()
    require(rows[0] == ["g0", "g1", "o0", "o1", "o2"]
            and latest["generation"] == 2 == state.epoch
            and np.array_equal(saved, expect) and len(saved) > 0,
            "Listing 5: the saved population differs from the archive")
    require(state.total_evaluations == 4 * (mu + 2 * lam)
            and l5["diffuse_evaporate"] == 3 * CONFIG.max_ticks
            and l5["dominance_pass"] > 0, f"Listing 5: {l5}")
    emit({"phase": "dsl", "listing": 5, "config": "CONFIG", "islands": 4,
          "mu": mu, "lam": lam, "steps_per_epoch": 1, "epochs": 2,
          "replicates": reps, "evaluations": state.total_evaluations,
          "archive_rows_saved": len(saved), "saved_equals_archive": True,
          "wall_s": wall5, "launches": by_listing["listing5"]})

    # -- the kernels at the Listings' shapes ---------------------------------
    gen = make_generator(1, dev)
    for n in (1, mu * reps, 4 * lam * reps):
        chem = torch.rand((n, 72, 72), generator=gen, device=dev) * 100.0
        rate = torch.rand((n,), generator=gen, device=dev)
        evap = torch.rand((n,), generator=gen, device=dev) * 0.5
        require(torch.equal(diffusion.diffuse_evaporate(chem, rate, evap),
                            ref.diffuse_evaporate_ref(chem, rate, evap)),
                f"diffuse_evaporate bitwise at the Listings' {n} lanes")
    pools = {"listing4_pool": (torch.cat([states[-2].objectives,
                                          final.objectives]), 1),
             "listing5_islands": (state.islands.objectives.reshape(-1, 3),
                                  4),
             "listing5_archive": (a.objectives, 0)}
    # the same shapes and groupings on seeded objectives: first-empty ticks
    # in [0, 1000] (many ties) with a quarter of the rows at +BIG, the
    # value ranking gives empty slots
    for name, (rows_, n_groups) in list(pools.items()):
        n = len(rows_)
        rand = torch.randint(0, 1001, (n, 3), generator=gen,
                             device=dev).to(torch.float32)
        rand[torch.randperm(n, generator=gen, device=dev)[:n // 4]] = \
            nsga2.BIG
        pools[f"{name}_seeded"] = (rand, n_groups)
    counts = {}
    for name, (rows_, n_groups) in pools.items():
        groups = nsga2.island_groups(n_groups, len(rows_) // n_groups, dev) \
            if n_groups else None
        kc, kb = dominance.dominance_pass(rows_, groups=groups)
        pc, pb = ref.dominance_pass_ref(rows_, groups=groups)
        require(torch.equal(kc, pc) and torch.equal(kb, pb),
                f"dominance_pass equal on {name}")
        counts[name] = {"rows": len(rows_), "groups": n_groups,
                        "dominated_rows": int((pc > 0).sum()),
                        "bitmap_bits": int(sum(bin(w & 0xFFFFFFFF).count("1")
                                               for w in pb.flatten()
                                               .tolist()))}
    for name in ("listing4_pool", "listing5_islands", "listing5_archive"):
        require(counts[f"{name}_seeded"]["dominated_rows"] > 0,
                f"dominance_pass: no row dominated in {name}_seeded")
    emit({"phase": "dsl", "what": "kernels_at_dsl_shapes",
          "diffuse_evaporate_lanes": [1, mu * reps, 4 * lam * reps],
          "diffuse_bitwise": True, "dominance_pass": counts,
          "dominance_equal": True})
    emit({"phase": "dsl", "seconds": time.monotonic() - t_phase,
          "launches_by_listing": by_listing, "launches": total})
    return total


# the island run of phases calibrate and mesh: the reference's defaults cut
# to 2 epochs
CAL_FLAGS = dict(n_islands=8, mu=16, lam=16, steps_per_epoch=4, epochs=2,
                 replicates=5, archive_size=256, merge_top_k=8)
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
# phase mesh's MeshEnvironment legs: an ants TorchTask on CONFIG's world and
# ants, cut to MESHENV_TICKS ticks, 4 replicate lanes a context ranked by
# B2; its outputs are the objectives, their ranks and the summed final
# chemical field (the signal: at CONFIG every objective is the cap)
MESHENV_TICKS = 200
MESHENV_CONTEXTS = [{"gDiffusionRate": d, "gEvaporationRate": e, "seed": s}
                    for d, e, s in ((30.0, 10.0, 3), (70.0, 40.0, 5),
                                    (50.0, 5.0, 7), (90.0, 20.0, 11))]


def meshenv_task(torch):
    """The ants ``TorchTask`` of phase mesh's MeshEnvironment legs: its
    generator is built from the ``seed`` input on every call, on the
    current CUDA device."""
    from repro_torch.ants import simulate_state
    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.core import TorchTask, Val
    from repro_torch.evolution import nsga2
    from repro_torch.runtime.device import make_generator
    cfg = dataclasses.replace(CONFIG, max_ticks=MESHENV_TICKS)

    def ants(gDiffusionRate, gEvaporationRate, seed):
        dev = torch.device("cuda")
        state = simulate_state(
            cfg, torch.full((4,), gDiffusionRate, device=dev),
            torch.full((4,), gEvaporationRate, device=dev),
            generator=make_generator(int(seed), dev))
        obj = state.ticks_empty.to(torch.float32)
        return {"objectives": obj, "ranks": nsga2.nondominated_ranks(obj),
                "chem": state.chem.sum(0)}

    return TorchTask("ants", ants, inputs=(
        Val("gDiffusionRate", float), Val("gEvaporationRate", float),
        Val("seed", int)), outputs=(Val("objectives"), Val("ranks"),
                                     Val("chem")))


def mesh_rank(argv) -> int:
    """One rank of phase ``mesh``, as ``chip_smoke.py --mesh-rank RANK WORLD
    STORE OUT``: joins a gloo process group through a FileStore at STORE,
    runs (a) the sharded dominance sweep at three shapes, B1 and B2 at the
    shapes the island run gives a rank, against their plain versions, and
    the archive merge sharded and local, (b) the island calibration
    over a ``data=WORLD`` mesh and (c) ``MeshEnvironment(mesh)`` exploring
    ``meshenv_task`` over MESHENV_CONTEXTS, writes OUT/rank{RANK}.json
    (checks, times, launches, walls) and .pt (the final archive and front,
    the explored outputs), and prints nothing of the contract."""
    import datetime
    import functools

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import MeshEnvironment
    from repro_torch.evolution import archive as tarchive
    from repro_torch.evolution import nsga2
    from repro_torch.kernels import diffusion, dominance, ops, ref
    from repro_torch.launch import explore
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import sharding

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    mesh = tmesh.make_island_mesh(data=world, device="cuda")
    dev = mesh.device
    require(mesh.shape == {"data": world} and mesh.rank == rank
            and dev.type == "cuda", f"mesh {mesh}")
    sweep = functools.partial(sharding.sharded_dominance_pass, mesh=mesh)
    result = {"rank": rank, "device": str(dev), "sweep": [],
              "step_kernels": []}

    def alone(kernel, plain) -> dict:
        """``kernel`` and ``plain`` timed on this rank while the others
        wait at a barrier: one rank times at a time, the card is shared."""
        timing = {}
        for r in range(world):
            if r == rank:
                kt, _ = turns_ms(torch, kernel, None, inner=10,
                                 hold_cycles=HOLD_CYCLES)
                pt, _ = turns_ms(torch, plain, None, reps=5, inner=3)
                timing = {"ms": kt["median"],
                          "ms_min_max": [kt["min"], kt["max"]],
                          "plain_ms": pt["median"]}
            dist.barrier()
        return timing

    # (a) the sharded sweep: the same seeded inputs on every rank
    gen = torch.Generator(device=dev).manual_seed(22)
    ticks = torch.randint(0, 1001, (320, 3), generator=gen,
                          device=dev).to(torch.float32)
    ticks[:256:2] = nsga2.BIG        # the archive's empty slots
    shapes = (
        ("section_4_5", torch.rand((8192, 3), generator=gen, device=dev),
         None),
        ("archive_merge_pool", ticks, None),
        ("padded_3_groups", torch.rand((997, 3), generator=gen, device=dev),
         torch.arange(997, device=dev, dtype=torch.int32) % 3))
    for name, f, g in shapes:
        n = len(f)
        counts, block = sweep(f, groups=g)
        one_c, one_b = ops.dominance_pass(f, groups=g)
        ref_c, ref_b = ref.dominance_pass_ref(f, groups=g)
        rows = block.words
        require(isinstance(block, sharding.RowBlock), f"{name}: not sharded")
        require(torch.equal(counts, one_c) and torch.equal(counts, ref_c),
                f"{name}: sharded counts")
        require(torch.equal(rows, one_b[block.row0:block.row0 + len(rows)])
                and torch.equal(rows, ref_b[block.row0:
                                            block.row0 + len(rows)]),
                f"{name}: sharded bitmap rows")
        ranks = nsga2.nondominated_ranks(f, groups=g, pass_fn=sweep)
        require(torch.equal(ranks, nsga2.nondominated_ranks(f, groups=g)),
                f"{name}: ranks through the sharded sweep")
        # this rank's rectangular launch: its padded block of rows against
        # every padded row, held to the plain version at that shape
        n_p = -(-n // (world * 32)) * (world * 32)
        b = n_p // world
        gp = torch.zeros((n,), dtype=torch.int32, device=dev) \
            if g is None else g
        fp = torch.cat([f, f.new_full((n_p - n, 3), sharding.BIG)])
        gp = torch.cat([gp, gp.new_full((n_p - n,), -1)])
        r0 = rank * b
        args = (fp[r0:r0 + b], fp, gp[r0:r0 + b], gp)
        kc, kb = ops.dominance_pass(*args)
        pc, pb = ref.dominance_pass_ref(*args)
        require(torch.equal(kc, pc) and torch.equal(kb, pb),
                f"{name}: the block's launch against its plain version")
        # the pairs this run's data needs: same-group pairs
        gr = torch.bincount(gp[r0:r0 + b] + 1, minlength=4)
        gc = torch.bincount(gp + 1, minlength=4)
        pairs = int((gr * gc).sum())
        words = n_p // 32
        n_bytes = (b + n_p) * 3 * 4 + (b + n_p) * 4 + b * 4 + b * words * 4
        b_ms, b_by = bound_ms(n_bytes, pairs * 2 * 3)
        timing = alone(lambda: ops.dominance_pass(*args),
                       lambda: ref.dominance_pass_ref(*args))
        result["sweep"].append({
            "shape": name, "n": n, "grouped": g is not None,
            "padded_rows": n_p, "block": [r0, b], "kept_rows": len(rows),
            "block_shape": [b, n_p, 3], "pairs": pairs,
            "counts_equal": True, "bitmap_rows_equal": True,
            "ranks_equal": True, "fronts": int(ranks.max()) + 1,
            "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
            **timing})

    # the kernels at the shapes the island run below gives each rank: B1 at
    # its block's lanes (islands a rank x mu or lam x replicates), B2 over
    # its block's islands as groups, at mu rows an island (the state's
    # ranking, the emigrants' top-k) and mu + lam (the step's selection);
    # seeded objectives with ties (ticks in [0, 1000]) and a quarter of the
    # rows at +BIG
    per_rank = CAL_FLAGS["n_islands"] // world
    for lanes in sorted({per_rank * CAL_FLAGS[k] * CAL_FLAGS["replicates"]
                         for k in ("mu", "lam")}):
        chem = torch.rand((lanes, 72, 72), generator=gen, device=dev) * 100.0
        rate = torch.rand((lanes,), generator=gen, device=dev)
        evap = torch.rand((lanes,), generator=gen, device=dev) * 0.5
        got = ops.diffuse_evaporate(chem, rate, evap)
        plain = ref.diffuse_evaporate_ref(chem, rate, evap)
        err = (got - plain).abs().max().item()
        require(torch.equal(got, plain),
                f"diffuse_evaporate bitwise at ({lanes},72,72), a rank's "
                f"block; max abs err {err}")
        # the custom op's route against the direct launcher
        require(torch.equal(got, diffusion.diffuse_evaporate(chem, rate,
                                                             evap)),
                f"diffuse_evaporate's op != its launcher at ({lanes},72,72)")
        b_ms, b_by = bound_ms(2 * chem.numel() * 4 + 2 * lanes * 4,
                              chem.numel() * DIFFUSION_OPS_PER_PATCH)
        result["step_kernels"].append({
            "kernel": "diffuse_evaporate", "shape": [lanes, 72, 72],
            "bitwise": True, "op_equals_launcher": True,
            "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by,
            **alone(lambda: ops.diffuse_evaporate(chem, rate, evap),
                    lambda: ref.diffuse_evaporate_ref(chem, rate, evap))})
    mu, lam = CAL_FLAGS["mu"], CAL_FLAGS["lam"]
    for size in (mu, mu + lam):
        n = per_rank * size
        f = torch.randint(0, 1001, (n, 3), generator=gen,
                          device=dev).to(torch.float32)
        f[torch.randperm(n, generator=gen, device=dev)[:n // 4]] = \
            nsga2.BIG
        g = nsga2.island_groups(per_rank, size, dev)
        kc, kb = ops.dominance_pass(f, groups=g)
        pc, pb = ref.dominance_pass_ref(f, groups=g)
        require(torch.equal(kc, pc) and torch.equal(kb, pb),
                f"dominance_pass at {n} rows in {per_rank} groups of {size}, "
                f"a rank's block, against its plain version")
        lc, lb = dominance.dominance_pass(f, None, g, None)
        require(torch.equal(kc, lc) and torch.equal(kb, lb),
                f"dominance_pass's op != its launcher at {n} rows")
        words = -(-n // 32)
        b_ms, b_by = bound_ms(n * 3 * 4 + n * 4 + n * 4 + n * words * 4,
                              per_rank * size * size * 2 * 3)
        result["step_kernels"].append({
            "kernel": "dominance_pass", "rows": n, "groups": per_rank,
            "group_rows": size, "big_rows": n // 4,
            "dominated_rows": int((pc > 0).sum()), "equal": True,
            "op_equals_launcher": True,
            "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
            **alone(lambda: ops.dominance_pass(f, groups=g),
                    lambda: ref.dominance_pass_ref(f, groups=g))})

    # the archive merge at the paper's defaults (256 slots, half empty, and
    # 8 islands' 8 emigrants), through the sweep sharded over the ranks and
    # through one local sweep of the replicated pool: equal archives, and
    # the wall of each (host clock, collectives included)
    arch = tarchive.Archive(
        torch.rand((256, 2), generator=gen, device=dev), ticks[:256],
        ticks[:256, 0] < nsga2.BIG)
    inc = (torch.rand((64, 2), generator=gen, device=dev), ticks[256:])
    sharded = tarchive.merge(arch, *inc, mesh=mesh)
    local = tarchive.merge(arch, *inc)
    require(all(torch.equal(a, b) for a, b in zip(sharded, local)),
            "archive merge: the sharded sweep's archive differs from one "
            "local sweep's")
    merge_ms = {}
    for name, m in (("sharded", mesh), ("local", None)):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            tarchive.merge(arch, *inc, mesh=m)
        torch.cuda.synchronize()
        merge_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    result["merge"] = {"pool_rows": 320, "equal": True, "calls": 20,
                       "sharded_ms": merge_ms["sharded"],
                       "local_ms": merge_ms["local"]}

    # (b) the island calibration over the mesh, counts from 0 just before
    with tempfile.TemporaryDirectory() as run_dir:
        dist.barrier()
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, front = explore.calibrate(
            reduced=False, out_dir=run_dir, device="cuda", mesh=mesh,
            printer=lambda s: None, **CAL_FLAGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(run_dir).iterdir())
    result.update(calibrate_wall_s=wall, launches=launches, files=files,
                  evaluations=state.total_evaluations)

    # (c) MeshEnvironment over this mesh: each rank its block of contexts
    env = MeshEnvironment(mesh)
    task = meshenv_task(torch)
    dist.barrier()
    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    explored = env.map_explore(task, MESHENV_CONTEXTS)
    torch.cuda.synchronize()
    result["meshenv"] = {"wall_s": time.perf_counter() - t0,
                         "lanes": [env.last_lanes.start,
                                   env.last_lanes.stop],
                         "launches": ops.kernel_launch_counts()}
    torch.save({"archive": [t.cpu() for t in state.archive],
                "front": front,
                "meshenv": [{k: v.cpu() for k, v in o.items()}
                            for o in explored]},
               Path(out) / f"rank{rank}.pt")
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def mesh_phase(torch, dev, one_rank, init_inline) -> dict:
    """Phase ``mesh``: several ranks, on the one card. Two ranks, spawned
    processes joined by gloo, both on cuda:0 (NCCL refuses two ranks on one
    device; one rank per card over NCCL needs several cards), run
    ``mesh_rank``: (a) ``sharded_dominance_pass`` at the section 4.5 shape
    (8192 x 3 uniform), the archive merge's pool at the paper's defaults
    (256 + 8 x 8 = 320 rows, half the archive's slots +BIG) and 997 rows
    in 3 groups (padded to 1024): counts and bitmap rows equal to the
    single ``dominance_pass`` and to ``dominance_pass_ref``, the ranks
    through the sharded sweep equal to the one-rank ranks, and each rank's
    rectangular launch (its block of padded rows against every padded row)
    equal to its plain version and timed; B1 at a rank's block of lanes
    (4 islands x 16 x 5 replicates = 320) and B2 at its grouped rankings
    (64 rows in 4 groups of 16, 128 in 4 of 32; ties and +BIG rows) held to
    their plain versions and timed; the 320-row archive merge through the
    sharded sweep and through one local sweep, equal, both timed; (b)
    ``explore.calibrate`` at
    CONFIG with the calibrate phase's flags over a ``data=2`` mesh: its
    archive (genomes, objectives, valid), evaluations and front equal bit
    for bit to ``one_rank`` (phase calibrate's (state, front, wall)), its
    launches counted from 0 in each rank. (c) The streaming init's fourth
    leg, through ``make_init_pool(0.35, pool_devices=1)`` (one
    DeviceEnvironment of the card), bitwise equal to ``init_inline``
    (phase init's inline leg). (d) ``MeshEnvironment`` exploring
    ``meshenv_task`` over MESHENV_CONTEXTS: each rank of (a)'s mesh its
    block of two contexts, then on one rank (``make_host_mesh``) all four
    here; every context's outputs bitwise equal to ``LocalEnvironment``'s.
    Every child is joined under a timeout; a child that fails fails the
    phase. Returns the launches of (b), summed over the ranks (the "mesh"
    path of the kernels line), and those of (d)'s MeshEnvironment legs, one
    rank and two summed (the "meshenv" path)."""
    import numpy as np

    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.core import LocalEnvironment, MeshEnvironment
    from repro_torch.evolution import ga
    from repro_torch.kernels import ops
    from repro_torch.launch import explore
    from repro_torch.launch import mesh as tmesh

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w")
                for r in range(MESH_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             str(r), str(MESH_RANKS), str(Path(tmp) / "store"), tmp],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
            for r in range(MESH_RANKS)]
        deadline = time.monotonic() + MESH_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print((Path(tmp) / f"rank{r}.log").read_text()[-4000:],
                      file=sys.stderr)
            require(p.returncode == 0,
                    f"mesh rank {r} exited {p.returncode}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
        saved = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(MESH_RANKS)]
    spawn_s = time.monotonic() - t_phase

    state, front, wall = one_rank
    for r, (res, got) in enumerate(zip(ranks, saved)):
        for name, a, b in zip(("genomes", "objectives", "valid"),
                              got["archive"], state.archive):
            require(torch.equal(a, b.cpu()),
                    f"mesh rank {r}: archive {name} differs from one rank")
        require(got["front"]["evaluations"] == front["evaluations"]
                == res["evaluations"]
                and got["front"]["genomes"] == front["genomes"]
                and got["front"]["objectives"] == front["objectives"],
                f"mesh rank {r}: front differs from one rank")
        require(res["launches"]["dominance_pass"] > 0
                and res["launches"]["diffuse_evaporate"] > 0,
                f"mesh rank {r}: launches {res['launches']}")
    # rank 0 alone writes the run's files
    require({"pareto_front.json", "provenance.json", "populations",
             "checkpoints"} <= set(ranks[0]["files"]),
            f"mesh rank 0 outputs {ranks[0]['files']}")
    n_sims = 1 + CAL_FLAGS["epochs"] * CAL_FLAGS["steps_per_epoch"]
    b1 = [res["launches"]["diffuse_evaporate"] for res in ranks]
    require(b1 == [n_sims * CONFIG.max_ticks] * MESH_RANKS,
            f"mesh: diffuse_evaporate launches {b1}")
    for r, res in enumerate(ranks):
        for row in res["sweep"]:
            emit({"phase": "mesh", "what": "sharded_sweep", "rank": r,
                  **row})
        for row in res["step_kernels"]:
            emit({"phase": "mesh", "what": "kernels_at_rank_shapes",
                  "rank": r, **row})
        emit({"phase": "mesh", "what": "archive_merge", "rank": r,
              **res["merge"]})
    emit({"phase": "mesh", "what": "calibrate", "config": "CONFIG",
          **CAL_FLAGS, "mesh": {"data": MESH_RANKS},
          "backend": "gloo", "ranks_on": [res["device"] for res in ranks],
          "one_rank_wall_s": wall,
          "rank_walls_s": [res["calibrate_wall_s"] for res in ranks],
          "equal_to_one_rank": True,
          "rank_launches": {
              r: {k: res["launches"][k] for k in ("diffuse_evaporate",
                                                   "dominance_pass")}
              for r, res in enumerate(ranks)},
          "spawn_to_results_s": spawn_s})

    # (c) the streaming init through a device-set member of the card
    cfg = explore.NSGA2Config(mu=16, genome_dim=2, bounds=explore.BOUNDS)
    pool = explore.make_init_pool(0.35, pool_devices=1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = ga.evaluate_population_streaming(
            cfg, explore.ants_eval_fn(CONFIG, 5), 0, n_total=14336,
            chunk=4096, device=torch.device("cuda"), environment=pool)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
        members = [m.name for m in pool.members]
    finally:
        pool.shutdown()
    require(np.array_equal(d.objectives, init_inline.objectives)
            and np.array_equal(d.genomes, init_inline.genomes),
            "init leg (d), pool_devices=1, differs from the inline leg")
    require(d.attempts > d.chunks_total,
            f"init leg (d): {d.attempts} attempts for {d.chunks_total} "
            f"chunks at 35 % failures")
    emit({"phase": "mesh", "what": "init_pool_devices", "leg": "d",
          "members": members, "n_total": 14336, "chunk": 4096,
          "attempts": d.attempts, "chunks": d.chunks_total, "wall_s": wall_d,
          "evaluations_per_hour": 14336 / wall_d * 3600,
          "equal_to_inline": True})
    # (d) MeshEnvironment: one rank here, against LocalEnvironment and the
    # two ranks' runs
    task = meshenv_task(torch)
    env = MeshEnvironment(tmesh.make_host_mesh("cuda"))
    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = env.map_explore(task, MESHENV_CONTEXTS)
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    one_launches = ops.kernel_launch_counts()
    t0 = time.perf_counter()
    local = LocalEnvironment().map_explore(task, MESHENV_CONTEXTS)
    torch.cuda.synchronize()
    wall_local = time.perf_counter() - t0
    n_ctx = len(MESHENV_CONTEXTS)
    for leg, outs in [("one rank", one)] + [
            (f"rank {r} of {MESH_RANKS}", got["meshenv"])
            for r, got in enumerate(saved)]:
        require(len(outs) == n_ctx and all(
            torch.equal(o[k].cpu(), lo[k].cpu())
            for o, lo in zip(outs, local) for k in lo),
            f"MeshEnvironment ({leg}) differs from LocalEnvironment")
    per_ctx = {"diffuse_evaporate": MESHENV_TICKS, "dominance_pass": 1}
    require(all(one_launches[k] == n_ctx * v for k, v in per_ctx.items()),
            f"MeshEnvironment one rank: launches {one_launches}")
    for r, res in enumerate(ranks):
        got = res["meshenv"]
        b = n_ctx // MESH_RANKS
        require(got["lanes"] == [r * b, (r + 1) * b]
                and all(got["launches"][k] == b * v
                        for k, v in per_ctx.items()),
                f"MeshEnvironment rank {r}: lanes {got['lanes']}, "
                f"launches {got['launches']}")
    chem = torch.stack([lo["chem"] for lo in local])
    require(bool((chem > 0).any()) and len({float(c.sum()) for c in chem})
            == n_ctx, "MeshEnvironment's task: the chemical fields carry "
            "no per-context signal")
    meshenv_total = dict(one_launches)
    for res in ranks:
        for k, v in res["meshenv"]["launches"].items():
            meshenv_total[k] += v
    emit({"phase": "mesh", "what": "mesh_environment", "config": "CONFIG",
          "ticks": MESHENV_TICKS, "contexts": n_ctx, "lanes_a_context": 4,
          "one_rank_wall_s": wall_one, "local_wall_s": wall_local,
          "rank_walls_s": [res["meshenv"]["wall_s"] for res in ranks],
          "rank_lanes": [res["meshenv"]["lanes"] for res in ranks],
          "equal_to_local": True, "launches": {
              k: meshenv_total[k] for k in per_ctx}})
    emit({"phase": "mesh", "seconds": time.monotonic() - t_phase})
    total = {}
    for res in ranks:
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
    return total, meshenv_total


# Jobs in flight on one pool contend for the host: on one H100 a job ran
# 40-50 s while six ran and 5-6 s while two ran, against 1.4-1.7 s alone.
# Phase surrogate_mo runs through the launcher's default pool,
# make_init_pool(0.35) (3 workers x 2 slots), with its depth cut to batches
# of 4 (n_init 8: 2 Sobol rounds and 1 qEHVI round) so that at most four
# jobs run at once. The service's surrogate tenant must replay phase
# surrogate's q 8, n_init 16, so the service runs through
# make_init_pool(0.35, pool_devices=1), one device-set member of the card
# with two jobs in flight, and its init is cut from the launcher's 2048 to
# 1024 individuals (4 chunks of 256). Through the 3 x 2 pool the service
# took 197 s, past what the script's time limit holds.
MO_FLAGS = dict(rounds=3, q=4, n_init=8, replicates=3)
SERVICE_FLAGS = dict(init_population=1024, init_chunk=256, rounds=3, q=8,
                     n_init=16, replicates=3, pool_devices=1)


def mo_synthetic(x):
    """Three conflicting objectives of unit-square genomes x (n, 2), with a
    ripple, so the per-objective GPs fit non-constant surfaces: the
    history of phase surrogate_mo's legs (b) and (c), where CONFIG's
    objectives (all at the 1000-tick cap) would give the GPs constants."""
    import numpy as np
    f1 = x[:, 0] ** 2 + (x[:, 1] - 1.0) ** 2
    f2 = (x[:, 0] - 1.0) ** 2 + x[:, 1] ** 2
    f3 = (x[:, 0] - 0.5) ** 2 + 0.2 * np.sin(7 * x[:, 1])
    return np.stack([f1, f2, f3], 1).astype(np.float32)


def launch_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def surrogate_mo_phase(torch, dev, results) -> dict:
    """Phase ``surrogate_mo``: the multi-objective qEHVI surrogate. (a)
    ``explore.calibrate_surrogate_mo(device="cuda", reduced=False)`` at
    CONFIG, MO_FLAGS (2 Sobol rounds and 1 qEHVI round of 4, 3
    replicates), through ``make_init_pool(0.35)``, the launcher's default
    pool (3 workers x 2 slots): 12 evaluations, attempts > 12, a finite
    front and hypervolume; then the
    run stopped at its round-2 commit (a copy of that checkpoint) and
    resumed inline: the history, front and hypervolume bit for bit the
    pooled run's. Launch counts run from 0 at the calibrate run to the end
    of the resume (the "surrogate_mo" path of the kernels line). (b) An
    explorer told 64 points of
    ``mo_synthetic``: one ask on the card and one on the CPU from the same
    draws: equal archives, gains within 4 / (mc_samples x hv_samples) (a
    posterior mean that moves by f32 rounding can flip a few sample-cell
    comparisons), picks equal wherever the CPU's gain leads the next
    slot's by more than that. (c) Archive scale: 8192 told points of
    ``mo_synthetic`` (past n_max_exact 1024), the archive replayed from the
    history, then one cold ask with big_method "inducing" (B4 and B7) and
    one with "ensemble" (16 experts of 512; B4): finite batches, gains and
    posteriors, walls; launch counts from 0 around (c) are the
    "surrogate_mo_big" path. (d) B2 at the box
    sweeps' shapes (128 box samples against a 64-row front, 4096 against
    64 and 37 rows, +BIG rows in the front) against its plain version:
    equal, timed beside the bound; into ``results``. Returns the two
    paths' launch counts."""
    import numpy as np

    from repro_torch.evolution import nsga2
    from repro_torch import checkpoint
    from repro_torch.explore import moacq, surrogate
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import explore

    t_phase = time.monotonic()
    ops.reset_kernel_launch_counts()
    # (a) the launcher at CONFIG through the faulty pool, then inline legs
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, result = explore.calibrate_surrogate_mo(
            reduced=False, device="cuda", fault_rate=0.35, out_dir=out,
            printer=lambda s: emit({"phase": "surrogate_mo", "log": s}),
            **MO_FLAGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cal_launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(out).iterdir())
        # a run stopped after 2 rounds holds what the round-2 commit holds:
        # resume a copy of it inline, with the settings it was written with
        ck = Path(out) / "stopped"
        shutil.copytree(Path(out) / "surrogate_checkpoints" / "step_00000002",
                        ck / "step_00000002")
        settings = checkpoint.restore(
            str(ck), 2, {"x01": None, "y": None, "round": None,
                         "settings": None})["settings"].item()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = moacq.run_surrogate_mo(
            moacq.MOSurrogateConfig(bounds=explore.BOUNDS, n_objectives=3,
                                    q=MO_FLAGS["q"],
                                    n_init=MO_FLAGS["n_init"], seed=0),
            explore.ants_mo_eval(False, MO_FLAGS["replicates"]),
            rounds=MO_FLAGS["rounds"], checkpoint_dir=str(ck),
            device="cuda", settings=settings)
        torch.cuda.synchronize()
        wall_inline = time.perf_counter() - t0
        mo_launches = ops.kernel_launch_counts()
    n_evals = MO_FLAGS["rounds"] * MO_FLAGS["q"]
    require(len(res.objectives) == n_evals == len(result["objectives"])
            and res.objectives.shape == (n_evals, 3),
            f"surrogate_mo evaluations {res.objectives.shape}")
    require(res.attempts > n_evals,
            f"surrogate_mo: {res.attempts} attempts for {n_evals} "
            f"evaluations at 35 % failures")
    require(len(res.front_objectives) >= 1
            and bool(np.isfinite(res.front_objectives).all())
            and bool(((res.front_objectives >= 0)
                      & (res.front_objectives <= 1000)).all())
            and np.isfinite(res.hv) and res.hv > 0,
            f"surrogate_mo front {res.front_objectives}, hv {res.hv}")
    require({"surrogate_mo_result.json", "provenance.json"} <= set(files),
            f"surrogate_mo outputs {files}")
    require(resumed.resumed_rounds == 2 and resumed.rounds_done == 3
            and np.array_equal(resumed.genomes, res.genomes)
            and np.array_equal(resumed.objectives, res.objectives)
            and np.array_equal(resumed.front_objectives,
                               res.front_objectives)
            and resumed.hv == res.hv,
            "surrogate_mo stopped after 2 rounds and resumed inline differs "
            "from the pooled run")
    for k in ("diffuse_evaporate", "dominance_pass", "gp_sqdist"):
        require(mo_launches[k] > 0, f"surrogate_mo path: no {k} launch "
                f"({mo_launches})")
    emit({"phase": "surrogate_mo", "config": "CONFIG", **MO_FLAGS,
          "fault_rate": 0.35,
          "pool_members": "3 x LocalEnvironment, 2 slots each",
          "wall_s": wall, "evaluations": n_evals,
          "evaluations_per_hour": n_evals / wall * 3600,
          "attempts": res.attempts, "front_size": len(res.front_objectives),
          "hypervolume": res.hv, "launches": cal_launches,
          "resumed_from_round_2_inline_wall_s": wall_inline,
          "resumed_equal_bitwise": True,
          "launches_with_resume": mo_launches})

    # (b) the card against the CPU on a history whose objectives vary
    bcfg = moacq.MOSurrogateConfig(bounds=((0.0, 1.0), (0.0, 1.0)),
                                   n_objectives=3, q=8, n_init=16, seed=0)
    rng = np.random.default_rng(5)
    hx = rng.random((64, 2)).astype(np.float32)
    asks = {}
    for where in ("cpu", "cuda"):
        ex = moacq.MOSurrogateExplorer(bcfg, device=where)
        ex.load_state_arrays({"x01": hx, "y": mo_synthetic(hx),
                              "round": np.int32(8)})
        draws = moacq.draw_ask(bcfg, ex.round)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ex.ask(draws)
        torch.cuda.synchronize()
        asks[where] = (batch, ex.last_gains,
                       [t.cpu() for t in ex.archive],
                       time.perf_counter() - t0)
    (bc, gc, ac, tc), (bg, gg, ag, tg) = asks["cpu"], asks["cuda"]
    gain_tol = 4.0 / (bcfg.mc_samples * bcfg.hv_samples)
    require(all(torch.equal(a, b) for a, b in zip(ac, ag)),
            "surrogate_mo: the archive on the card differs from the CPU's")
    gain_err = float(np.abs(gg - gc).max())
    require(gain_err <= gain_tol,
            f"surrogate_mo: gains card {gg.tolist()} vs CPU {gc.tolist()}")
    decided = [s for s in range(bcfg.q)
               if s == bcfg.q - 1 or gc[s] - gc[s + 1] > gain_tol]
    pick_err = max(float(np.abs(bg[s] - bc[s]).max()) for s in decided)
    require(pick_err <= 1e-6,
            f"surrogate_mo: picks card {bg.tolist()} vs CPU {bc.tolist()}")
    emit({"phase": "surrogate_mo", "what": "ask_card_vs_cpu", "history": 64,
          "gains_cuda": gg.tolist(), "gains_cpu": gc.tolist(),
          "gain_max_abs_err": gain_err, "gain_tolerance": gain_tol,
          "slots_compared": decided, "pick_max_abs_err": pick_err,
          "archives_equal": True, "ask_s": {"cpu": tc, "cuda": tg}})

    # (c) archive scale: 8192 told points, the inducing and ensemble fits
    n_arch = 8192
    hx = rng.random((n_arch, 2)).astype(np.float32)
    hy = mo_synthetic(hx)
    icfg = dataclasses.replace(bcfg, big_method="inducing")
    ecfg = dataclasses.replace(bcfg, big_method="ensemble", expert_size=512)
    ops.reset_kernel_launch_counts()
    ex = moacq.MOSurrogateExplorer(icfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.load_state_arrays({"x01": hx, "y": hy,
                          "round": np.int32(n_arch // bcfg.q)})
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    big = {}
    for name, c in (("inducing", icfg), ("ensemble", ecfg)):
        e = moacq.MOSurrogateExplorer(c, device="cuda")
        # the replayed archive serves both (it does not depend on the fit)
        e.x01, e.y, e.round, e.archive = ex.x01, ex.y, ex.round, ex.archive
        before = ops.kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = e.ask()
        torch.cuda.synchronize()
        ask_s = time.perf_counter() - t0
        launches = launch_delta(ops.kernel_launch_counts(), before)
        st = surrogate.gp_fit(c.gp_config(), torch.from_numpy(hx).to(dev),
                              torch.from_numpy(hy[:, 0]).to(dev))
        mean, var = surrogate.gp_mean_var(
            c.gp_config(), st, torch.from_numpy(
                ((batch - e._lo) / e._span).astype(np.float32)).to(dev))
        require(type(st).__name__ == {"inducing": "InducingGPState",
                                      "ensemble": "EnsembleGPState"}[name],
                f"surrogate_mo {name}: state {type(st).__name__}")
        require(batch.shape == (8, 2) and bool(np.isfinite(batch).all())
                and bool(((batch >= 0) & (batch <= 1)).all())
                and bool(np.isfinite(e.last_gains).all())
                and bool(torch.isfinite(mean).all() and (var > 0).all()),
                f"surrogate_mo {name} at {n_arch}: batch {batch.tolist()}, "
                f"gains {e.last_gains}")
        require(launches["gp_sqdist"] >= 3
                and (name == "ensemble" or launches["tri_solve"] >= 3),
                f"surrogate_mo {name} ask launches {launches}")
        big[name] = {"cold_ask_s": ask_s, "launches": launches,
                     "gains": e.last_gains.tolist(),
                     "lengthscale_objective_0": float(st.lengthscale)}
        if name == "ensemble":
            big[name]["experts"] = int(st.x.shape[0])
    big_launches = ops.kernel_launch_counts()
    for k in ("dominance_pass", "gp_sqdist", "tri_solve"):
        require(big_launches[k] > 0, f"surrogate_mo_big path: no {k} "
                f"launch ({big_launches})")
    emit({"phase": "surrogate_mo", "what": "archive_scale",
          "history": n_arch, "n_max_exact": bcfg.n_max_exact,
          "n_inducing": bcfg.n_inducing, "expert_size": 512,
          "archive_replay_s": replay_s, "merges_replayed": n_arch // bcfg.q,
          **big, "launches": big_launches})

    # (d) B2 at the box sweeps' shapes against its plain version
    gen = torch.Generator(device=dev).manual_seed(23)
    rows_out = []
    for ni, nj, n_big in ((128, 64, 24), (4096, 64, 16), (4096, 37, 0)):
        u = torch.rand((ni, 3), generator=gen, device=dev) * 2.0 - 1.0
        front = torch.randn((nj, 3), generator=gen, device=dev) * 0.5
        front[nj - n_big:] = nsga2.BIG
        kc, kb = ops.dominance_pass(u, front)
        pc, pb = ref.dominance_pass_ref(u, front)
        torch.cuda.synchronize()
        require(torch.equal(kc, pc) and torch.equal(kb, pb),
                f"dominance_pass equal at the box sweep {ni} x {nj}")
        require(int((kc > 0).sum()) > 0, f"box sweep {ni} x {nj}: no cell "
                f"dominated")
        words = -(-nj // 32)
        n_bytes = (ni + nj) * 3 * 4 + ni * 4 + ni * words * 4
        b_ms, b_by = bound_ms(n_bytes, ni * nj * 2 * 3)
        kt, _ = turns_ms(torch, lambda: ops.dominance_pass(u, front), None,
                         inner=10, hold_cycles=HOLD_CYCLES)
        pt, _ = turns_ms(torch, lambda: ref.dominance_pass_ref(u, front),
                         None, reps=5, inner=3)
        r = {"kernel": "dominance_pass", "shape": [ni, nj, 3],
             "big_rows": n_big, "equal": True, "max_abs_err": 0.0,
             "cells_dominated": int((kc > 0).sum()),
             "timed_by": "cuda_events_queued", "ms": kt["median"],
             "ms_min_max": [kt["min"], kt["max"]], "plain_ms": pt["median"],
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        results[("dominance_pass_box", ni, nj)] = r
        rows_out.append(r)
    emit({"phase": "surrogate_mo", "what": "kernels_at_box_sweep_shapes",
          "rows": rows_out})
    emit({"phase": "surrogate_mo", "seconds": time.monotonic() - t_phase,
          "launches": {"surrogate_mo": mo_launches,
                       "surrogate_mo_big": big_launches}})
    return mo_launches, big_launches


def service_phase(torch, dev, sur_res) -> dict:
    """Phase ``service``: the exploration service with its two tenants.
    (a) ``explore.calibrate_service(device="cuda", reduced=False)`` at
    CONFIG, SERVICE_FLAGS (the GA tenant's 1024 individuals in chunks of
    256, the surrogate tenant's 3 rounds of 8, 3 replicates), through
    ``make_init_pool(0.35, pool_devices=1)`` (one device-set member of the
    card, two jobs in flight); then the GA tenant's best 128 by NSGA-II
    truncation (``ga.select_top_streaming``, B2), as an island run would be
    seeded.
    Launch counts from 0 around both (the "service" path of the kernels
    line). The provenance records must show a firing that the pool retried
    (more than one attempt). Each GA chunk's time in the queue (from the
    service's start, when the GA tenant submits every chunk, to the start
    of its execution: the record's completion offset less its wall) is
    reported beside its execution wall and its attempts' walls.
    (b) A second service on the same journal and cache,
    resubmitting both tenants: no diffuse_evaporate launch, every record
    mode "cache", the same results bit for bit. Then the GA tenant's
    objectives and genomes against an inline ``evaluate_population_
    streaming`` of the same 1024 at chunk 256, and its picks against the
    inline run's, bit for bit; the surrogate tenant's history against the
    first 24 rows of ``sur_res`` (phase surrogate's run: the same
    SurrogateConfig, seed 0, q-EI), bit for bit. (c) The queue's counts,
    the re-prioritizations and each tenant's wall."""
    import numpy as np

    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.evolution import ga
    from repro_torch.kernels import ops
    from repro_torch.launch import explore

    t_phase = time.monotonic()
    ga_cfg = explore.NSGA2Config(mu=16, genome_dim=2, bounds=explore.BOUNDS,
                                 n_objectives=3)
    k_top = 128
    with tempfile.TemporaryDirectory() as out:
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tenants, result = explore.calibrate_service(
            reduced=False, device="cuda", fault_rate=0.35, out_dir=out,
            printer=lambda s: emit({"phase": "service", "log": s}),
            **SERVICE_FLAGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gres, sres = tenants["ga"], tenants["surrogate"]
        top_g, top_o = ga.select_top_streaming(ga_cfg, gres.genomes,
                                               gres.objectives, k_top,
                                               device=dev)
        torch.cuda.synchronize()
        svc_launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(out).iterdir())
        modes, firings = {}, {}
        for eid in ("ga-init", "surrogate"):
            prov = json.loads((Path(out) / f"provenance_{eid}.json")
                              .read_text())
            modes[eid] = sorted({t["mode"] for t in prov["tasks"]})
            # the service stamps a record's started_s when the firing
            # completes; wall_s is its execution through the pool
            firings[eid] = sorted(
                ({"queue_seq": t["capsule"],
                  "queued_s": t["started_s"] - t["wall_s"],
                  "wall_s": t["wall_s"],
                  "attempts": len(t["attempts"] or ()),
                  "attempt_walls_s": [a["wall_s"]
                                      for a in t["attempts"] or ()],
                  "outcomes": [a["outcome"] for a in t["attempts"] or ()]}
                 for t in prov["tasks"]), key=lambda f: f["queued_s"])

        # (b) a restarted service on the same journal and cache
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again, result2 = explore.calibrate_service(
            reduced=False, device="cuda", fault_rate=0.35, out_dir=out,
            printer=lambda s: emit({"phase": "service", "log": s}),
            **SERVICE_FLAGS)
        torch.cuda.synchronize()
        wall_restart = time.perf_counter() - t0
        restart_launches = ops.kernel_launch_counts()
        restart_modes = {}
        for eid in ("ga-init", "surrogate"):
            prov = json.loads((Path(out) / f"provenance_{eid}.json")
                              .read_text())
            restart_modes[eid] = sorted({t["mode"] for t in prov["tasks"]})
    n_chunks = -(-SERVICE_FLAGS["init_population"]
                 // SERVICE_FLAGS["init_chunk"])
    n_sur = SERVICE_FLAGS["rounds"] * SERVICE_FLAGS["q"]
    require({"service_result.json", "provenance_ga-init.json",
             "provenance_surrogate.json", "queue.jsonl", "cache"}
            <= set(files), f"service outputs {files}")
    require(modes == {"ga-init": ["service"], "surrogate": ["service"]},
            f"service record modes {modes}")
    retried = {eid: sum(f["attempts"] > 1 for f in fs)
               for eid, fs in firings.items()}
    n_attempts = {eid: sum(f["attempts"] for f in fs)
                  for eid, fs in firings.items()}
    require(sum(retried.values()) >= 1
            and all(f["attempts"] >= 1 for fs in firings.values()
                    for f in fs),
            f"service at 35 % failures: no firing retried ({firings})")
    require(result["queue"] == {"pending": 0, "running": 0,
                                "done": n_chunks + n_sur, "failed": 0},
            f"service queue {result['queue']}")
    require(restart_launches["diffuse_evaporate"] == 0,
            f"the restarted service ran the model: {restart_launches}")
    require(restart_modes == {"ga-init": ["cache"], "surrogate": ["cache"]},
            f"the restarted service's record modes {restart_modes}")
    g2, s2 = again["ga"], again["surrogate"]
    require(np.array_equal(g2.objectives, gres.objectives)
            and np.array_equal(s2.genomes, sres.genomes)
            and np.array_equal(s2.objectives, sres.objectives),
            "the restarted service's results differ")
    for k in ("diffuse_evaporate", "dominance_pass", "gp_sqdist"):
        require(svc_launches[k] > 0, f"service path: no {k} launch "
                f"({svc_launches})")

    # the GA tenant against the inline streaming init, the surrogate tenant
    # against phase surrogate's run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inline = ga.evaluate_population_streaming(
        ga_cfg, explore.ants_eval_fn(CONFIG, SERVICE_FLAGS["replicates"]), 0,
        n_total=SERVICE_FLAGS["init_population"],
        chunk=SERVICE_FLAGS["init_chunk"], device=dev)
    torch.cuda.synchronize()
    wall_inline = time.perf_counter() - t0
    in_g, in_o = ga.select_top_streaming(ga_cfg, inline.genomes,
                                         inline.objectives, k_top,
                                         device=dev)
    require(np.array_equal(gres.objectives, inline.objectives)
            and np.array_equal(gres.genomes, inline.genomes),
            "the GA tenant differs from the inline streaming init")
    require(torch.equal(top_g, in_g) and torch.equal(top_o, in_o),
            "the GA tenant's picks differ from the inline run's")
    require(np.array_equal(sres.genomes, sur_res.genomes[:n_sur])
            and np.array_equal(sres.objectives, sur_res.objectives[:n_sur]),
            "the surrogate tenant differs from phase surrogate's first "
            f"{n_sur} evaluations")
    emit({"phase": "service", "config": "CONFIG", **SERVICE_FLAGS,
          "fault_rate": 0.35, "wall_s": wall,
          "pool_members": "1 x DeviceEnvironment(cuda)",
          "ga_tenant": {"wall_s": gres.wall_s, "attempts": gres.attempts,
                        "chunks": gres.chunks_done,
                        "pool_attempts": n_attempts["ga-init"],
                        "firings_retried": retried["ga-init"],
                        "chunks_queued_and_run": firings["ga-init"],
                        "evaluations_per_hour":
                            SERVICE_FLAGS["init_population"] / gres.wall_s
                            * 3600,
                        "equal_to_inline": True,
                        "inline_wall_s": wall_inline,
                        "top_k": k_top, "top_k_equal": True},
          "surrogate_tenant": {"wall_s": sres.wall_s,
                               "repriorities": sres.repriorities,
                               "attempts": sres.attempts,
                               "pool_attempts": n_attempts["surrogate"],
                               "firings_retried": retried["surrogate"],
                               "slot_queued_s": [f["queued_s"] for f in
                                                 firings["surrogate"]],
                               "slot_wall_s": [f["wall_s"] for f in
                                               firings["surrogate"]],
                               "best_objective": sres.best_objective,
                               "equal_to_phase_surrogate": True},
          "queue": result["queue"], "launches": svc_launches,
          "restart": {"wall_s": wall_restart, "launches": restart_launches,
                      "record_modes": restart_modes,
                      "results_equal": True}})
    emit({"phase": "service", "seconds": time.monotonic() - t_phase})
    return svc_launches


# Phase serve: logits held card == CPU within this (atol and rtol), the
# reference's own decode-against-prefill tolerance; (d)'s CONFIG archs
SERVE_TOL = 2e-4
SERVE_CONFIG_ARCHS = (("granite-moe-1b-a400m", "float32"),
                      ("mamba2-2.7b", "float32"),
                      ("whisper-base", "float32"),
                      ("deepseek-v2-lite-16b", "bfloat16"))


def hold_to_cpu(torch, model, params, prompts, frames, tokens) -> dict:
    """The card's served ``tokens`` (B, N) teacher-forced through the
    card's model and through the same weights on the CPU: every step's
    logits within SERVE_TOL, and the card's tokens equal to the CPU's
    argmax wherever the CPU's top-2 margin exceeds it (each row followed up
    to its first step at or under the margin, where the two may part)."""
    from repro_torch.models import build
    from repro_torch.models.common import tree_map
    from repro_torch.serve import teacher_forced_logits
    toks = torch.as_tensor(tokens, device=prompts.device)
    card = teacher_forced_logits(model, params, prompts, toks, frames=frames)
    cpu_model = build(model.cfg, "cpu")
    cpu = teacher_forced_logits(
        cpu_model, tree_map(lambda t: t.cpu(), params), prompts.cpu(),
        toks.cpu(), frames=None if frames is None else frames.cpu())
    card = card.cpu()
    err = (card - cpu).abs()
    close = bool((err <= SERVE_TOL + SERVE_TOL * cpu.abs()).all())
    top2 = cpu.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                    # (N, B)
    argmax = cpu.argmax(-1)
    followed, unequal = 0, []
    for r in range(toks.shape[0]):
        for t in range(toks.shape[1]):
            if margin[t, r] <= SERVE_TOL:
                break
            followed += 1
            if int(argmax[t, r]) != int(tokens[r, t]):
                unequal.append((r, t))
    out = {"max_abs_err": float(err.max()),
           "min_margin": float(margin.min()), "steps_followed": followed,
           "steps": int(margin.numel()), "tolerance": SERVE_TOL,
           "card_logits_finite": bool(torch.isfinite(card).all())}
    require(close, f"serve: card logits against the CPU's beyond "
            f"{SERVE_TOL}: {out}")
    require(not unequal, f"serve: card tokens differ from the CPU's argmax "
            f"at (row, step) {unequal[:8]}: {out}")
    require(out["card_logits_finite"], f"serve: non-finite logits {out}")
    return out


def serve_phase(torch, dev) -> dict:
    """Phase ``serve``: LM serving through the entry point a user calls,
    ``launch.serve.serve_once`` (``engine.generate`` → ``Model.prefill`` /
    ``decode``), with ``use_flash_kernel=False`` as the reference serves:
    every layer's attention is ``_sdpa``, so no kernel of the port runs.
    (a) smollm-135m at CONFIG at the reference's defaults (batch 4, prompt
    16, 24 new tokens, greedy) in f32, then in bf16 (the config's dtype):
    cold and warm s, warm tok/s, peak memory, and the idle share over one
    warm ``generate`` (``light_busy_share``); the launch counts read
    around (a) are the "serve" path of the kernels line. (b) the f32 run
    held to the CPU (``hold_to_cpu``, TF32 off). (c) every arch at REDUCED
    through ``serve_once`` on the card, each held to the CPU the same way.
    (d) SERVE_CONFIG_ARCHS at CONFIG: init, cold and warm s, peak memory;
    finite logits of the served tokens, tokens in range. Every kernel must
    show 0 launches in (a), (c) and (d)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve import generate, teacher_forced_logits

    def quiet(*_):
        pass

    def no_launches(counts, what):
        require(not any(counts.values()),
                f"serve {what}: a kernel of the port was launched {counts}")

    def served(arch, reduced, dtype):
        """serve_once with the peak memory around it."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tokens, stats = serve.serve_once(arch, reduced=reduced, dtype=dtype,
                                         printer=quiet, device="cuda")
        stats["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats["memory_before_gb"] = base / 1e9
        return tokens, stats

    t0 = time.monotonic()
    # -- (a) + (b): smollm-135m at full width
    ops.reset_kernel_launch_counts()
    rows = {}
    for dtype in ("float32", "bfloat16"):
        t_run = time.monotonic()
        tokens, stats = served("smollm-135m", False, dtype)
        model, params, prompts, frames, sc = serve.setup(
            "smollm-135m", reduced=False, dtype=dtype, device=dev)
        warm = generate(model, params, prompts, sc, frames=frames)
        require(bool((warm.cpu().numpy() == tokens).all()),
                f"serve {dtype}: a second generate gave other tokens")
        stats["profile_generate"] = light_busy_share(
            torch, lambda: generate(model, params, prompts, sc,
                                    frames=frames))
        require(tokens.shape == (4, 24) and tokens.min() >= 0
                and tokens.max() < model.cfg.vocab_size,
                f"serve {dtype}: tokens {tokens.shape} out of range")
        if dtype == "float32":
            t_hold = time.monotonic()
            stats["held_to_cpu"] = hold_to_cpu(torch, model, params, prompts,
                                               frames, tokens)
            stats["held_to_cpu"]["seconds"] = time.monotonic() - t_hold
        else:
            logits = teacher_forced_logits(
                model, params, prompts,
                torch.as_tensor(tokens, device=dev), frames=frames)
            require(bool(torch.isfinite(logits).all()),
                    "serve bfloat16: non-finite logits")
        stats["wall_s"] = time.monotonic() - t_run
        rows[dtype] = stats
        del model, params, warm
    serve_launches = ops.kernel_launch_counts()
    no_launches(serve_launches, "(a)")
    emit({"phase": "serve", "arch": "smollm-135m", "config": "CONFIG",
          "seconds": time.monotonic() - t0,
          "batch": 4, "prompt_len": 16, "new_tokens": 24, "greedy": True,
          "runs": rows, "launches": serve_launches})

    # -- (c): every arch at REDUCED, held to the CPU
    ops.reset_kernel_launch_counts()
    reduced = {}
    for arch in ARCH_IDS:
        t_arch = time.monotonic()
        tokens, stats = served(arch, True, "float32")
        model, params, prompts, frames, _ = serve.setup(arch, device=dev)
        stats["held_to_cpu"] = hold_to_cpu(torch, model, params, prompts,
                                           frames, tokens)
        stats["wall_s"] = time.monotonic() - t_arch
        reduced[arch] = stats
    no_launches(ops.kernel_launch_counts(), "(c)")
    emit({"phase": "serve", "config": "REDUCED", "archs": reduced,
          "seconds": time.monotonic() - t0})

    # -- (d): four more archs at CONFIG, timed as serve_once times them but
    # on one init, whose weights then give the served tokens' logits
    ops.reset_kernel_launch_counts()
    config = {}
    for arch, dtype in SERVE_CONFIG_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.monotonic()
        model, params, prompts, frames, sc = serve.setup(
            arch, reduced=False, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        stats = {"dtype": dtype, "init_s": time.monotonic() - t_arch,
                 "params_b": sum(t.numel() for t in tree_leaves(params))
                 / 1e9}
        for run in ("cold", "warm"):
            t1 = time.perf_counter()
            tokens = generate(model, params, prompts, sc, frames=frames)
            torch.cuda.synchronize()
            stats[f"{run}_s"] = time.perf_counter() - t1
        stats["tok_s_warm"] = tokens.numel() / stats["warm_s"]
        stats["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        logits = teacher_forced_logits(model, params, prompts, tokens,
                                       frames=frames)
        require(bool(torch.isfinite(logits).all()),
                f"serve {arch}: non-finite logits")
        require(int(tokens.min()) >= 0
                and int(tokens.max()) < model.cfg.vocab_size,
                f"serve {arch}: tokens out of range")
        stats["wall_s"] = time.monotonic() - t_arch
        config[arch] = stats
        del model, params, logits
    emit({"phase": "serve", "config": "CONFIG", "archs": config,
          "seconds": time.monotonic() - t0})
    return serve_launches


# Phase train: smollm-135m at full width and SmolLM's 2048-token context;
# a step on the card held to the same step on the CPU within these
TRAIN_ARCH = "smollm-135m"
TRAIN_FLAGS = dict(batch=16, seq=2048, microbatches=8, steps=6, lr=3e-4)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
# stepped weights within this times lr: Adam's first step moves a weight by
# about lr * g / (|g| + eps), so a gradient at rounding level can move it
# by a fraction of lr either way
TRAIN_PARAM_ATOL_LR = 0.25


def recorded_steps(torch, launch_train):
    """Wrap ``launch_train.make_train_step`` so that every step of
    ``train_loop`` is timed between two ``torch.cuda.synchronize()`` and its
    metrics kept: -> (records, undo)."""
    records = []
    real = launch_train.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            records.append({"seconds": time.perf_counter() - t0,
                            **{k: float(v) for k, v in metrics.items()}})
            return state, metrics
        return timed

    launch_train.make_train_step = make
    return records, lambda: setattr(launch_train, "make_train_step", real)


def step_card_vs_cpu(torch, dev, cfg, batch, seq, microbatches) -> dict:
    """One train step on the card and on the CPU from the same weights (a
    generator seeded 0 on the card) and the same batch (the stream's step
    0): loss within TRAIN_LOSS_RTOL, grad norm within TRAIN_GNORM_RTOL
    (relative), each stepped weight within TRAIN_PARAM_ATOL_LR * lr."""
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch.train import batch_at
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.device import make_generator
    from repro_torch.train import (OptimizerConfig, TrainState,
                                   init_opt_state, make_train_step)
    oc = OptimizerConfig(learning_rate=1e-3, total_steps=10, warmup_steps=2,
                         schedule=cfg.schedule)
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch))
    params, _ = build(cfg, dev).init(make_generator(0, dev))
    out = []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        state = TrainState(p, init_opt_state(p),
                           torch.Generator().manual_seed(0).get_state())
        t0 = time.perf_counter()
        new, metrics = make_train_step(build(cfg, d), oc, microbatches)(
            state, batch_at(cfg, stream, 0, batch, d))
        out.append((new, {k: float(v) for k, v in metrics.items()},
                    time.perf_counter() - t0))
    (card, mc, card_s), (cpu, mh, cpu_s) = out
    lr = mh["lr"]
    diff = max(float((a.cpu().float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(card.params),
                               tree_leaves(cpu.params)))
    row = {"batch": batch, "seq": seq, "microbatches": microbatches,
           "loss_card": mc["loss"], "loss_cpu": mh["loss"],
           "loss_rel_err": abs(mc["loss"] - mh["loss"]) / abs(mh["loss"]),
           "grad_norm_card": mc["grad_norm"], "grad_norm_cpu": mh["grad_norm"],
           "grad_norm_rel_err": abs(mc["grad_norm"] - mh["grad_norm"])
           / mh["grad_norm"],
           "param_max_abs_diff": diff, "lr": lr,
           "param_diff_over_lr": diff / lr, "card_s": card_s, "cpu_s": cpu_s}
    require(row["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and row["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL
            and diff <= TRAIN_PARAM_ATOL_LR * lr
            and all(map(lambda v: v == v, (mc["loss"], mc["grad_norm"]))),
            f"train {cfg.name}: the card's step against the CPU's {row}")
    return row


def train_phase(torch, dev) -> dict:
    """Phase ``train``: LM training through the entry point a user calls,
    ``launch.train.train_loop`` (``make_train_step`` → ``Model.loss``:
    the stack under the config's remat policy, ``_sdpa`` attention as the
    reference trains, the chunked cross-entropy; f32 gradient sums over the
    microbatches; AdamW), smollm-135m at CONFIG (30 layers, d 576, 9/3
    heads, vocab 49152). (a) f32 (the launcher's default), global batch 16
    x 2048 tokens in 8 microbatches, 6 steps: each step's loss, grad norm,
    lr and seconds; the warm steps' tokens/s, model FLOP/s (6 N tokens plus
    the attention's 12 L B S^2 H hd), peak memory, and the idle share over
    one more step (``light_busy_share``); it checkpoints every 3 steps.
    (b) the run stopped after its step-3 checkpoint (a job killed between
    steps 3 and 6 leaves (a)'s directory without step 6) and resumed into
    the same directory: steps 4-6 bitwise equal to (a)'s ((a) and (b) run
    under ``torch.use_deterministic_algorithms``; main() sets
    CUBLAS_WORKSPACE_CONFIG before the first cuBLAS call). (c) one step at
    batch 2 x 128 on the card and on the CPU from the same weights
    (``step_card_vs_cpu``). (d) every arch at REDUCED, one step each, the
    same way. (e) two steps in bf16 (the config's dtype) at (a)'s shape,
    finite losses. The launch counts read around (a)-(e) are the "train"
    path of the kernels line: every kernel must read 0."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.common import tree_leaves

    t0 = time.monotonic()
    f = TRAIN_FLAGS
    cfg = get_config(TRAIN_ARCH)
    tokens = f["batch"] * f["seq"]
    n_active = cfg.param_counts()[1]
    attn_flops = 12 * cfg.n_layers * f["batch"] * f["seq"] ** 2 \
        * cfg.n_heads * cfg.resolved_head_dim
    model_flops = 6 * n_active * tokens + attn_flops

    def quiet(*_):
        pass

    ops.reset_kernel_launch_counts()
    # -- (a) + (b), deterministic so that (b) must equal (a) bit for bit
    torch.use_deterministic_algorithms(True)
    ck = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        records, undo = recorded_steps(torch, launch_train)
        lines = []
        kw = dict(reduced=False, steps=f["steps"], batch=f["batch"],
                  seq=f["seq"], lr=f["lr"], microbatches=f["microbatches"],
                  ckpt_dir=ck, ckpt_every=3, log_every=1, dtype="float32",
                  device=dev)
        t_a = time.monotonic()
        try:
            state, losses = launch_train.train_loop(
                TRAIN_ARCH, printer=lines.append, **kw)
        finally:
            undo()
        wall_a = time.monotonic() - t_a
        peak = torch.cuda.max_memory_allocated()
        require(len(losses) == f["steps"]
                and all(np.isfinite(losses))
                and losses[0] < np.log(cfg.vocab_size) + 0.5
                and losses[-1] < losses[0],
                f"train (a): losses {losses}")
        warm = [r["seconds"] for r in records[1:]]
        step_s = statistics.median(warm)
        # one more step under the profiler: the card's idle share
        from repro_torch.data import DataConfig, TokenStream
        from repro_torch.models import build
        from repro_torch.train import OptimizerConfig, make_train_step
        model = build(dc.replace(cfg, dtype="float32"), dev)
        oc = OptimizerConfig(learning_rate=f["lr"], total_steps=f["steps"],
                             warmup_steps=5, schedule=cfg.schedule)
        step = make_train_step(model, oc, f["microbatches"])
        batch = launch_train.batch_at(
            cfg, TokenStream(DataConfig(cfg.vocab_size, f["seq"],
                                        f["batch"])), f["steps"],
            f["batch"], dev)
        busy = light_busy_share(torch, lambda: step(state, batch))
        emit({"phase": "train", "leg": "a", "arch": TRAIN_ARCH,
              "config": "CONFIG", "dtype": "float32", **f,
              "ckpt_every": 3, "tokens_per_step": tokens,
              "deterministic": True,
              "tf32": False, "steps_run": records, "log": lines,
              "wall_s": wall_a, "warm_step_s": step_s,
              "warm_step_s_min_max": [min(warm), max(warm)],
              "tokens_per_s": tokens / step_s,
              "params_active": n_active, "model_flops_per_step": model_flops,
              "model_tflops_per_s": model_flops / step_s / 1e12,
              "share_of_f32_peak": model_flops / step_s / F32_OPS_PER_S,
              "peak_memory_gb": (peak - base) / 1e9,
              "memory_before_gb": base / 1e9,
              "profile_step": busy,
              # the profiler's host overhead stretches its window: the
              # card's busy time over an unprofiled warm step as well
              "busy_share_of_warm_step": busy["device_busy_ms"] / 1e3
              / step_s})
        del batch, step

        # -- (b) stopped after its step-3 checkpoint, resumed: a job killed
        # between its steps 3 and 6 leaves (a)'s directory without step 6
        t_b = time.monotonic()
        ckpts = sorted(p.name for p in Path(ck).iterdir())
        require(ckpts == ["step_00000003", "step_00000006"],
                f"train (a): checkpoints {ckpts}")
        shutil.rmtree(Path(ck) / "step_00000006")
        resumed_lines = []
        resumed, tail = launch_train.train_loop(
            TRAIN_ARCH, printer=resumed_lines.append, **kw)
        resume_s = time.monotonic() - t_b
        same = tail == losses[3:] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                              tree_leaves(state.params)))
        require(resumed_lines[0].startswith("[train] resumed from step 3")
                and same, f"train (b): resumed {tail} against {losses[3:]}")
        emit({"phase": "train", "leg": "b", "stopped_after_step": 3,
              "ckpt_every": 3, "resumed_losses": tail,
              "bitwise_equal_to_a": True, "checkpoints_of_a": ckpts,
              "resume_run_s": resume_s, "wall_s": time.monotonic() - t_b})
        del resumed, state
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)

    # -- (c) smollm-135m at CONFIG, the card against the CPU
    t_c = time.monotonic()
    row_c = step_card_vs_cpu(torch, dev, dc.replace(cfg, dtype="float32"),
                             2, 128, 1)
    emit({"phase": "train", "leg": "c", "arch": TRAIN_ARCH,
          "config": "CONFIG", **row_c,
          "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                        "grad_norm_rtol": TRAIN_GNORM_RTOL,
                        "param_atol_over_lr": TRAIN_PARAM_ATOL_LR},
          "seconds": time.monotonic() - t_c})

    # -- (d) every arch at REDUCED, the card against the CPU
    t_d = time.monotonic()
    reduced = {arch: step_card_vs_cpu(
        torch, dev, dc.replace(get_config(arch, reduced=True),
                               dtype="float32"), 4, 16, 2)
        for arch in ARCH_IDS}
    emit({"phase": "train", "leg": "d", "config": "REDUCED",
          "archs": reduced, "seconds": time.monotonic() - t_d})

    # -- (e) bf16, the config's dtype, at (a)'s shape
    t_e = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    records, undo = recorded_steps(torch, launch_train)
    try:
        _, bf_losses = launch_train.train_loop(
            TRAIN_ARCH, reduced=False, steps=2, batch=f["batch"],
            seq=f["seq"], lr=f["lr"], microbatches=f["microbatches"],
            dtype="bfloat16", printer=quiet, device=dev)
    finally:
        undo()
    require(all(np.isfinite(bf_losses)), f"train (e): losses {bf_losses}")
    train_launches = ops.kernel_launch_counts()
    require(not any(train_launches.values()),
            f"train: a kernel of the port was launched {train_launches}")
    emit({"phase": "train", "leg": "e", "dtype": "bfloat16", "steps": 2,
          "losses": bf_losses, "steps_run": records,
          "tokens_per_s_second_step": tokens / records[-1]["seconds"],
          "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
          "seconds": time.monotonic() - t_e})
    emit({"phase": "train", "seconds": time.monotonic() - t0,
          "launches": train_launches})
    return train_launches


# Phase bandit: run_bandit at smollm-135m CONFIG with the reference's
# defaults and the surrogate every 8 requests
BANDIT_FLAGS = dict(arch="smollm-135m", reduced=False, requests=24, batch=2,
                    prompt_len=8, new_tokens=12, policy="ucb",
                    surrogate_every=8)
# the lat_weight 0 pair (inline, through failures): depth cut to 8 requests,
# one surrogate sync
BANDIT_LAT0_REQUESTS = 8


def bandit_phase(torch, dev) -> dict:
    """Phase ``bandit``: bandit-routed serving through
    ``launch.bandit_serve.run_bandit`` (``BanditRouter`` over three arms of
    one smollm-135m at CONFIG: f32 greedy, f32 temperature 0.8, greedy on
    int8-round-tripped weights; ``_sdpa`` attention, as the reference's
    arms) with ``sync_surrogate`` every 8 requests (the port's
    ``SurrogateExplorer`` on the card: tell, ask, which spawns an arm, and
    predict, which culls one). Run inline at the default lat_weight 1, its
    launch counts the "bandit" path of the kernels line (``gp_sqdist`` once
    a GP fit, counted by wrapping ``surrogate.gp_fit``; every other kernel
    0); req/s, oracle arm, regret. Then lat_weight 0 inline and through
    ``--fault-rate 0.35`` (the journaled service on a pool failing 35 % of
    attempts), each cut to BANDIT_LAT0_REQUESTS requests: the two journals
    equal apart from ``latency_s``, the routing equal, some attempt
    failed. Last, B4 at
    the shapes of the GP fits (the told genomes, d 2) bitwise against its
    plain version, with its time."""
    from repro_torch.explore import surrogate
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import bandit_serve

    t0 = time.monotonic()
    fits = []
    real_fit = surrogate.gp_fit

    def counted_fit(cfg, x, y):
        fits.append(x.detach().clone())
        return real_fit(cfg, x, y)

    def journal(path):
        recs = [json.loads(line) for line in open(path)]
        for r in recs:
            r.pop("latency_s", None)
        return recs

    runs = {}
    with tempfile.TemporaryDirectory() as out:
        surrogate.gp_fit = counted_fit
        try:
            ops.reset_kernel_launch_counts()
            lines = []
            t_run = time.monotonic()
            res = bandit_serve.run_bandit(
                **BANDIT_FLAGS, out_dir=f"{out}/inline",
                printer=lines.append, device=dev)
            bandit_launches = ops.kernel_launch_counts()
            runs["inline"] = dict(res, log=lines,
                                  wall_with_warmup_s=time.monotonic() - t_run,
                                  gp_fits=len(fits))
        finally:
            surrogate.gp_fit = real_fit
        others = {k: v for k, v in bandit_launches.items()
                  if k != "gp_sqdist" and v}
        require(len(fits) > 0 and bandit_launches["gp_sqdist"] == len(fits)
                and not others,
                f"bandit: {len(fits)} GP fits, launches {bandit_launches}")
        for name, extra in (("lat0_inline", {}),
                            ("lat0_chaos", {"fault_rate": 0.35})):
            t_run = time.monotonic()
            runs[name] = dict(bandit_serve.run_bandit(
                **dict(BANDIT_FLAGS, requests=BANDIT_LAT0_REQUESTS),
                lat_weight=0.0, out_dir=f"{out}/{name}",
                journal=f"{out}/{name}.jsonl", printer=lambda *_: None,
                device=dev, **extra),
                wall_with_warmup_s=time.monotonic() - t_run)
        same = journal(f"{out}/lat0_inline.jsonl") \
            == journal(f"{out}/lat0_chaos.jsonl")
        chaos = runs["lat0_chaos"]
        require(same and chaos["arms"] == runs["lat0_inline"]["arms"]
                and chaos["pool_stats"]["failed_attempts"] > 0,
                f"bandit: the chaos run's journal or routing differs from "
                f"the inline run's ({chaos.get('pool_stats')})")
    # B4 at the GP fits' shapes
    b4 = []
    for x in fits:
        got = ops.gp_sqdist(x, x)
        plain = ref.gp_sqdist_ref(x, x)
        torch.cuda.synchronize()
        require(torch.equal(got, plain),
                f"gp_sqdist bitwise at the bandit's fit {tuple(x.shape)}")
        n, d = x.shape
        # the bound of phase kernels' gp_sqdist rows
        b_ms, b_by = bound_ms(2 * n * d * 4 + n * n * 4,
                              n * n * (2 * d + 2) + 2 * n * d * 2)
        # CUDA events in turns, queued behind a spinning card: the
        # profiler returned no kernel record for these ~1 us launches
        kt, pt = turns_ms(torch, lambda: ops.gp_sqdist(x, x),
                          lambda: ref.gp_sqdist_ref(x, x), inner=10,
                          hold_cycles=HOLD_CYCLES)
        b4.append({"shape": [n, n, d], "bitwise": True, "max_abs_err": 0.0,
                   "timed_by": "cuda_events_in_turns_queued",
                   "ms": kt["median"], "ms_min_max": [kt["min"], kt["max"]],
                   "plain_ms": pt["median"], "bound_ms": b_ms,
                   "bound_by": b_by})
    summary = {k: {"requests_per_s": r["requests_per_s"],
                   "wall_s": r["wall_s"],
                   "wall_with_warmup_s": r["wall_with_warmup_s"],
                   "oracle_arm": r["oracle_arm"], "regret": r["regret"],
                   "arms": {a: {"pulls": s["pulls"],
                                "mean_reward": s["mean_reward"],
                                "active": s["active"]}
                            for a, s in r["arms"].items()},
                   "pool_stats": r.get("pool_stats")}
               for k, r in runs.items()}
    emit({"phase": "bandit", **{k: v for k, v in BANDIT_FLAGS.items()},
          "runs": summary, "log": runs["inline"]["log"],
          "gp_fits": len(fits), "launches": bandit_launches,
          "lat0_journals_equal": True, "gp_sqdist_at_fits": b4,
          "seconds": time.monotonic() - t0})
    return bandit_launches


def custom_op_overhead(torch, dev, gen, calls: int = 200,
                       turns: int = 11) -> dict:
    """The host time a call of B1 and B2 through its ``torch.library``
    custom op (``kernels.library``) takes beside a direct call of its
    launcher, at calibrate's shapes: B1 at (640, 72, 72), B2 at 256 rows in
    8 groups. Each sample enqueues ``calls`` calls on the host clock after
    a synchronize (the card keeps pace: a launch is queued, not waited
    for); samples in turns, launcher, op, op, launcher, ``turns`` times;
    medians in microseconds a call. The op's outputs equal the launcher's.
    These launches compare; they are in no path's counts."""
    from repro_torch.kernels import diffusion, dominance, library

    chem = torch.rand((640, 72, 72), generator=gen, device=dev) * 100.0
    rate = torch.rand((640,), generator=gen, device=dev)
    evap = torch.rand((640,), generator=gen, device=dev) * 0.5
    rows = torch.randint(0, 1001, (256, 3), generator=gen,
                         device=dev).to(torch.float32)
    groups = torch.arange(8, device=dev, dtype=torch.int32) \
        .repeat_interleave(32)
    pairs = {
        "diffuse_evaporate": (
            lambda: diffusion.diffuse_evaporate(chem, rate, evap),
            lambda: library.diffuse_evaporate(chem, rate, evap)),
        "dominance_pass": (
            lambda: dominance.dominance_pass(rows, None, groups, None),
            lambda: library.dominance_pass(rows, None, groups, None)),
    }
    require(torch.equal(pairs["diffuse_evaporate"][0](),
                        pairs["diffuse_evaporate"][1]()),
            "diffuse_evaporate: the custom op differs from its launcher")
    require(all(torch.equal(a, b) for a, b in zip(
        pairs["dominance_pass"][0](), pairs["dominance_pass"][1]())),
        "dominance_pass: the custom op differs from its launcher")

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        took = time.perf_counter() - t0
        torch.cuda.synchronize()
        return took / calls * 1e6

    out = {}
    for name, (direct, op) in pairs.items():
        host_us(direct), host_us(op)                   # warm-up
        d_us, o_us = [], []
        for _ in range(turns):
            d_us.append(host_us(direct))
            o_us += [host_us(op), host_us(op)]
            d_us.append(host_us(direct))
        out[name] = {"launcher_host_us": statistics.median(d_us),
                     "op_host_us": statistics.median(o_us),
                     "added_host_us": statistics.median(o_us)
                     - statistics.median(d_us),
                     "launcher_min_max_us": [min(d_us), max(d_us)],
                     "op_min_max_us": [min(o_us), max(o_us)],
                     "op_equals_launcher": True}
    out["shapes"] = {"diffuse_evaporate": [640, 72, 72],
                     "dominance_pass": [256, 3, "8 groups"]}
    out["calls_a_sample"], out["samples"] = calls, 2 * turns
    return out


# phase package: the ants run at CONFIG's world and ants, 640 lanes (a
# calibrate call's), cut to PACKAGE_TICKS ticks by export time: on the
# card's host torch.export's first call spends ~12 s in imports, then
# unrolls the tick loop at ~0.3 s a tick (~90 graph nodes) and loads it at
# ~0.16 s a tick (PERF.md); at 30 ticks the chemical field is
# already non-zero. One B2 sweep of 2048 rows (a streaming top-k block)
PACKAGE_TICKS = 30
PACKAGE_LANES = 640
PACKAGE_ROWS = 2048


def package_phase(torch, dev, before_load=lambda: None) -> dict:
    """Phase ``package``: two tasks packaged with ``core.packaging.package``
    on the card (``torch.export`` at CUDA example tensors), saved, loaded
    back with ``packaging.load`` (no task code) and run on the card: (a)
    the ants model in its apply form, a run of PACKAGE_LANES lanes at
    CONFIG's 72 x 72 world and 125 ants from given Gumbel noise, returning
    the objectives and the final chemical field; (b) one
    ``kernels.ops.dominance_pass`` over (PACKAGE_ROWS, 3) seeded objectives
    with ties. Both are exported first, then ``before_load()`` runs (the
    child waits there for the parent's build). Each rehydrated run is
    bitwise equal to the direct run and launches its kernel through the
    custom op (B1 once a tick, B2 once), nothing else; the manifest names
    the device and the op. Returns the launches of the two rehydrated runs
    (the "package" path of the kernels line)."""
    from repro_torch.ants import model, simulate_state
    from repro_torch.configs.ants_netlogo import CONFIG
    from repro_torch.core import packaging
    from repro_torch.kernels import ops

    t_phase = time.monotonic()
    cfg = dataclasses.replace(CONFIG, max_ticks=PACKAGE_TICKS)

    def ants_apply(diffusion, evaporation, noise):
        state = simulate_state(cfg, diffusion, evaporation, noise=noise)
        return state.ticks_empty.to(torch.float32), state.chem

    def dominance(objectives):
        return ops.dominance_pass(objectives)

    gen = torch.Generator(device=dev).manual_seed(26)
    n = PACKAGE_LANES
    ants_args = (torch.rand((n,), generator=gen, device=dev) * 99,
                 torch.rand((n,), generator=gen, device=dev) * 99,
                 model.draw_gumbel(gen, (PACKAGE_TICKS, n, cfg.population,
                                         8), dev))
    dom_args = (torch.randint(0, 1001, (PACKAGE_ROWS, 3), generator=gen,
                              device=dev).to(torch.float32),)
    tasks = (("ants", ants_apply, ants_args, "diffuse_evaporate",
              PACKAGE_TICKS),
             ("dominance", dominance, dom_args, "dominance_pass", 1))
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        export_s = {}
        for name, fn, args, _, _ in tasks:
            t0 = time.perf_counter()
            packaging.package(fn, args, str(Path(tmp) / name), name=name)
            export_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        before_load()
        waited_s = time.perf_counter() - t0
        for name, fn, args, kernel, expect in tasks:
            path = str(Path(tmp) / name)
            t0 = time.perf_counter()
            run = packaging.load(path)
            load_s = time.perf_counter() - t0
            ops.reset_kernel_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run(*args)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = ops.kernel_launch_counts()
            t0 = time.perf_counter()
            want = fn(*args)
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t0
            require(len(got) == len(want) and all(
                g.device.type == "cuda" and torch.equal(g, w)
                for g, w in zip(got, want)),
                f"package {name}: the rehydrated run differs from the "
                f"direct run")
            require(launches[kernel] == expect and sum(launches.values())
                    == expect, f"package {name}: launches {launches}")
            m = packaging.manifest(path)
            require(m["device"] == "cuda"
                    and m["custom_ops"] == [f"repro_torch::{kernel}"],
                    f"package {name}: manifest {m}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            emit({"phase": "package", "task": name, "manifest": m,
                  "export_s": export_s[name], "load_s": load_s,
                  "run_s": run_s, "direct_s": direct_s, "bitwise": True,
                  "launches": {kernel: launches[kernel]},
                  **({"ticks": PACKAGE_TICKS, "lanes": n,
                      "chem_max": float(want[1].max())}
                     if name == "ants" else {})})
    emit({"phase": "package", "waited_for_build_s": waited_s})
    emit({"phase": "package", "seconds": time.monotonic() - t_phase})
    return total


PACKAGE_TIMEOUT_S = 300


def package_rank(argv) -> int:
    """Phase ``package`` in a process of its own, as ``chip_smoke.py
    --package OUT READY``: exports the two tasks (fake tensors: no kernel
    needed), waits for the file READY (the parent's build done), then loads
    and runs them (``package_phase``), prints its lines, writes its
    launches to OUT, and prints nothing of the contract."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    ready = Path(argv[1])

    def wait_for_build():
        deadline = time.monotonic() + PACKAGE_TIMEOUT_S
        while not ready.exists():
            require(time.monotonic() < deadline,
                    "phase package: the parent's build did not finish")
            time.sleep(0.1)

    launches = package_phase(torch, torch.device("cuda"),
                             before_load=wait_for_build)
    Path(argv[0]).write_text(json.dumps(launches))
    return 0


class PackageChild:
    """Phase ``package`` (``package_rank``) in a child process started
    before the build, so that its exports (~25 s, CPU only) overlap the
    nvcc builds; ``finish`` tells it the kernels are built, waits for it
    and passes its lines on. In a fresh process torch.export took ~0.25 s
    a tick; inside this script's long process 1.1-2.2 s (PERF.md)."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        d = Path(self.tmp.name)
        self.out, self.ready = d / "launches.json", d / "built"
        self.log, self.err = open(d / "out.log", "w"), open(d / "err.log",
                                                             "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--package",
             str(self.out), str(self.ready)], stdout=self.log,
            stderr=self.err, cwd=ROOT)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        self.err.close()
        self.tmp.cleanup()

    def finish(self) -> dict:
        """The child's launches (the "package" path of the kernels
        line)."""
        try:
            self.ready.touch()
            rc = self.proc.wait(timeout=PACKAGE_TIMEOUT_S)
            d = Path(self.tmp.name)
            sys.stdout.write((d / "out.log").read_text())
            sys.stdout.flush()
            if rc != 0:
                print((d / "err.log").read_text()[-4000:], file=sys.stderr)
            require(rc == 0, f"phase package's process exited {rc}")
            return json.loads(self.out.read_text())
        finally:
            self.kill()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # before the first cuBLAS call: phase train runs (a) and (b) under
    # torch.use_deterministic_algorithms, which needs a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.nn.functional as F

    import numpy as np

    from repro_torch.ants import model
    from repro_torch.configs.ants_netlogo import CONFIG, REDUCED
    from repro_torch.evolution import nsga2
    from repro_torch.explore import surrogate
    from repro_torch.kernels import (build, cholesky, diffusion, dominance,
                                     gp, ops, ref)
    from repro_torch.launch import explore

    t_start = time.monotonic()

    def stamp():
        """A line with the seconds since the start: where the script's time
        limit goes."""
        emit({"elapsed_s": time.monotonic() - t_start})

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. build, with phase 2's exports in a child process beside it -----
    package = PackageChild()
    t0 = time.monotonic()
    try:
        secs = build.build()
        emit({"phase": "build", "seconds": time.monotonic() - t0,
              "per_source_s": secs,
              "ptxas": {name: [line.strip() for line in
                               build.build_log(name).splitlines()
                               if "registers" in line]
                        for name in build.SOURCES}})
        emit({"phase": "build", "flash_kernels": flash_build_report(build)})
        emit({"phase": "build",
              "cholesky_kernels": chol_build_report(build)})
        emit({"phase": "build",
              "stencil_solve_kernels": stencil_solve_build_report(build)})
        emit({"phase": "build",
              "dominance_kernels": dominance_build_report(build)})
        gp_kernels = gp_build_report(build)
        emit({"phase": "build", "gp_kernels": gp_kernels})
    except BaseException:
        package.kill()
        raise

    # -- 2. packaged tasks rehydrated on the card: B1 and B2 as operators
    package_launches = package.finish()

    stamp()

    # -- 3. kernels against their plain versions ----------------------------
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

    sms = build.sm_count(torch.cuda.current_device())
    results = {}
    # 320 lanes: a mesh rank's block of the calibrate run (phase mesh)
    for n in (320, 640, 20480):
        chem, rate, evap = field(n)
        got = diffusion.diffuse_evaporate(chem, rate, evap)
        plain = ref.diffuse_evaporate_ref(chem, rate, evap)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        lib_err = (library_diffusion(chem, rate, evap) - plain).abs().max()
        require(torch.equal(got, plain), f"diffuse_evaporate bitwise at "
                f"({n},72,72), max abs err {err}")
        n_bytes = 2 * chem.numel() * 4 + 2 * n * 4
        b_ms, b_by = bound_ms(n_bytes, chem.numel() * DIFFUSION_OPS_PER_PATCH)
        run = lambda: diffusion.diffuse_evaporate(  # noqa: E731
            chem, rate, evap)
        kt, lt = turns_ms(
            torch, run, lambda: library_diffusion(chem, rate, evap),
            inner=10, library_inner=3, hold_cycles=HOLD_CYCLES)
        r = {"kernel": "diffuse_evaporate", "shape": [n, 72, 72],
             "bitwise": True, "max_abs_err": err,
             "route": diffusion.route(chem),
             "launch": dataclasses.asdict(diffusion.launch_config(n, 72, sms)),
             "timed_by": "cuda_events_in_turns_queued",
             "ms": kt["median"], "ms_min_max": [kt["min"], kt["max"]],
             "samples": kt["n"], "library_ms": lt["median"],
             "library_min_max": [lt["min"], lt["max"]],
             "ratio_to_library": kt["median"] / lt["median"],
             "gb_per_s": n_bytes / kt["median"] / 1e6,
             "bound_share": b_ms / kt["median"],
             "profiler_ms": device_ms(torch, run),
             "call_ms": call_ms(torch, run),
             "plain_ms": device_ms(torch, lambda: ref.diffuse_evaporate_ref(
                 chem, rate, evap)),
             "library_max_abs_err": lib_err.item(),
             "bound_ms": b_ms, "bound_by": b_by}
        results[("diffuse_evaporate", n)] = r
        emit({"phase": "kernels", **r})
    # the cp.async route: a world of odd width, and the paper's world in a
    # field that does not start on a 16-byte boundary
    for n, w, offset in ((640, 33, 0), (640, 72, 1)):
        base = torch.rand((n * w * w + offset,), generator=gen,
                          device=dev) * 100.0
        chem = base[offset:].view(n, w, w)
        rate, evap = field(n, w)[1:]
        got = diffusion.diffuse_evaporate(chem, rate, evap)
        require(torch.equal(got, ref.diffuse_evaporate_ref(chem, rate, evap))
                and diffusion.route(chem) == "cp_async",
                f"diffuse_evaporate bitwise on the cp.async route at "
                f"({n},{w},{w}) offset {offset}")
        emit({"phase": "kernels", "kernel": "diffuse_evaporate",
              "shape": [n, w, w], "offset_floats": offset,
              "route": "cp_async", "bitwise": True,
              "profiler_ms": device_ms(torch, lambda: diffusion
                                       .diffuse_evaporate(chem, rate, evap))})

    def objectives(n):
        # first-empty ticks: integers in [0, 1000], many ties
        return torch.randint(0, 1001, (n, 3), generator=gen,
                             device=dev).to(torch.float32)

    # the issue floor of the sweep: B2's inner loop from registers and
    # shared memory alone, and the same pairs as float compares
    probe = {"subtract": dominance.issue_probe(True),
             "compare": dominance.issue_probe(False)}
    emit({"phase": "kernels", "probe": "dominance_issue", **probe})
    pair_rate = probe["subtract"]["pairs_per_s"]

    def dominance_timing(run, plain, n, pairs, n_bytes):
        """B2/B3 beside their bounds: queued CUDA-event samples (no library
        call to take turns with), the profiler's kernel time, the
        host-paced call time and the plain version's."""
        b_ms, b_by = bound_ms(n_bytes, pairs * 2 * 3)
        kt, _ = turns_ms(torch, run, None, inner=10, hold_cycles=HOLD_CYCLES)
        return {"equal": True, "max_abs_err": 0.0,
                "probe_sm_clock_ghz": probe["subtract"]["sm_clock_ghz"],
                "launch": dataclasses.asdict(
                    dominance.launch_config(n, n, 3, sms)),
                "timed_by": "cuda_events_queued", "ms": kt["median"],
                "ms_min_max": [kt["min"], kt["max"]], "samples": kt["n"],
                "profiler_ms": device_ms(torch, run),
                "call_ms": call_ms(torch, run),
                "plain_ms": device_ms(torch, plain, reps=5),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / kt["median"], "pairs": pairs,
                "issue_floor_ms": pairs / pair_rate * 1e3}

    # (rows, grouped, rows set to +BIG, those rows first): the GA pool ranks
    # 8 islands x 32 grouped; pareto_front ranks the 256-row archive with
    # its empty rows at +BIG; the first merge ranks the 256 empty archive
    # rows ahead of 64 new ones; 2048 and 8192 rows are the streaming
    # init's blocks and the section 4.5 sorting benchmark
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
        # block (0, 0)'s SM clocks at each phase, the latest warp's
        phases = dominance.pass_phase_cycles(rows, groups)
        r = {"kernel": "dominance_pass", "shape": [n, 3], "grouped": grouped,
             "big_rows": n_big,
             "phase_cycles": {k: max(phases[k]) for k in dominance.PHASES},
             "pass0_computed_by_warp": phases["pass0_computed"],
             "blocks": phases["blocks"],
             **dominance_timing(
                 lambda: dominance.dominance_pass(rows, groups=groups),
                 lambda: ref.dominance_pass_ref(rows, groups=groups), n,
                 (n // 8) ** 2 * 8 if grouped else n * n,
                 2 * n * 3 * 4 + (2 * n * 4 if grouped else 0) + n * 4
                 + n * words * 4)}
        results[("dominance_pass", n, grouped, n_big)] = r
        emit({"phase": "kernels", **r})

    for n in (2048, 8192):
        rows = objectives(n)
        got = dominance.dominated_counts(rows)
        require(torch.equal(got, ref.dominated_counts_ref(rows)),
                f"dominated_counts equal at n={n}")
        r = {"kernel": "dominated_counts", "shape": [n, 3],
             **dominance_timing(
                 lambda: dominance.dominated_counts(rows),
                 lambda: ref.dominated_counts_ref(rows), n, n * n,
                 n * 3 * 4 + n * 4)}
        results[("dominated_counts", n)] = r
        emit({"phase": "kernels", **r})

    # the section 4.5 sorting benchmark's input (benchmarks/run.py
    # bench_nsga2_dominance): 8192 x 3 uniform objectives; the fused
    # ranking (one B2 sweep, then popcount peeling) against the peeling
    # baseline (one B3 sweep a front); launch counts read around one of each
    f = torch.rand((8192, 3), generator=torch.Generator(dev).manual_seed(0),
                   device=dev)
    ops.reset_kernel_launch_counts()
    fused = nsga2.nondominated_ranks(f)
    peel = nsga2.nondominated_ranks_peel(f)
    torch.cuda.synchronize()
    rank_launches = ops.kernel_launch_counts()
    fronts = int(fused.max().item()) + 1
    require(torch.equal(fused, peel), "section 4.5 ranking: fused and "
            "peeling ranks differ")
    require(rank_launches["dominance_pass"] == 1
            and rank_launches["dominated_counts"] == fronts,
            f"section 4.5 ranking launches {rank_launches}")
    ranking = {}
    for name, fn in (("fused", lambda: nsga2.nondominated_ranks(f)),
                     ("peel", lambda: nsga2.nondominated_ranks_peel(f))):
        ms = call_ms(torch, fn, reps=5, inner=1, warmup=1)
        wall, _, by_kernel, intervals = profiled(torch, fn)
        busy = busy_union_ms(intervals)
        kernel = by_kernel.get("dominance_kernel", 0.0)
        ranking[name] = {"ms": ms, "dominance_kernel_ms": kernel,
                         "kernel_share": kernel / ms,
                         "profiled_wall_ms": wall, "device_busy_ms": busy,
                         "idle_share": max(0.0, 1.0 - busy / wall),
                         "kernel_breakdown": kernel_breakdown(intervals)}
    emit({"phase": "kernels", "ranking": "section_4_5", "shape": [8192, 3],
          "objectives": "uniform [0, 1), torch.Generator seed 0",
          "fronts": fronts, "equal_ranks": True,
          "launches": rank_launches, **ranking})

    # B4: the surrogate's distance assembly (the default run's two GP fits
    # at 16 and 24 points and its largest history, select_lengthscale's
    # subsample, K_mm, K_mn at 50,000, and update_inducing's K_m,new for a
    # tell of 8), bitwise; the covariance epilogues at the K_mn shape and
    # at the gp_chol path's (4096 points in 8 dims). Beside the bound, the
    # issue floor: the row loop's SASS instructions an output (phase
    # build's gp_kernels) times the outputs, over 4 warp instructions a
    # clock on every SM at the SM clock nvidia-smi gives as the card's
    # most (clocks.max.sm; clocks.sm, read beside it, is the clock now)
    def points(n, d=2):
        return torch.rand((n, d), generator=gen, device=dev)

    def ulps(a, b):
        return (a.view(torch.int32).long() - b.view(torch.int32).long()) \
            .abs().max().item()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split("\n")[0].split(",")
    sm_mhz, sm_max_mhz = (float(x) for x in smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = 4 * sms * sm_max_mhz * 1e6
    for n1, n2, d, kind in ((16, 16, 2, "sqdist"), (24, 24, 2, "sqdist"),
                            (80, 80, 2, "sqdist"), (1024, 1024, 2, "sqdist"),
                            (512, 512, 2, "sqdist"), (512, 8, 2, "sqdist"),
                            (512, 50000, 2, "sqdist"),
                            (512, 50000, 2, "matern52"),
                            (512, 50000, 2, "rbf"),
                            (4096, 4096, 8, "matern52"),
                            (4096, 4096, 8, "rbf")):
        x1 = points(n1, d)
        x2 = x1 if n1 == n2 else points(n2, d)
        if kind == "sqdist":
            name = "gp_sqdist"
            run = lambda: gp.gp_sqdist(x1, x2)          # noqa: E731
            plain = lambda: ref.gp_sqdist_ref(x1, x2)   # noqa: E731
            epilogue_ops = 0
        else:
            name = "gp_matrix"
            run = lambda: gp.gp_matrix(                 # noqa: E731
                x1, x2, kind=kind, lengthscale=0.2, variance=1.0)
            plain = lambda: ref.gp_matrix_ref(          # noqa: E731
                x1, x2, kind=kind, lengthscale=0.2, variance=1.0)
            # Matérn: sqrt, div, 4 mul, 2 add, exp; RBF: 2 mul, div, exp
            epilogue_ops = 9 if kind == "matern52" else 4
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        n_ulp = ulps(got, want)
        require(torch.equal(got, want), f"{name}({kind}) bitwise at "
                f"({n1},{n2},{d}): max abs err {err}, {n_ulp} ulp")
        b_ms, b_by = bound_ms((n1 + n2) * d * 4 + n1 * n2 * 4,
                              n1 * n2 * (2 * d + 2 + epilogue_ops)
                              + (n1 + n2) * d * 2)
        kernel = gp_kernels[gp.kernel_name_for(d, kind, n2)]
        r = {"kernel": name, "kind": kind, "shape": [n1, n2, d],
             "bitwise": True, "max_abs_err": err, "max_ulp": n_ulp,
             "ms": device_ms(torch, run), "call_ms": call_ms(torch, run),
             "plain_ms": device_ms(torch, plain, reps=5),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "launch": dataclasses.asdict(gp.launch_config(
                 n1, n2, sms, gp.blocks_per_sm(0, d, gp.KINDS[kind],
                                               n2 % gp.VEC == 0))),
             "row_loop_per_output": kernel["per_output"],
             "issue_floor_ms": kernel["per_output"] * n1 * n2 / 32
             / issue_per_s * 1e3,
             "sm_clock_mhz": sm_mhz, "sm_max_clock_mhz": sm_max_mhz}
        results[(name, kind, n1, n2)] = r
        emit({"phase": "kernels", **r})

    # B5: the blocked Cholesky on A A^T / n + I at gp_chol's size (4096,
    # block 512), padded from 4000, and at the reference's interpret-mode
    # check size (83 -> 128, block 64); the kernel on the identity-padded
    # matrix that ops.chol_factor hands it. Kernel (64-wide tiles,
    # right-looking) and plain version (block-wide tiles, left-looking,
    # recursive tile factor) sum in other orders: held to rtol = atol =
    # 2e-4, the reference bench's tolerance between two algorithms for one
    # factor (benchmarks/run.py:593-595), and to a relative residual
    # |L L^T - A|_F / |A|_F under 1e-4.
    def spd(n):
        a = torch.randn((n, n), generator=gen, device=dev)
        return a @ a.T / n + torch.eye(n, device=dev)

    def padded(a, n_p):
        ap = torch.eye(n_p, device=dev)
        ap[:a.shape[0], :a.shape[0]] = a
        return ap

    def residual(l, a):
        return (torch.linalg.matrix_norm(l @ l.T - a)
                / torch.linalg.matrix_norm(a)).item()

    # the factor's written-out square root and division against the
    # intrinsics whose bits they promise (csrc/cholesky.cu)
    fast = cholesky.fast_path_check(dev)
    require(fast["sqrt_unequal"] == 0 and fast["div_unequal"] == 0
            and fast["sqrt_fast"] + fast["sqrt_slow"] == 2 ** 31
            and fast["div_fast"] + fast["div_slow"] == 2 ** 26,
            f"cholesky.cu fast paths against __fsqrt_rn / __fdiv_rn: {fast}")
    emit({"phase": "kernels", "check": "chol_fast_paths", **fast})

    chol_tol = {"rtol": 2e-4, "atol": 2e-4, "residual": 1e-4}
    for n, block in ((4096, 512), (4000, 512), (83, 64)):
        n_p = -(-n // block) * block
        a = spd(n)
        ap = padded(a, n_p)
        run = lambda: cholesky.chol_blocked(ap)                  # noqa: E731
        plain = lambda: ref.chol_blocked_ref(ap, block=block)    # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        resid = residual(got[:n, :n], a)
        require(torch.allclose(got, want, rtol=2e-4, atol=2e-4)
                and resid < 1e-4
                and torch.equal(got[n:, n:], torch.eye(n_p - n, device=dev))
                and not got[n:, :n].any() and not got.triu(1).any(),
                f"chol_blocked at ({n}, block {block}): max abs err {err}, "
                f"residual {resid}")
        # ops pads only to a multiple of 64 on the card: the same bits
        require(torch.equal(ops.chol_factor(a, block=block), got[:n, :n]),
                f"chol_factor at ({n}, block {block}) differs from the "
                f"factor of the matrix padded to {n_p}")
        b_ms, b_by = bound_ms(2 * n_p * n_p * 4, n_p ** 3 / 3)
        r = {"kernel": "chol_blocked", "shape": [n, n], "padded": n_p,
             "block": block, "max_abs_err": err, "residual": resid,
             "tolerance": chol_tol,
             # cuSOLVER potrf; cholesky_ex skips the check that would
             # copy its status to the host after every call
             **factor_timing(torch, run, lambda: torch.linalg.cholesky_ex(
                 ap), n_p // 64),
             "call_ms": call_ms(torch, lambda: ops.chol_factor(
                 a, block=block), reps=5, inner=3),
             "plain_ms": call_ms(torch, plain, reps=1, inner=1, warmup=0),
             "bound_ms": b_ms, "bound_by": b_by}
        if n == 4096:
            # inside the step kernel: SM cycles of block 0's phases, the
            # median over the 64 steps, and the first, middle and last steps
            cholesky.chol_phase_cycles(ap)
            torch.cuda.synchronize()
            steps = cholesky.chol_phase_cycles(ap)
            r["step_phase_cycles"] = {
                "median": {ph: statistics.median(s[ph] for s in steps)
                           for ph in steps[0]},
                **{f"step_{k}": steps[k] for k in (0, 1, 32, 62, 63)}}
        results[("chol_blocked", n)] = r
        emit({"phase": "kernels", **r})

    # B6: the fused assembly and factorization at the same sizes, 8
    # dimensions, both kinds: bitwise equal to B5's factor of the matrix
    # assembled tile by tile with the plain gp_tile_ref (the fused kernel
    # assembles in B4's arithmetic order), and within 2e-4 of the fused
    # plain version
    for n, block in ((4096, 512), (4000, 512), (83, 64)):
        n_p = -(-n // block) * block
        xp = torch.zeros((n_p, 8), device=dev)
        xp[:n] = torch.rand((n, 8), generator=gen, device=dev)
        for kind in ("matern52", "rbf"):
            kw = dict(kind=kind, lengthscale=0.2, nugget=1e-4)
            run = lambda: cholesky.gp_chol_blocked(  # noqa: E731
                xp, n, **kw)
            plain = lambda: ref.gp_chol_blocked_ref(  # noqa: E731
                xp, n, block=block, **kw)
            k = ref.gp_tile_ref(xp, xp, 0, 0, n, **kw)
            got, want, unfused = run(), plain(), cholesky.chol_blocked(k)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            resid = residual(got[:n, :n], k[:n, :n])
            require(torch.equal(got, unfused),
                    f"gp_chol_blocked({kind}) at ({n}, 8) differs from "
                    f"chol_blocked of the plainly assembled matrix in "
                    f"{int((got != unfused).sum())} entries")
            require(torch.allclose(got, want, rtol=2e-4, atol=2e-4)
                    and resid < 1e-4,
                    f"gp_chol_blocked({kind}) at ({n}, 8): max abs err "
                    f"{err}, residual {resid}")
            require(torch.equal(ops.gp_chol(xp[:n], block=block, **kw),
                                got[:n, :n]),
                    f"gp_chol({kind}) at ({n}, block {block}) differs from "
                    f"the factor of the points padded to {n_p}")
            # per lower element: 2 x 8 multiply-adds, the distance's 3
            # operations, the epilogue (Matern 9, RBF 4), the nugget add
            assembly_ops = n_p * (n_p + 1) / 2 * (
                2 * 8 + 3 + (9 if kind == "matern52" else 4) + 1)
            b_ms, b_by = bound_ms(n_p * 8 * 4 + n_p * n_p * 4,
                                  n_p ** 3 / 3 + assembly_ops)
            r = {"kernel": "gp_chol_blocked", "kind": kind,
                 "shape": [n, 8], "padded": n_p, "block": block,
                 "bitwise_vs_chol_blocked": True, "max_abs_err": err,
                 "residual": resid, "tolerance": chol_tol,
                 # cuSOLVER potrf of the assembled matrix, the assembly
                 # not included
                 **factor_timing(torch, run, lambda: torch.linalg.cholesky_ex(
                     k), n_p // 64),
                 "library_includes_assembly": False,
                 "call_ms": call_ms(torch, lambda: ops.gp_chol(
                     xp[:n], block=block, **kw), reps=5, inner=3),
                 "plain_ms": call_ms(torch, plain, reps=1, inner=1,
                                     warmup=0),
                 "bound_ms": b_ms, "bound_by": b_by}
            results[("gp_chol_blocked", kind, n)] = r
            emit({"phase": "kernels", **r})

    # B7: the inducing fit's forward solve L_m A = K_mn at (512, 50,000),
    # and a backward solve; the kernel on the tile-padded operands that
    # ops.tri_solve hands it; the factors from the port's own chol_factor
    def lower(n):
        return ops.chol_factor(spd(n))

    for n, m, trans in ((512, 50000, False), (512, 2048, True)):
        l = lower(n)
        b = torch.randn((n, m), generator=gen, device=dev)
        m_p = -(-m // ops.TRSM_RHS_BLOCK) * ops.TRSM_RHS_BLOCK
        bp = torch.zeros((n, m_p), device=dev)
        bp[:, :m] = b
        run = lambda: cholesky.tri_solve_blocked(   # noqa: E731
            l, bp, trans=trans)
        plain = lambda: ref.tri_solve_blocked_ref(  # noqa: E731
            l, bp, trans=trans, block=ops.CHOL_BLOCK)
        lt = l.T if trans else l
        library = lambda: torch.linalg.solve_triangular(  # noqa: E731
            lt, b, upper=trans)
        got, want = run(), plain()
        x = ops.tri_solve(l, b, trans=trans)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        resid = (torch.linalg.matrix_norm(lt @ x - b)
                 / torch.linalg.matrix_norm(b)).item()
        # both substitute through explicit inverses of diagonal tiles (64
        # wide in the kernel, 256 in the plain version) and sum their tile
        # products in other orders: on these well-conditioned factors
        # (A A^T / n + I) they agree to 1e-4 of max |X|, and the kernel
        # solves to a relative residual under 1e-5
        require(rel < 1e-4 and resid < 1e-5,
                f"tri_solve trans={trans} at ({n},{m}): rel err {rel}, "
                f"residual {resid}")
        b_ms, b_by = bound_ms((n * n + 2 * n * m_p) * 4, n * n * m_p)
        kt, lt = turns_ms(torch, run, library, inner=10, library_inner=3,
                          hold_cycles=HOLD_CYCLES)
        # the diagonal work (the pack kernel: the diagonal tiles' inverses,
        # beside the copies of L's blocks) against the solve
        _, kernel_sum, _, intervals = profiled(torch, run, 5)
        strip = cholesky.solve_strip(n, m_p, sms)
        r = {"kernel": "tri_solve", "trans": trans, "shape": [n, m],
             "padded_rhs": m_p, "strip": strip,
             "resident": cholesky.solve_resident(n, strip),
             "max_abs_err": err, "rel_err": rel,
             "residual": resid, "tolerance": {"rel_err": 1e-4,
                                              "residual": 1e-5},
             "timed_by": "cuda_events_in_turns_queued",
             "ms": kt["median"], "ms_min_max": [kt["min"], kt["max"]],
             "samples": kt["n"], "library_ms": lt["median"],
             "library_min_max": [lt["min"], lt["max"]],
             "ratio_to_library": kt["median"] / lt["median"],
             "bound_share": b_ms / kt["median"],
             "kernel_sum_ms": kernel_sum / 5,
             "device_busy_ms": busy_union_ms(intervals) / 5,
             "kernel_breakdown": kernel_breakdown(intervals, 5),
             "call_ms": call_ms(torch, lambda: ops.tri_solve(
                 l, b, trans=trans), reps=5, inner=3),
             "plain_ms": device_ms(torch, plain, reps=3),
             "bound_ms": b_ms, "bound_by": b_by}
        results[("tri_solve", trans, n, m)] = r
        emit({"phase": "kernels", **r})

    # the custom ops' cost on the host: B1 at calibrate's 640 lanes and B2 at
    # its 256 rows in 8 groups, each through its torch.library op (the
    # route of kernels.ops) and through its launcher, in turns
    emit({"phase": "kernels", "check": "custom_op_overhead",
          **custom_op_overhead(torch, dev, gen)})

    stamp()

    # -- 4. the card against the CPU plain path on a small input -------------
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

    # gp_fit on the card (the gp_sqdist kernel, cuSOLVER's batched
    # Cholesky) against the CPU plain path, n = 80 seeded points of a rough
    # objective: the same lengthscale; the factor within 1e-3 and alpha
    # within 1e-2 of its largest entry (each side factors in its own
    # schedule); the posterior mean within 1e-3
    rng = np.random.default_rng(0)
    hx = rng.random((80, 2)).astype(np.float32)
    hy = (np.sin(9 * hx[:, 0]) * np.cos(7 * hx[:, 1])
          + 0.3 * hx[:, 1]).astype(np.float32)
    xq = torch.from_numpy(rng.random((16, 2)).astype(np.float32))
    scfg = surrogate.SurrogateConfig(bounds=((0.0, 1.0), (0.0, 1.0)))
    fits = {}
    for where in ("cpu", "cuda"):
        st = surrogate.gp_fit(scfg, torch.from_numpy(hx).to(where),
                              torch.from_numpy(hy).to(where))
        mean = surrogate.gp_mean_var(scfg, st, xq.to(where))[0]
        fits[where] = (st, mean.cpu())
    (sc, mc), (sg, mg) = fits["cpu"], fits["cuda"]
    chol_err = (sg.chol.cpu() - sc.chol).abs().max().item()
    alpha_err = ((sg.alpha.cpu() - sc.alpha).abs().max()
                 / sc.alpha.abs().max()).item()
    mean_err = (mg - mc).abs().max().item()
    require(float(sg.lengthscale) == float(sc.lengthscale)
            and chol_err < 1e-3 and alpha_err < 1e-2 and mean_err < 1e-3,
            f"gp_fit card vs CPU: lengthscale {float(sg.lengthscale)} vs "
            f"{float(sc.lengthscale)}, chol {chol_err}, alpha {alpha_err}, "
            f"mean {mean_err}")
    emit({"phase": "parity", "what": "gp_fit", "n": 80,
          "lengthscale": float(sg.lengthscale), "chol_max_abs_err": chol_err,
          "alpha_rel_err": alpha_err, "posterior_mean_max_abs_err": mean_err,
          "tolerance": {"chol": 1e-3, "alpha_rel": 1e-2, "mean": 1e-3}})

    stamp()

    # -- 5. the main path: calibrate at the paper's model size ---------------
    flags = CAL_FLAGS
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

    cal_launches = launches
    one_rank = (state, front, wall)

    stamp()

    # -- 6. the surrogate path at the paper's model size ----------------------
    # depth cut from 4 rounds to 3 (2 Sobol, 1 GP): the whole script ran
    # 1089 s to the end of phase serve on a slow machine, before phases
    # train and bandit
    sflags = dict(rounds=3, q=8, n_init=16, replicates=3)
    with tempfile.TemporaryDirectory() as out:
        ops.reset_kernel_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, result = explore.calibrate_surrogate(
            reduced=False, device="cuda", out_dir=out,
            printer=lambda s: emit({"phase": "surrogate", "log": s}),
            **sflags)
        torch.cuda.synchronize()
        wall = wall_sur = time.perf_counter() - t0
        sur_launches = ops.kernel_launch_counts()
        files = sorted(p.name for p in Path(out).iterdir())
    n_evals = sflags["rounds"] * sflags["q"]
    sur_res = res
    require(len(res.objectives) == n_evals == len(result["objectives"]),
            f"surrogate evaluations {len(res.objectives)} != {n_evals}")
    require(sur_launches["gp_sqdist"] >= 1,
            f"gp_sqdist launches {sur_launches['gp_sqdist']} (want >= 1)")
    require(sur_launches["diffuse_evaporate"] == n_evals * CONFIG.max_ticks,
            f"diffuse_evaporate launches {sur_launches['diffuse_evaporate']}")
    require(np.isfinite(res.best_objective)
            and 0 <= res.best_objective <= CONFIG.max_ticks,
            f"surrogate best objective {res.best_objective}")
    require({"surrogate_result.json", "provenance.json"} <= set(files),
            f"surrogate outputs {files}")
    # one evaluation alone on this thread, beside the pool's wall per
    # evaluation: what the pool's six job threads gain or lose
    one = explore.ants_scalar_eval(False, sflags["replicates"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(gen, torch.tensor([[50.0, 50.0]], device=dev))
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    one_eval = dataclasses.replace(CONFIG, max_ticks=20)
    g3 = torch.rand((3,), device=dev, generator=gen) * 99
    sur_busy = device_busy_share(torch, lambda: model.simulate_batch(
        one_eval, g3, g3, generator=gen))
    emit({"phase": "surrogate", "config": "CONFIG", **sflags,
          "wall_s": wall, "evaluations": n_evals,
          "evaluations_per_hour": n_evals / wall * 3600,
          "wall_per_evaluation_s": wall / n_evals,
          "one_evaluation_alone_s": alone_s,
          "attempts": res.attempts, "repriorities": res.repriorities,
          "best_objective": res.best_objective,
          "best_genome": np.asarray(res.best_genome).tolist(),
          "launches": sur_launches,
          "profile_20_ticks_3_lanes": sur_busy})

    # the same run (calibrate_surrogate's configuration and objective)
    # through one worker of one slot, its depth cut to the first round (the
    # trajectory is a pure function of the told history, so its rows are a
    # prefix of the pooled run's; phase service holds the whole run through
    # a third pool shape): the same results, and the wall time an
    # evaluation that six concurrent jobs gain or lose against one
    serial_rounds = 1
    n_serial = serial_rounds * sflags["q"]
    serial_pool = explore.make_init_pool(0.0, workers=1, capacity=1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = surrogate.run_surrogate(
            surrogate.SurrogateConfig(bounds=explore.BOUNDS, q=sflags["q"],
                                      n_init=sflags["n_init"], seed=0),
            explore.ants_scalar_eval(False, sflags["replicates"]),
            rounds=serial_rounds, environment=serial_pool, device="cuda")
        torch.cuda.synchronize()
        serial_wall = time.perf_counter() - t0
    finally:
        serial_pool.shutdown()
    require(np.array_equal(serial.genomes, res.genomes[:n_serial])
            and np.array_equal(serial.objectives, res.objectives[:n_serial]),
            "the surrogate through one slot differs from the pooled run")
    # 6 evaluations cut to 100 ticks through each pool: the window's wall,
    # the process's CPU time over it, each job's wall beside the CPU time of
    # the thread that ran it (a thread blocked on the GIL or a lock burns no
    # CPU; one spinning does), and the device's busy time (torch.profiler's
    # CUDA records, which come from every thread)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Context
    cut_eval = explore.ants_eval_fn(dataclasses.replace(CONFIG, max_ticks=100),
                                    sflags["replicates"])
    jobs = []

    def timed_eval(g, x):
        c0, w0 = time.thread_time(), time.perf_counter()
        y = cut_eval(g, x)[:, 0].cpu()
        jobs.append((time.perf_counter() - w0, time.thread_time() - c0))
        return y

    probe_task = surrogate.make_eval_task(scfg, timed_eval, device="cuda")
    ctxs = [Context({"round": 0, "slot": i, "x": (10.0 + 15.0 * i, 40.0)})
            for i in range(6)]
    probes = {}
    for workers, capacity in ((3, 2), (1, 1)):
        pool = explore.make_init_pool(0.0, workers=workers, capacity=capacity)
        try:
            pool.submit(probe_task, ctxs[0])                # warm-up
            torch.cuda.synchronize()
            jobs.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                c0, t0 = time.process_time(), time.perf_counter()
                futs = [pool.submit_async(probe_task, c) for c in ctxs]
                ys = [f.result()[0]["y"] for f in futs]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cpu = time.process_time() - c0
        finally:
            pool.shutdown()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        cpu_ops = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU]
        probes[f"{workers}x{capacity}"] = {
            "wall_s": wall, "process_cpu_s": cpu, "ys": ys,
            "job_wall_s": [j[0] for j in jobs],
            "job_thread_cpu_s": [j[1] for j in jobs],
            "device_busy_s": busy_us / 1e6,
            "profiled_cpu_ops": len(cpu_ops),
            "profiled_threads": len({e.thread for e in cpu_ops})}
    require(probes["3x2"]["ys"] == probes["1x1"]["ys"],
            f"pool probe results differ: {probes}")
    emit({"phase": "surrogate", "what": "pool_shape",
          "pooled_3x2_wall_s": wall_sur, "serial_1x1_wall_s": serial_wall,
          "serial_1x1_evaluations": n_serial,
          "wall_per_evaluation_s": {"pooled_3x2": wall_sur / n_evals,
                                    "serial_1x1": serial_wall / n_serial},
          "results_equal": True, "probe_6_evaluations_100_ticks": probes})

    stamp()

    # -- 7. the surrogate at archive scale: 50,000 told points ---------------
    def synthetic(x):       # the archive benchmark's objective
        return ((x[:, 0] - 0.3) ** 2 + (x[:, 1] - 0.7) ** 2
                + 0.01 * np.sin(17 * x[:, 0])).astype(np.float32)

    n_big = 50000
    bcfg = surrogate.SurrogateConfig(bounds=((0.0, 1.0), (0.0, 1.0)), q=8,
                                     n_init=16, seed=0)
    hist = np.random.default_rng(0).random((n_big, 2)).astype(np.float32)
    ex = surrogate.SurrogateExplorer(bcfg, device="cuda")
    ex.load_state_arrays({"x01": hist, "y": synthetic(hist),
                          "round": np.int32(n_big // bcfg.q)})
    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xq = ex.ask()
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.tell(xq, synthetic(xq))
    torch.cuda.synchronize()
    t_tell = time.perf_counter() - t0
    t0 = time.perf_counter()
    xq2 = ex.ask()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    big_launches = ops.kernel_launch_counts()
    state = ex.last_state
    mean, var = surrogate.gp_mean_var(bcfg, state, torch.from_numpy(
        np.concatenate([xq, xq2])).to(dev))
    require(type(state).__name__ == "InducingGPState",
            f"archive-scale state is {type(state).__name__}")
    require(big_launches["tri_solve"] >= 1,
            f"tri_solve launches {big_launches['tri_solve']}")
    require(big_launches["gp_sqdist"] >= 3,
            f"gp_sqdist launches {big_launches['gp_sqdist']} (want >= 3)")
    require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
                 and (var > 0).all()), "archive-scale posterior finite")
    for batch in (xq, xq2):
        require(batch.shape == (8, 2) and bool(np.isfinite(batch).all())
                and bool(((batch >= 0) & (batch <= 1)).all()),
                f"archive-scale proposals in the unit cube: {batch}")
    emit({"phase": "surrogate_big", "history": n_big, "q": bcfg.q,
          "n_inducing": bcfg.n_inducing, "n_max_exact": bcfg.n_max_exact,
          "cold_ask_s": t_cold, "tell_s": t_tell, "warm_ask_s": t_warm,
          "lengthscale": float(state.lengthscale),
          "best_seen": float(ex.best[1]),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": big_launches})

    stamp()

    # -- 8. one chunk of the streaming init ---------------------------------
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

    stamp()

    # -- 9. the streaming init through the pool, seeding a pipelined run -----
    init_launches, init_inline = init_phase(torch, dev, gen)

    stamp()

    # -- 10. the archive-scale GP factorization: bench_gp_chol at full size ---
    n_gp, block = 4096, 512
    grid = (0.05, 0.1, 0.2, 0.4, 0.8)
    gkw = dict(kind="matern52", nugget=1e-4)
    x = torch.rand((n_gp, 8), generator=gen, device=dev)
    ops.gp_chol(x, lengthscale=grid[0], block=block, **gkw)   # warm-up
    ops.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fused = [ops.gp_chol(x, lengthscale=ls, block=block, **gkw)
             for ls in grid]
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    # the same sweep unfused: B4 assembles K, the nugget goes on the
    # diagonal, B5 factors it
    t0 = time.perf_counter()
    unfused = []
    for ls in grid:
        k = ops.gp_matrix(x, x, kind=gkw["kind"], lengthscale=ls)
        k.diagonal().add_(gkw["nugget"])
        unfused.append(ops.chol_factor(k, block=block))
    torch.cuda.synchronize()
    unfused_wall = time.perf_counter() - t0
    gp_launches = ops.kernel_launch_counts()
    differ = [int((f != u).sum()) for f, u in zip(fused, unfused)]
    require(not any(differ), f"gp_chol and gp_matrix + chol_factor differ "
            f"in {differ} entries at lengthscales {grid}")
    del k, unfused
    per_factor_ms = []
    for ls in grid:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ops.gp_chol(x, lengthscale=ls, block=block, **gkw)
        end.record()
        end.synchronize()
        per_factor_ms.append(start.elapsed_time(end))
    gp_busy = device_busy_share(torch, lambda: [
        ops.gp_chol(x, lengthscale=ls, block=block, **gkw) for ls in grid])

    # the reference bench's lapack_sweep: the assembled (5, n, n) stack and
    # one batched potrf (cuSOLVER); never called by the port
    def library_sweep():
        d2 = ref.gp_sqdist_ref(x, x)
        ls = torch.tensor(grid, device=dev)[:, None, None]
        ks = ref.gp_kernel_fn(gkw["kind"], d2, ls, 1.0) \
            + gkw["nugget"] * torch.eye(n_gp, device=dev)
        return torch.linalg.cholesky_ex(ks).L

    lib = library_sweep()
    torch.cuda.synchronize()
    errs = [(f - lf).abs().max().item() for f, lf in zip(fused, lib)]
    fused_ok = [torch.allclose(f, lf, rtol=2e-4, atol=2e-4)
                for f, lf in zip(fused, lib)]
    require(all(fused_ok), f"gp_chol against cuSOLVER (rtol = atol = 2e-4): "
            f"max abs errs {errs} at lengthscales {grid}")
    for f in fused:
        require(tuple(f.shape) == (n_gp, n_gp)
                and bool(torch.isfinite(f).all()), "gp_chol factor finite")
    require(gp_launches["gp_chol_blocked"] == len(grid)
            and gp_launches["chol_blocked"] == len(grid)
            and gp_launches["gp_matrix"] == len(grid),
            f"gp_chol launches {gp_launches}")
    del lib
    library_ms = call_ms(torch, library_sweep, reps=3, inner=1, warmup=1)
    emit({"phase": "gp_chol", "n": n_gp, "d": 8, "block": block,
          "kind": gkw["kind"], "nugget": gkw["nugget"], "lengthscales": grid,
          "sweep_wall_ms": sweep_wall * 1e3,
          "unfused_sweep_wall_ms": unfused_wall * 1e3,
          "fused_equals_unfused": True, "per_factor_ms": per_factor_ms,
          "library_sweep_ms": library_ms,
          "max_abs_err_vs_library": errs, "tolerance": 2e-4,
          "sweep_peak_memory_gb": peak / 1e9,
          "memory_before_gb": base / 1e9, "launches": gp_launches,
          "profile_sweep": gp_busy})

    stamp()

    # -- 11. flash attention at smollm-135m's full width ----------------------
    flash_rows, flash_launches = flash_phase(torch, dev, gen)
    results.update(flash_rows)

    stamp()

    # -- 12. the paper's Listings 2-5 through the port's DSL -----------------
    dsl_launches = dsl_phase(torch, dev)

    stamp()

    # -- 13. several ranks on the card: the sharded sweep, the island mesh,
    # the device-set pool member
    mesh_launches, meshenv_launches = mesh_phase(torch, dev, one_rank,
                                                 init_inline)

    stamp()

    # -- 14. the multi-objective qEHVI surrogate and the local-GP ensemble
    mo_launches, mo_big_launches = surrogate_mo_phase(torch, dev, results)

    stamp()

    # -- 15. the exploration service: two tenants over one pool
    svc_launches = service_phase(torch, dev, sur_res)

    stamp()

    # -- 16. LM serving: smollm-135m at full width, every arch at REDUCED,
    # four more at CONFIG; no kernel of the port on this path
    serve_launches = serve_phase(torch, dev)

    stamp()

    # -- 17. LM training: smollm-135m at full width; no kernel on this path
    train_launches = train_phase(torch, dev)

    stamp()

    # -- 18. bandit-routed serving with the surrogate loop: B4 in its fits
    bandit_launches = bandit_phase(torch, dev)

    stamp()

    # -- 19. the kernels line, the card, the contract line -------------------
    # (kernel, result key, source, TPU kernel, the path whose run gives the
    # launches); every path's counts are listed beside it
    by_path = {"ranking": rank_launches,
               "calibrate": cal_launches, "init": init_launches,
               "surrogate": sur_launches,
               "surrogate_big": big_launches, "gp_chol": gp_launches,
               "flash": flash_launches, "dsl": dsl_launches,
               "mesh": mesh_launches, "surrogate_mo": mo_launches,
               "surrogate_mo_big": mo_big_launches,
               "service": svc_launches, "serve": serve_launches,
               "train": train_launches, "bandit": bandit_launches,
               "meshenv": meshenv_launches, "package": package_launches}
    rows = (
        ("diffuse_evaporate", ("diffuse_evaporate", 640), "diffusion.cu",
         "src/repro/kernels/diffusion.py:89", "calibrate"),
        ("dominance_pass", ("dominance_pass", 256, True, 0), "dominance.cu",
         "src/repro/kernels/dominance.py:154", "calibrate"),
        # B3: the section 4.5 peeling baseline, one sweep a front
        ("dominated_counts", ("dominated_counts", 8192), "dominance.cu",
         "src/repro/kernels/dominance.py:101", "ranking"),
        ("gp_sqdist", ("gp_sqdist", "sqdist", 512, 50000), "gp.cu",
         "src/repro/kernels/gp.py:93", "surrogate_big"),
        # gp_matrix: the gp_chol path's unfused sweep assembles with it
        ("gp_matrix", ("gp_matrix", "matern52", 4096, 4096), "gp.cu",
         "src/repro/kernels/gp.py:99", "gp_chol"),
        ("chol_blocked", ("chol_blocked", 4096), "cholesky.cu",
         "src/repro/kernels/cholesky.py:165", "gp_chol"),
        ("gp_chol_blocked", ("gp_chol_blocked", "matern52", 4096),
         "cholesky.cu", "src/repro/kernels/cholesky.py:202", "gp_chol"),
        ("tri_solve", ("tri_solve", False, 512, 50000), "trisolve.cu",
         "src/repro/kernels/cholesky.py:282", "surrogate_big"),
        # the backward solve: the same kernels, off every path
        ("tri_solve_backward", ("tri_solve", True, 512, 2048), "trisolve.cu",
         "src/repro/kernels/cholesky.py:282", "surrogate_big"),
        # the flash rows: bf16 (the config's dtype) at (4, 4096, 9/3, 64)
        ("flash_attention", ("flash_attention", "bf16"), "flash.cu",
         "src/repro/kernels/flash_attention.py:95", "flash"),
        ("flash_attention_fwd", ("flash_attention_fwd", "bf16"), "flash.cu",
         "src/repro/kernels/flash_attention_bwd.py:95", "flash"),
        ("flash_attention_dq", ("flash_attention_dq", "bf16"), "flash.cu",
         "src/repro/kernels/flash_attention_bwd.py:221", "flash"),
        ("flash_attention_dkv", ("flash_attention_dkv", "bf16"), "flash.cu",
         "src/repro/kernels/flash_attention_bwd.py:245", "flash"),
        # and in f32, on the CUDA cores: their own kernels of flash.cu
        ("flash_attention_f32", ("flash_attention", "f32"), "flash.cu",
         "src/repro/kernels/flash_attention.py:95", "flash"),
        ("flash_attention_fwd_f32", ("flash_attention_fwd", "f32"),
         "flash.cu", "src/repro/kernels/flash_attention_bwd.py:95", "flash"),
        ("flash_attention_dq_f32", ("flash_attention_dq", "f32"), "flash.cu",
         "src/repro/kernels/flash_attention_bwd.py:221", "flash"),
        ("flash_attention_dkv_f32", ("flash_attention_dkv", "f32"),
         "flash.cu", "src/repro/kernels/flash_attention_bwd.py:245",
         "flash"),
    )
    kernels = []
    for name, key, source, replaces, path in rows:
        r = results[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": by_path[path][name],
            "path": path,
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "shape": r["shape"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--package"]:
        sys.exit(package_rank(sys.argv[2:]))
    sys.exit(main())
