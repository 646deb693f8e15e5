"""Time the port's per-tick diffusion kernel (B1), its triangular solve
(B7), its dominance sweeps (B2, B3) and one chunk of the streaming init in
two checkouts of the repo on one CUDA card, in turns: A, B, B, A, each run
in a process of its own (each builds its own kernels), so that a change is
read against its parent on the same card within one call.

    python3 tools/compare_trees.py PARENT_DIR CHANGED_DIR [--chunk]
        [--calibrate]
    python3 tools/compare_trees.py PARENT_DIR CHANGED_DIR --flash
    python3 tools/compare_trees.py PARENT_DIR CHANGED_DIR --gp

Each run prints one JSON line: B1 at (640, 72, 72) and (20480, 72, 72),
B7 forward at L 512, B (512, 50,176) and backward at B (512, 2048), B2 at
128 and 256 rows in 8 groups (the GA rankings), 320 rows with 256 of them
+BIG (the first archive merge), 2048 and 8192 rows and B3 at 2048 and 8192
rows (3 objectives, integers in [0, 1000]), each checked against
its plain version (B1 bitwise; B7 within 1e-4 of max |X|; B2, B3 equal)
and timed with CUDA events (median, min and max of 20 samples of 10
back-to-back calls each, queued behind a spinning card); with --chunk also
one 20480-lane init chunk at CONFIG (lane-ticks per second); with
--calibrate also ``launch.explore.calibrate`` at CONFIG with the
reference's defaults cut to 2 epochs (chip_smoke.py's phase calibrate:
9000 B1 and 23 B2 launches through ``kernels.ops``), its wall on the host
clock. With --flash, instead of all of that, the flash-attention kernels
at smollm-135m's attention (B 4, S 4096, 9 q heads on 3 kv heads, D 64,
causal): the f32 forward (B8), dQ and dK/dV, and the bf16 forward, each
checked against its plain version (f32 out 2e-5, lse 1e-5, gradients
2e-4; bf16 2e-2) and timed as above. With --gp, instead, the GP
covariance assembly (B4): gp_sqdist and gp_matrix's Matérn-5/2 and RBF
epilogues at the archive-scale inducing fit's (512, 50,000, d 2) and the
gp_chol path's (4096, 4096, d 8), and gp_sqdist at the bandit's fits (3,
3), (6, 6) and (9, 9) in 2 dims, each held bitwise to its plain version
and timed as above. The card's name and power limit come last.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def events_ms(torch, fn, reps: int = 20, inner: int = 10) -> dict:
    """Median, min and max ms per call over ``reps`` samples of ``inner``
    back-to-back calls between two CUDA events, after a warm-up. Before
    each sample the card spins ~1 ms (torch.cuda._sleep) while the host
    queues the sample's calls, so that the events read the card's time
    and not the host's launch cost."""
    for _ in range(2):
        fn()
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return {"median": statistics.median(samples), "min": min(samples),
            "max": max(samples)}


CAL_FLAGS = dict(n_islands=8, mu=16, lam=16, steps_per_epoch=4, epochs=2,
                 replicates=5, archive_size=256, merge_top_k=8)


def flash_worker() -> dict:
    """Check and time the flash kernels of the tree on sys.path."""
    import time

    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.monotonic()
    build.build(["flash"])
    out = {"build_s": time.monotonic() - t0}
    b, s, h, kh, d = 4, 4096, 9, 3, 64
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d),
                                 (b, h, s, d)))

    def hold(name, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        out[f"{name}_max_abs_err"] = err
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise RuntimeError(f"flash {name}: max abs err {err} (tol {tol})")

    o, lse = fab.flash_attention_fwd(q, k, v)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v)
    hold("f32_out", o, want_o, 2e-5)
    hold("f32_lse", lse, want_lse, 1e-5)
    del want_o, want_lse
    dsum = (do * o).sum(-1)
    dq = fab.flash_attention_dq(q, k, v, do, lse, dsum)
    dk, dv = fab.flash_attention_dkv(q, k, v, do, lse, dsum)
    for name, got, want in zip(("dq", "dk_h", "dv_h"), (dq, dk, dv),
                               ref.flash_attention_bwd_ref(q, k, v, o, lse,
                                                           do)):
        hold(f"f32_{name}", got, want, 2e-4)
    del dq, dk, dv
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    hold("bf16_out", fa.flash_attention(qb, kb, vb),
         ref.flash_attention_ref(qb, kb, vb), 2e-2)
    torch.cuda.empty_cache()
    out["f32_fwd_ms"] = events_ms(torch, lambda: fa.flash_attention(q, k, v))
    out["f32_dq_ms"] = events_ms(
        torch, lambda: fab.flash_attention_dq(q, k, v, do, lse, dsum))
    out["f32_dkv_ms"] = events_ms(
        torch, lambda: fab.flash_attention_dkv(q, k, v, do, lse, dsum))
    out["bf16_fwd_ms"] = events_ms(
        torch, lambda: fa.flash_attention(qb, kb, vb))
    return out


def gp_worker() -> dict:
    """Check and time the GP assembly kernel of the tree on sys.path."""
    import time

    import torch

    from repro_torch.kernels import build, gp, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.monotonic()
    build.build(["gp"])
    out = {"build_s": time.monotonic() - t0}
    for n1, n2, d, kinds in ((512, 50000, 2, ("sqdist", "matern52", "rbf")),
                             (4096, 4096, 8, ("sqdist", "matern52", "rbf")),
                             (3, 3, 2, ("sqdist",)), (6, 6, 2, ("sqdist",)),
                             (9, 9, 2, ("sqdist",))):
        x1 = torch.rand((n1, d), generator=gen, device=dev)
        x2 = x1 if n1 == n2 else torch.rand((n2, d), generator=gen,
                                             device=dev)
        for kind in kinds:
            if kind == "sqdist":
                def run():
                    return gp.gp_sqdist(x1, x2)
                want = ref.gp_sqdist_ref(x1, x2)
            else:
                def run(kind=kind):
                    return gp.gp_matrix(x1, x2, kind=kind, lengthscale=0.2,
                                        variance=1.0)
                want = ref.gp_matrix_ref(x1, x2, kind=kind, lengthscale=0.2,
                                         variance=1.0)
            if not torch.equal(run(), want):
                raise RuntimeError(f"gp {kind} not bitwise at "
                                   f"({n1}, {n2}, {d})")
            del want
            out[f"{kind}_{n1}x{n2}x{d}_ms"] = events_ms(torch, run)
    return out


def worker(chunk: bool, calibrate: bool = False) -> dict:
    """Measure the kernels (and the chunk) of the tree on sys.path."""
    import time

    import torch

    from repro_torch.kernels import (build, cholesky, diffusion, dominance,
                                     ops, ref)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.monotonic()
    build.build(["diffusion", "trisolve", "dominance"])
    out = {"build_s": time.monotonic() - t0}
    for n in (640, 20480):
        chem = torch.rand((n, 72, 72), generator=gen, device=dev) * 100.0
        rate = torch.rand((n,), generator=gen, device=dev)
        evap = torch.rand((n,), generator=gen, device=dev) * 0.5
        got = diffusion.diffuse_evaporate(chem, rate, evap)
        if not torch.equal(got, ref.diffuse_evaporate_ref(chem, rate, evap)):
            raise RuntimeError(f"diffuse_evaporate not bitwise at {n}")
        out[f"b1_{n}_ms"] = events_ms(
            torch, lambda: diffusion.diffuse_evaporate(chem, rate, evap))
    for n, m, trans in ((512, 50176, False), (512, 2048, True)):
        a = torch.randn((n, n), generator=gen, device=dev)
        l = torch.linalg.cholesky(a @ a.T / n
                                  + torch.eye(n, device=dev)).contiguous()
        b = torch.randn((n, m), generator=gen, device=dev)
        got = cholesky.tri_solve_blocked(l, b, trans=trans)
        want = ref.tri_solve_blocked_ref(l, b, trans=trans,
                                         block=ops.CHOL_BLOCK)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel < 1e-4:
            raise RuntimeError(f"tri_solve trans={trans}: rel err {rel}")
        out[f"b7_{'bwd' if trans else 'fwd'}_{m}_ms"] = events_ms(
            torch, lambda: cholesky.tri_solve_blocked(l, b, trans=trans))
    for n, grouped in ((128, True), (256, True), (320, False), (2048, False),
                       (8192, False)):
        rows = torch.randint(0, 1001, (n, 3), generator=gen,
                             device=dev).to(torch.float32)
        if n == 320:            # the first archive merge: 256 empty rows
            rows[:256] = 1.0e30
        groups = (torch.arange(8, device=dev, dtype=torch.int32)
                  .repeat_interleave(n // 8)) if grouped else None
        got = dominance.dominance_pass(rows, groups=groups)
        want = ref.dominance_pass_ref(rows, groups=groups)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"dominance_pass not equal at {n}")
        out[f"b2_{n}{'_grouped' if grouped else ''}_ms"] = events_ms(
            torch, lambda: dominance.dominance_pass(rows, groups=groups))
        if grouped or n == 320:
            continue
        if not torch.equal(dominance.dominated_counts(rows),
                           ref.dominated_counts_ref(rows)):
            raise RuntimeError(f"dominated_counts not equal at {n}")
        out[f"b3_{n}_ms"] = events_ms(
            torch, lambda: dominance.dominated_counts(rows))
    if chunk:
        from repro_torch.configs.ants_netlogo import CONFIG
        from repro_torch.launch import explore
        genomes = torch.rand((4096, 2), generator=gen, device=dev) * 99
        eval_fn = explore.ants_eval_fn(CONFIG, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_fn(gen, genomes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["chunk_s"] = wall
        out["chunk_lane_ticks_per_s"] = 4096 * 5 * CONFIG.max_ticks / wall
    if calibrate:
        import tempfile

        from repro_torch.launch import explore
        with tempfile.TemporaryDirectory() as run_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            explore.calibrate(reduced=False, out_dir=run_dir, device="cuda",
                              printer=lambda s: None, **CAL_FLAGS)
            torch.cuda.synchronize()
            out["calibrate_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, str(Path(sys.argv[2]) / "src"))
        row = (flash_worker() if "--flash" in sys.argv else
               gp_worker() if "--gp" in sys.argv else
               worker("--chunk" in sys.argv, "--calibrate" in sys.argv))
        print(json.dumps(row), flush=True)
        return 0
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    extra = [f for f in ("--chunk", "--calibrate", "--flash", "--gp")
             if f in sys.argv]
    trees = {"A": Path(args[0]).resolve(), "B": Path(args[1]).resolve()}
    for label in ("A", "B", "B", "A"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        run = subprocess.run(
            [sys.executable, __file__, "--worker", str(trees[label]), *extra],
            capture_output=True, text=True, env=env, timeout=600)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        row = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "dir": str(trees[label]), **row}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
