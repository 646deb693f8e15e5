"""Build variants of ``src/repro_torch/csrc/flash.cu`` side by side and
time their f32 forward and dK/dV kernels in turns on one CUDA card.

    python3 tools/flash_variants.py VARIANTS.json

VARIANTS.json maps a variant's name to a list of text edits ``[[old,
new], ...]`` applied to the checkout's ``flash.cu`` (each ``old`` must
occur in it), or to ``{"file": PATH}``, another ``flash.cu`` to build as
it is. The checkout's own file is the variant ``base``. Every variant is
compiled with ``build.NVCC_FLAGS`` by its own nvcc, all at once, into
``local/variants/<name>/`` (the headers of ``csrc/`` copied beside it) and
loaded with ctypes. Printed, one JSON line each: every variant's ptxas
registers and spill bytes of ``flash_fwd_kernel``, ``flash_dq_kernel`` and
``flash_dkv_kernel`` at each head dim; the largest difference of its f32
forward (out, lse) and dK/dV from ``base``'s at (4, 4096, 9 q heads on 3
kv heads, 64), causal; and the median, min and max ms of each over 8
rounds taken in turns (the variants in order, then reversed), each sample
3 back-to-back calls between CUDA events queued behind a spinning card.
The card's name and power limit come last.
"""
from __future__ import annotations

import ctypes
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def build_variants(spec: dict, out_dir: Path) -> dict:
    """{name: loaded library} of every variant that builds; prints each
    variant's registers and spills, or its compiler output on failure."""
    from repro_torch.kernels import build
    source = (ROOT / "src/repro_torch/csrc/flash.cu").read_text()
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for name, how in {"base": [], **spec}.items():
        if isinstance(how, dict):
            text = Path(how["file"]).read_text()
        else:
            text = source
            for old, new in how:
                if old not in text:
                    raise ValueError(f"{name}: edit not found: {old[:60]!r}")
                text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True)
        for header in glob.glob(str(ROOT / "src/repro_torch/csrc/*.cuh")):
            shutil.copy(header, d)
        (d / "flash.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": log[-3000:]}),
                  flush=True)
            continue
        regs = {}
        for mangled, r in build.kernel_resources(log).items():
            for k in KERNELS:
                if f"{len(k)}{k}ILi" in mangled:
                    d_ = mangled.split(f"{k}ILi")[1].split("E")[0]
                    regs[f"{k}<{d_}>"] = [r.get("registers"),
                                          r.get("spill_stores"),
                                          r.get("spill_loads")]
        print(json.dumps({"variant": name,
                          "registers_spill_stores_loads": regs}), flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 7 + [ctypes.c_float, ptr]
        lib.flash_fwd_launch.argtypes = [ptr] * 5 + tail
        lib.flash_dkv_launch.argtypes = [ptr] * 8 + tail
        libs[name] = lib
    return libs


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    spec = json.loads(Path(sys.argv[1]).read_text())
    libs = build_variants(spec, ROOT / "local" / "variants")
    if "base" not in libs:
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, kh, d = 4, 4096, 9, 3, 64
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d),
                                 (b, h, s, d)))
    args = (b, h, kh, s, d, 0, 1, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)

    def fwd(lib, out, lse):
        err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), lse.data_ptr(), *args)
        if err:
            raise RuntimeError(f"flash_fwd_launch: error {err}")

    def dkv(lib, lse, dsum, dk, dv):
        err = lib.flash_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(),
                                   dsum.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), *args)
        if err:
            raise RuntimeError(f"flash_dkv_launch: error {err}")

    outs = {}
    for name, lib in libs.items():
        o, lse = torch.empty_like(q), torch.empty((b, h, s), device=dev)
        fwd(lib, o, lse)
        outs[name] = [o, lse]
    base_o, base_lse = outs["base"]
    dsum = (do * base_o).sum(-1)
    for name, lib in libs.items():
        dk, dv = torch.empty_like(q), torch.empty_like(q)
        dkv(lib, base_lse, dsum, dk, dv)
        outs[name] += [dk, dv]
    for name, got in outs.items():
        print(json.dumps({"variant": name, "max_abs_diff_from_base": [
            (g - w).abs().max().item()
            for g, w in zip(got, outs["base"])]}), flush=True)

    def sample(fn, n=3):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    names = list(libs)
    times = {(n, w): [] for n in names for w in ("fwd", "dkv")}
    for r in range(8):
        for n in (names if r % 2 == 0 else names[::-1]):
            o, lse, dk, dv = outs[n]
            times[n, "fwd"].append(sample(lambda: fwd(libs[n], o, lse)))
            times[n, "dkv"].append(sample(
                lambda: dkv(libs[n], base_lse, dsum, dk, dv)))
    for (n, w), t in times.items():
        print(json.dumps({"variant": n, "kernel": w,
                          "median_ms": statistics.median(t), "min": min(t),
                          "max": max(t)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
