"""Build the CUDA sources under ``repro_torch/csrc`` into shared libraries
and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <name>-<hash>.so csrc/<name>.cu

into ``repro_torch/_build/`` (listed in ``.gitignore``). The file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as it is. ``build()`` starts one ``nvcc`` per
source, all at once, and waits for them; ``load()`` builds on first use.
ptxas's register and shared-memory report lands beside each library as
``<name>-<hash>.log``.

Every C entry returns ``cudaGetLastError()`` after its launch; the Python
wrappers raise when it is not 0, and count each launch through
``count_launch``.

Thread safety: the environment pool calls kernels from several threads at
once. ``load`` builds and loads under one lock, so a fresh build directory
sees one ``nvcc`` per source however many threads ask; a build's temporary
file carries the process and thread ids; launch counts change under one
lock, so they are exact after a pool run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("cholesky", "diffusion", "dominance", "flash", "gp", "trisolve")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Shared memory on an H100 (sm_90): what one block may take as dynamic
# shared memory, what one SM holds, and what the runtime keeps per block
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, the toolkit's
    default install, or ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit on PATH to build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source in ``names`` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns the
    wall seconds each build took (0.0 for a library already built).
    Raises with the compiler's output if any build fails."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    secs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(
            f".tmp{os.getpid()}_{threading.get_ident()}.so")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """ptxas/nvcc output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel_resources(log: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    and "static_smem_bytes" where the kernel declares shared memory}} from
    ptxas's -v report (``build_log``)."""
    out: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["static_smem_bytes"] = int(m.group(1))
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``name`` (the toolkit's
    cuobjdump beside nvcc)."""
    tool = Path(nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_counts(text: str, opcodes: Iterable[str]) -> Dict[str, dict]:
    """{mangled kernel name: {opcode: instructions}} over the functions of
    a ``cuobjdump -sass`` listing; an opcode counts the instructions whose
    mnemonic is it or starts with it and a dot (HMMA.16816...)."""
    opcodes = tuple(opcodes)
    out: Dict[str, dict] = {}
    counts = None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            counts = out.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and counts is not None:
            mnemonic = m.group(1).split(".")[0]
            if mnemonic in counts:
                counts[mnemonic] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (by
    one thread, however many ask at once)."""
    with _LOAD_LOCK:
        if name not in _LOADED:
            path = library_path(name)
            if not path.exists():
                build([name])
            _LOADED[name] = ctypes.CDLL(str(path))
        return _LOADED[name]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel
    wrapper, under the module's lock (a bare ``+= 1`` loses updates when
    pool threads launch at once)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def set_launch_count(wrapper, value: int = 0) -> None:
    """Set a wrapper's launch count under the same lock."""
    with _COUNT_LOCK:
        wrapper.launches = value


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
