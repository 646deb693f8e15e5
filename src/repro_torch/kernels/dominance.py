"""Python wrappers of the Pareto-dominance CUDA kernels
(``csrc/dominance.cu``): the fused ``dominance_pass`` (counts + packed
bitmap, with same-group masking) and the counts-only ``dominated_counts``.

The wrappers take CUDA tensors only and launch their kernel or raise; the CPU
path is ``ref.dominance_pass_ref`` / ``ref.dominated_counts_ref``, chosen by
``kernels.ops``. Each wrapper counts its launches in ``<fn>.launches``.
The bitmap is int32 words carrying the reference's u32 bits (see ref.py).

A block takes a tile of ``TILE_ROWS`` rows against a split of the column
words, in passes of ``PASS_WORDS`` words; ``launch_config`` chooses the
splits from the shapes and the card's SM count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import statistics

import torch

from repro_torch.kernels import build

TILE_ROWS = 128       # csrc/dominance.cu: 32 lanes x 4 rows a thread
PASS_WORDS = 8        # one 32-column word a warp, 8 warps
THREADS = 256
MAX_GRID_Y = 65535
BLOCKS_PER_SM = 2     # blocks a split aims to keep on each SM at once
UNROLLED_M = 8        # M = 1..8 have their own kernels; larger M the generic


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    row_tiles: int     # blocks along the rows (grid x)
    words: int         # bitmap words a row, ceil(Nj / 32)
    splits: int        # blocks along the column words (grid y)
    split_words: int   # words a split takes, a multiple of PASS_WORDS
    col_stride: int    # floats a staged column takes (0: generic M)
    threads: int = THREADS

    @property
    def grid(self) -> tuple:
        return (self.row_tiles, self.splits)


@functools.lru_cache(maxsize=256)
def launch_config(ni: int, nj: int, m: int, sms: int) -> LaunchConfig:
    """The launch of an (ni, m) x (nj, m) sweep on a card of ``sms`` SMs.
    Each block walks ``split_words`` words in passes of PASS_WORDS; the
    splits minimise (waves of BLOCKS_PER_SM blocks an SM) x (passes a
    block + one pass of fixed cost), plus one for the memset that more
    than one split needs; ties go to fewer splits."""
    row_tiles = -(-ni // TILE_ROWS)
    words = -(-nj // 32)
    passes = -(-words // PASS_WORDS)
    slots = BLOCKS_PER_SM * sms
    most = max(1, min(passes, MAX_GRID_Y, -(-2 * slots // max(row_tiles, 1))))
    best = None
    for splits in range(1, most + 1):
        per = -(-passes // splits)
        if splits > 1 and -(-passes // per) != splits:
            continue                    # fewer splits cover the same passes
        cost = -(-row_tiles * splits // slots) * (per + 1) + (splits > 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    stride = 0 if not 1 <= m <= UNROLLED_M else (m if m <= 2 else
                                                  4 if m <= 4 else 8)
    return LaunchConfig(row_tiles, words, splits, per * PASS_WORDS, stride)


_ARGTYPES = {
    "dominance_pass_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p] * 3,
    "dominated_counts_launch": [ctypes.c_void_p] + [ctypes.c_int] * 4
                               + [ctypes.c_void_p] * 2,
    "dominance_pass_phases_launch": [ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p] * 4,
    "dominance_probe_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int] + [ctypes.c_void_p] * 4,
}

# csrc/dominance.cu's kPhases, in order
PHASES = ("entry", "rows_loaded", "pass0_staged", "pass0_computed",
          "pass0_stored", "passes_done", "counts_summed", "exit")


@functools.cache
def _launcher(name):
    lib = build.load("dominance")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_objectives(name, x, device, m=None):
    if x.device != device or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous() or (m is not None and x.shape[1] != m):
        raise ValueError(f"{name} must be contiguous f32 (N, M) on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_groups(name, g, n, device):
    if g is None:
        return 0
    if g.device != device or g.dtype != torch.int32 or tuple(g.shape) != (n,) \
            or not g.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 ({n},) on "
                         f"{device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    return g.data_ptr()


def _require_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {x.device}")


def dominance_pass(rows, cols=None, groups=None, groups_cols=None):
    """One fused O(Ni*Nj) sweep of ``rows`` (candidates) against ``cols``
    (potential dominators); ``cols=None`` is the square self-sweep. Group
    ids (int32) restrict dominance to same-group pairs; a missing side is
    group 0. Returns (counts (Ni,) i32, bitmap (Ni, ceil(Nj/32)) int32)."""
    _require_cuda(rows, "dominance_pass")
    if cols is None:
        cols, groups_cols = rows, groups
    dev = rows.device
    _check_objectives("rows", rows, dev)
    _check_objectives("cols", cols, dev, rows.shape[1])
    ni, m = rows.shape
    nj = cols.shape[0]
    g_rows = _check_groups("groups", groups, ni, dev)
    g_cols = _check_groups("groups_cols", groups_cols, nj, dev)
    cfg = launch_config(ni, nj, m, build.sm_count(dev.index))
    counts = torch.empty((ni,), dtype=torch.int32, device=dev)
    bitmap = torch.empty((ni, cfg.words), dtype=torch.int32, device=dev)
    lib, fn = _launcher("dominance_pass_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), g_rows, g_cols, ni, nj, m,
                 cfg.splits, cfg.split_words, counts.data_ptr(),
                 bitmap.data_ptr(), stream)
    build.check(lib, err, "dominance_pass launch")
    build.count_launch(dominance_pass)
    return counts, bitmap


def dominated_counts(objectives):
    """(N, M) f32 CUDA (inactive rows pre-masked to +BIG) -> (N,) i32
    dominated counts."""
    _require_cuda(objectives, "dominated_counts")
    dev = objectives.device
    _check_objectives("objectives", objectives, dev)
    n, m = objectives.shape
    cfg = launch_config(n, n, m, build.sm_count(dev.index))
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    lib, fn = _launcher("dominated_counts_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(objectives.data_ptr(), n, m, cfg.splits, cfg.split_words,
                 counts.data_ptr(), stream)
    build.check(lib, err, "dominated_counts launch")
    build.count_launch(dominated_counts)
    return counts


def pass_phase_cycles(rows, groups=None) -> dict:
    """One square ``dominance_pass`` of ``rows`` that also records the SM
    clock of block (0, 0) at each of PHASES, per warp, and every block's SM
    and global-timer entry and exit: -> {phase: [cycles since the earliest
    warp's entry, warp 0..7], "blocks": {"n", "most_on_one_sm", "span_us",
    "block_us" (median, max), "last_entry_us"}}. Not a wrapper of the main
    path: it counts no launch."""
    _require_cuda(rows, "pass_phase_cycles")
    dev = rows.device
    _check_objectives("rows", rows, dev)
    ni, m = rows.shape
    g = _check_groups("groups", groups, ni, dev)
    cfg = launch_config(ni, ni, m, build.sm_count(dev.index))
    counts = torch.empty((ni,), dtype=torch.int32, device=dev)
    bitmap = torch.empty((ni, cfg.words), dtype=torch.int32, device=dev)
    n_blocks = cfg.row_tiles * cfg.splits
    phases = torch.zeros((len(PHASES) * PASS_WORDS + 3 * n_blocks,),
                         dtype=torch.int64, device=dev)
    lib, fn = _launcher("dominance_pass_phases_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), rows.data_ptr(), g, g, ni, ni, m,
                 cfg.splits, cfg.split_words, counts.data_ptr(),
                 bitmap.data_ptr(), phases.data_ptr(), stream)
    build.check(lib, err, "dominance_pass phases launch")
    clocks = phases[:len(PHASES) * PASS_WORDS].view(len(PHASES), PASS_WORDS)
    out = dict(zip(PHASES, (clocks - clocks[0].min()).tolist()))
    blocks = phases[len(PHASES) * PASS_WORDS:].view(n_blocks, 3)
    t0 = blocks[:, 1].min()
    took = (blocks[:, 2] - blocks[:, 1]).double() / 1e3
    out["blocks"] = {
        "n": n_blocks,
        "most_on_one_sm": int(blocks[:, 0].bincount().max()),
        "span_us": (blocks[:, 2].max() - t0).item() / 1e3,
        "block_us": [took.median().item(), took.max().item()],
        "last_entry_us": (blocks[:, 1].max() - t0).item() / 1e3}
    return out


def issue_probe(subtract: bool, passes: int = 4096) -> dict:
    """Pair tests a second and a cycle of an SM in B2's inner loop at M = 3
    (``subtract``: the float subtractions the kernels run; else the
    same pairs as float compares), from 256 staged columns and 4 rows a
    thread in registers, with no memory traffic in the loop: the issue
    floor of the sweep. One launch of as many 256-thread blocks as the
    card holds at once. Each SM's cycles are the span of its blocks' loops
    on its cycle counter, and its clock that span over the same span on
    the global timer. Not a wrapper of the main path: it counts no
    launch."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = build.sm_count(dev.index)
    obj = torch.rand((256, 3), generator=torch.Generator(dev).manual_seed(0),
                     device=dev)
    grid = ctypes.c_int(0)
    lib, fn = _launcher("dominance_probe_launch")
    stream = torch.cuda.current_stream().cuda_stream
    build.check(lib, fn(int(subtract), obj.data_ptr(), passes, sms, 0, 0,
                        ctypes.addressof(grid), stream), "probe occupancy")
    trace = torch.zeros((grid.value, 5), dtype=torch.int64, device=dev)
    sink = torch.empty((grid.value * THREADS,), dtype=torch.int32, device=dev)

    def run():
        build.check(lib, fn(int(subtract), obj.data_ptr(), passes, sms,
                            trace.data_ptr(), sink.data_ptr(),
                            ctypes.addressof(grid), stream), "probe launch")
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    spans = []
    for sm in trace[:, 0].unique().tolist():
        t = trace[trace[:, 0] == sm]
        spans.append(((t[:, 2].max() - t[:, 1].min()).item(),
                      (t[:, 4].max() - t[:, 3].min()).item()))
    cycles = sorted(c for c, _ in spans)[len(spans) // 2]
    pairs = grid.value * THREADS * 4 * 32 * passes
    return {"blocks": grid.value, "blocks_per_sm": grid.value // sms,
            "ms": ms, "pairs_per_s": pairs / (ms * 1e-3),
            "sm_clock_ghz": statistics.median(c / n for c, n in spans),
            "pairs_per_sm_clock": pairs / sms / cycles}


dominance_pass.launches = 0
dominated_counts.launches = 0
