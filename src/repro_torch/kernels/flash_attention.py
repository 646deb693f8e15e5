"""Python wrapper of the flash-attention forward kernel (B8,
``csrc/flash.cu``): causal or non-causal online-softmax attention with GQA
in the reference's (B, H, S, D) layout, and the checks that the B9 wrappers
in ``flash_attention_bwd`` share.

The wrapper takes CUDA tensors only and launches the kernel or raises; the
CPU path is ``ref.flash_attention_ref``, chosen by ``kernels.ops``. As in
the reference, B8 has no backward: the wrapper raises when grad mode is on
and an input requires grad (``ops.flash_attention_gqa_diff`` is the
differentiable variant). Each wrapper counts its launches in
``<fn>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)        # the head dims the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def launchers():
    """(library, forward, dQ, dK/dV) C entries of ``csrc/flash.cu``."""
    lib = build.load("flash")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # b, h, kh, s, d, bf16, causal; scale; stream
    tail = [i32] * 7 + [ctypes.c_float, ptr]
    fwd = lib.flash_fwd_launch
    fwd.argtypes = [ptr] * 5 + tail
    dq = lib.flash_dq_launch
    dq.argtypes = [ptr] * 7 + tail
    dkv = lib.flash_dkv_launch
    dkv.argtypes = [ptr] * 8 + tail
    for fn in (fwd, dq, dkv):
        fn.restype = ctypes.c_int
    return lib, fwd, dq, dkv


def check_not_differentiated(*tensors) -> None:
    """Raise where the reference has no vjp: grad mode on and an input that
    requires grad (the result would be cut from the graph)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention (B8) has no backward, as in the reference; "
            "use ops.flash_attention_gqa_diff to differentiate, or call it "
            "under torch.no_grad()")


def check_contract(q, k, v, block_q: int, block_k: int) -> None:
    """The reference's shape contract (``flash_attention.py:81-88``): q
    (B, H, S, D), k and v (B, KH, S, D) with H % KH == 0 and S a multiple
    of min(block, S) for both blocks. Raises ValueError where the reference
    asserts. The kernels use their own tiles (64 or 128 rows) whatever the
    blocks are."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"need q (B, H, S, D) and k, v (B, KH, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if kh == 0 or h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if block < 1 or s % min(block, s):
            raise ValueError(f"sequence {s} not a multiple of "
                             f"{name} = min({block}, {s})")


def check_kernel_inputs(name, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device in one of the
    kernels' types with a head dim they are built for."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} needs every input on {q.device} in "
                             f"{q.dtype}, got {t.dtype} on {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name} is built for head dims {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")


def aligned(t):
    """``t`` contiguous with its data on a 16-byte boundary, as the kernels
    copy rows 16 bytes at a time (cp.async, TMA): a copy where a view
    starts off one."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def problem(q, k, causal: bool) -> tuple:
    """The trailing C arguments (b, h, kh, s, d, bf16, causal, scale,
    stream) of a launch on q's device."""
    b, h, s, d = q.shape
    return (b, h, k.shape[1], s, d, int(q.dtype == torch.bfloat16),
            int(bool(causal)), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)


def launch_forward(name, q, k, v, causal, block_q, block_k, with_lse):
    """Check the inputs and launch the forward kernel: -> (out (B, H, S, D)
    in q's type, lse (B, H, S) f32 or None when not ``with_lse``)."""
    check_not_differentiated(q, k, v)
    check_contract(q, k, v, block_q, block_k)
    check_kernel_inputs(name, q, k, v)
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32,
                      device=q.device) if with_lse else None
    lib, fwd, _, _ = launchers()
    with torch.cuda.device(q.device):
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  *problem(q, k, causal))
    build.check(lib, err, f"{name} launch")
    return out, lse


def flash_attention(q, k, v, *, causal=True, block_q=512, block_k=512):
    """q (B, H, S, D), k and v (B, KH, S, D) CUDA tensors, float32 or
    bfloat16, D in ``HEAD_DIMS`` -> attention output (B, H, S, D) in q's
    type: softmax(q k^T / sqrt(D)) v per q-head, q-head h reading kv head
    h // (H / KH), sums in f32."""
    out, _ = launch_forward("flash_attention", q, k, v, causal, block_q,
                            block_k, with_lse=False)
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
