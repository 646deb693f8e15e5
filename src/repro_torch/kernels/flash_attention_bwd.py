"""Python wrappers of the flash-attention kernels of B9 (``csrc/flash.cu``):
the forward that also returns the row logsumexp, the dQ kernel and the dK/dV
kernel, and ``flash_attention_diff``, the ``torch.autograd.Function`` that
takes the place of the reference's ``custom_vjp``
(``repro.kernels.flash_attention_bwd``, lines 278-305).

The Dao backward (the reference's docstring):
    L  = m + log(l)                 (forward, per row)
    D  = rowsum(dO * O)             (per row; O after its cast to q's type)
    P  = exp(Q K^T * scale - L)
    dV = P^T dO,  dS = P * (dO V^T - D)
    dQ = dS K * scale,  dK = dS^T Q * scale
dK and dV come out per q-head, (B, H, S, D); the GQA group-sum to
(B, KH, S, D) stays outside the kernels, as in the reference.

The kernel wrappers take CUDA tensors only and launch or raise; each counts
its launches in ``<fn>.launches``. ``flash_attention_diff`` routes a CPU
tensor to the plain versions (``ref.flash_attention_fwd_ref`` and
``ref.flash_attention_bwd_ref``) and any other tensor to the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (aligned, check_contract,
                                                 check_kernel_inputs,
                                                 check_not_differentiated,
                                                 launch_forward, launchers,
                                                 problem)


def flash_attention_fwd(q, k, v, *, causal=True, block_q=512, block_k=512):
    """(B, H, S, D) q and (B, KH, S, D) k, v CUDA tensors -> (out
    (B, H, S, D) in q's type, lse (B, H, S) f32), lse = m + log(max(l,
    1e-30)) of each row's running max m and denominator l."""
    out, lse = launch_forward("flash_attention_fwd", q, k, v, causal,
                              block_q, block_k, with_lse=True)
    build.count_launch(flash_attention_fwd)
    return out, lse


def _launch_bwd(name, entry, n_out, q, k, v, do, lse, dsum, causal):
    """Check the inputs of a backward kernel (q, k, v, dO on one CUDA
    device in one type; lse and dsum f32 (B, H, S)), launch C entry
    ``entry`` of ``launchers()`` into ``n_out`` new (B, H, S, D) outputs in
    q's type, and return them."""
    check_not_differentiated(q, k, v, do)
    check_contract(q, k, v, 1, 1)
    check_kernel_inputs(name, q, k, v, do)
    for what, t in (("lse", lse), ("dsum", dsum)):
        if t.dtype != torch.float32 or t.shape != q.shape[:3] \
                or t.device != q.device:
            raise ValueError(f"{what} must be f32 {tuple(q.shape[:3])} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    q, k, v, do = (aligned(t) for t in (q, k, v, do))
    lse, dsum = lse.contiguous(), dsum.contiguous()
    outs = [torch.empty_like(q) for _ in range(n_out)]
    lib, fn = launchers()[0], launchers()[entry]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dsum.data_ptr(),
                 *(o.data_ptr() for o in outs), *problem(q, k, causal))
    build.check(lib, err, f"{name} launch")
    return outs


def flash_attention_dq(q, k, v, do, lse, dsum, *, causal=True):
    """dQ (B, H, S, D) in q's type from q, k, v, dO (CUDA, one type), the
    forward's lse and dsum = rowsum(dO * O), both f32 (B, H, S)."""
    dq, = _launch_bwd("flash_attention_dq", 2, 1, q, k, v, do, lse, dsum,
                      causal)
    build.count_launch(flash_attention_dq)
    return dq


def flash_attention_dkv(q, k, v, do, lse, dsum, *, causal=True):
    """Per-q-head (dK_h, dV_h), each (B, H, S, D) in q's type, from the
    same inputs as ``flash_attention_dq``."""
    dk, dv = _launch_bwd("flash_attention_dkv", 3, 2, q, k, v, do, lse,
                         dsum, causal)
    build.count_launch(flash_attention_dkv)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, block_q=512,
                        block_k=512):
    """(dq (B, H, S, D), dk_h (B, H, S, D), dv_h (B, H, S, D)): per-q-head
    dK/dV; the GQA group-sum happens in the caller. dsum is taken in f32
    from dO and the cast ``out``, outside the kernels, as the reference
    does (``flash_attention_bwd.py:219``)."""
    check_contract(q, k, v, block_q, block_k)
    dsum = (do.float() * out.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, causal=causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, causal=causal)
    return dq, dk, dv


class FlashAttentionDiff(torch.autograd.Function):
    """Differentiable flash attention on (B, H, S, D): the forward saves q,
    k, v, out and lse; the backward runs the dQ and dK/dV kernels (the
    plain versions for CPU tensors) and group-sums dK/dV per kv head."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        if q.device.type == "cpu":
            out, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if q.device.type == "cpu":
            dq, dk_h, dv_h = ref.flash_attention_bwd_ref(
                q, k, v, out, lse, do, causal=ctx.causal)
        else:
            dq, dk_h, dv_h = flash_attention_bwd(q, k, v, out, lse, do,
                                                 causal=ctx.causal)
        # GQA: sum the per-q-head contributions within each kv group
        b, h, s, d = q.shape
        kh = k.shape[1]
        dk = dk_h.reshape(b, kh, h // kh, s, d).sum(2).to(k.dtype)
        dv = dv_h.reshape(b, kh, h // kh, s, d).sum(2).to(v.dtype)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q, k, v, causal=True, block_q=512, block_k=512):
    """Differentiable flash attention, (B, H, S, D) layout, the reference's
    shape contract."""
    check_contract(q, k, v, block_q, block_k)
    return FlashAttentionDiff.apply(q, k, v, causal, block_q, block_k)


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
