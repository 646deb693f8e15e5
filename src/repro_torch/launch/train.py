"""Training driver: data pipeline -> train_step -> checkpoints
(``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Runs on the card unless ``--device cpu`` is given. Restart-safe: if
``--ckpt-dir`` holds a checkpoint, training resumes from it, with the
parameters, the optimizer state and the step generator's state, so the
resumed steps are the uninterrupted run's. A checkpoint written under other
settings (arch, widths, batch, sequence, learning rate, microbatches,
compression, dtype, device type) is refused; ``--steps`` may change, as in
the reference (it also sets the schedule's length). Checkpoints are written
synchronously.

The weights come from a ``torch.Generator`` seeded 0 on the device; the
batches from ``TokenStream`` (numpy), so both packages train on the same
tokens; an encoder-decoder model also gets stub frames from
``np.random.default_rng(step)``. The GQA layers run ``_sdpa``, as the
reference's training does (``gqa_apply`` without ``allow_flash``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import build
from repro_torch.models.common import DTYPES
from repro_torch.runtime.device import make_generator, resolve_device
from repro_torch.train import (OptimizerConfig, TrainState,
                               abstract_train_state, init_train_state,
                               make_train_step)


def _ckpt_tree(state: TrainState, settings: str) -> dict:
    tree = {"params": state.params, "opt": state.opt, "rng": state.rng,
            "settings": settings}
    if state.error is not None:
        tree["error"] = state.error
    return tree


def batch_at(cfg, stream: TokenStream, step: int, batch: int, device):
    """Step ``step``'s batch on ``device``: the stream's tokens and, for an
    encoder-decoder model, frames from ``default_rng(step)`` in the model's
    type."""
    out = {"tokens": torch.from_numpy(stream.batch_at(step)).to(device)}
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(step)
        frames = rng.normal(size=(batch, cfg.encoder_seq_len, cfg.d_model))
        out["frames"] = torch.from_numpy(frames.astype(np.float32)).to(
            device=device, dtype=DTYPES[cfg.dtype])
    return out


def train_loop(arch: str, *, reduced: bool = True, steps: int = 100,
               batch: int = 8, seq: int = 128, lr: float = 3e-4,
               microbatches: int = 1, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, use_compression: bool = False,
               log_every: int = 10, dtype: Optional[str] = None,
               printer=print, device="cuda"):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint). Returns (state, losses of the steps run here)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build(cfg, dev)
    oc = OptimizerConfig(learning_rate=lr, total_steps=steps,
                         warmup_steps=max(steps // 20, 5),
                         schedule=cfg.schedule)
    settings = json.dumps(dict(
        arch=arch, reduced=reduced, batch=batch, seq=seq, lr=lr,
        microbatches=microbatches, compression=use_compression,
        dtype=cfg.dtype, device=dev.type), sort_keys=True)

    # ---- init or restore -------------------------------------------------
    start_step = 0
    if ckpt_dir and (last := checkpoint.latest_step(ckpt_dir)) is not None:
        # the saved tree holds error buffers iff that run compressed: the
        # settings check below names the difference
        was_compressed = any(k.startswith("error.") for k in
                             checkpoint.saved_leaves(ckpt_dir, last))
        like = _ckpt_tree(abstract_train_state(model, was_compressed), None)
        saved = checkpoint.restore(ckpt_dir, last, like, device=dev)
        checkpoint.require_settings(ckpt_dir, saved["settings"].item(),
                                    settings)
        state = TrainState(saved["params"], saved["opt"],
                           saved["rng"].cpu(), saved.get("error"))
        start_step = last
        printer(f"[train] resumed from step {last} (mesh {{'data': 1}})")
    else:
        state = init_train_state(model, make_generator(0, dev),
                                 use_compression)

    # ---- data -------------------------------------------------------------
    stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch))

    # ---- step -------------------------------------------------------------
    step_fn = make_train_step(model, oc, microbatches, use_compression)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        state, metrics = step_fn(state, batch_at(cfg, stream, step, batch,
                                                 dev))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            printer(f"[train] step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f} "
                    f"({dt:.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, _ckpt_tree(state, settings))
    if ckpt_dir:
        if steps % ckpt_every != 0 or start_step >= steps:
            checkpoint.save(ckpt_dir, steps, _ckpt_tree(state, settings))
        checkpoint.prune(ckpt_dir, keep=3)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_loop(args.arch, reduced=args.reduced, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, use_compression=args.compression,
               dtype=args.dtype, device=args.device)


if __name__ == "__main__":
    main()
