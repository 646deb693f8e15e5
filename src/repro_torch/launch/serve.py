"""Serving driver: batched generation with a randomly initialised model
(``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 4 --prompt-len 16 --new-tokens 24

Runs on the card unless ``--device cpu`` is given. Throughput is reported
from a warm ``generate``; the first one (cold) is reported separately, as
the reference does, though nothing is compiled here: it pays the first
launches and the allocator's growth. Both times are taken after
``torch.cuda.synchronize()`` on the card.

The prompts (and whisper's stub frames) come from
``np.random.default_rng(0)`` as in the reference, so both packages serve
the same prompts; the weights come from a ``torch.Generator`` seeded 0 on
the device. The GQA layers run ``_sdpa`` (``use_flash_kernel=False``), as
the reference's serving does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.runtime.device import make_generator, resolve_device
from repro_torch.serve import ServeConfig, generate


def setup(arch: str, *, reduced=True, batch=4, prompt_len=16,
          new_tokens=24, temperature=0.0, dtype="float32", device="cuda"):
    """What ``serve_once`` serves: (model, params, prompts, frames, sc)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dtype=dtype,
                              use_flash_kernel=False)
    model = build(cfg, dev)
    params, _ = model.init(make_generator(0, dev))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.normal(
            size=(batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).to(dev)
    sc = ServeConfig(max_new_tokens=new_tokens, temperature=temperature)
    return model, params, prompts, frames, sc


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_once(arch: str, *, reduced=True, batch=4, prompt_len=16,
               new_tokens=24, temperature=0.0, dtype="float32",
               printer=print, device="cuda"):
    """One cold + one warm batched generation. Returns ``(tokens, stats)``
    with ``cold_s``, ``warm_s``, ``tok_s_warm`` and ``tok_s_cold``."""
    dev = resolve_device(device)
    model, params, prompts, frames, sc = setup(
        arch, reduced=reduced, batch=batch, prompt_len=prompt_len,
        new_tokens=new_tokens, temperature=temperature, dtype=dtype,
        device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    generate(model, params, prompts, sc, frames=frames)
    _sync(dev)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = generate(model, params, prompts, sc, frames=frames)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    stats = {"cold_s": cold_s, "warm_s": warm_s,
             "tok_s_warm": batch * new_tokens / warm_s,
             "tok_s_cold": batch * new_tokens / cold_s}
    printer(f"[serve] {arch}: {batch}x{new_tokens} tokens in {warm_s:.2f}s "
            f"warm ({stats['tok_s_warm']:.1f} tok/s; cold {cold_s:.2f}s, "
            f"{stats['tok_s_cold']:.1f} tok/s) on {dev}")
    return out.cpu().numpy(), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out, _stats = serve_once(args.arch, reduced=args.reduced,
                             batch=args.batch, prompt_len=args.prompt_len,
                             new_tokens=args.new_tokens,
                             temperature=args.temperature,
                             device=args.device)
    print(out)


if __name__ == "__main__":
    main()
