"""Batched serving engine (``repro.serve.engine``): prefill a batch of
prompts, then decode steps with greedy or temperature sampling.

Continuous-batching-lite: finished sequences (EOS) are masked and their
slots keep decoding pad tokens without affecting others.

The first post-prefill token goes through the same sampling path as every
decode step: it is drawn with the configured temperature, and it is
EOS-masked, so a prefill that emits ``eos_id`` finishes the sequence at
once.

Sampling is split into a draw and an apply: ``draw_gumbel`` draws Gumbel
noise from a ``torch.Generator`` on the logits' device, and
``sample_token`` takes ``argmax(logits / T + noise)``, which is what the
reference's ``jax.random.categorical`` computes from its key. A test can
replay the reference's own noise through ``draw_gumbel``.

Nothing is traced or compiled: prefill and decode run eagerly, so the
reference's cache of compiled programs (``_compiled``) has no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime.device import make_generator


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    eos_id: int = -1              # -1 => never stop early
    pad_id: int = 0


def draw_gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise, f32: -log(-log(u)), u uniform in [tiny, 1)
    (``jax.random.gumbel``'s form)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device).clamp_min_(tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits, sc: ServeConfig, noise=None):
    """One token per row of (B, V) logits: argmax, or at temperature T > 0
    argmax(logits / T + noise) with ``noise`` from ``draw_gumbel``. The
    first token and every decode step share it."""
    if sc.temperature > 0:
        return torch.argmax(logits / sc.temperature + noise, dim=-1)
    return torch.argmax(logits, dim=-1)


def _sample(logits, sc, generator):
    noise = None
    if sc.temperature > 0:
        noise = draw_gumbel(logits.shape, generator, logits.device)
    return sample_token(logits, sc, noise)


def make_prefill_step(model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model, sc: ServeConfig):
    def decode_step(params, carry):
        cache, token, positions, generator, done = carry
        logits, cache = model.decode(
            params, {"token": token, "positions": positions}, cache)
        nxt = _sample(logits[:, -1], sc, generator)
        done = done | (nxt == sc.eos_id)
        nxt = torch.where(done, sc.pad_id, nxt)
        return (cache, nxt[:, None], positions + 1, generator, done), nxt
    return decode_step


@torch.inference_mode()
def generate(model, params, prompts, sc: ServeConfig, *, max_seq=None,
             frames=None, generator=None):
    """prompts: (B, S) int. Returns (B, max_new_tokens) int64 tokens.
    ``generator`` draws the sampling noise (default: seed 0 on the
    prompts' device); greedy decoding draws nothing."""
    b, s = prompts.shape
    max_seq = max_seq or (s + sc.max_new_tokens)
    cache, _ = model.init_cache(b, max_seq)
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = make_prefill_step(model)(params, batch, cache)
    if generator is None:
        generator = make_generator(0, prompts.device)
    first = _sample(logits[:, -1], sc, generator)
    done = first == sc.eos_id
    first = torch.where(done, sc.pad_id, first)

    decode = make_decode_step(model, sc)
    carry = (cache, first[:, None],
             torch.full((b,), s, dtype=torch.long, device=prompts.device),
             generator, done)
    tokens = [first]
    for _ in range(sc.max_new_tokens - 1):
        carry, nxt = decode(params, carry)
        tokens.append(nxt)
    return torch.stack(tokens, dim=1)


@torch.inference_mode()
def teacher_forced_logits(model, params, prompts, tokens, *, frames=None,
                          max_seq=None):
    """The f32 logits (N, B, V) that decide each of ``tokens`` (B, N) when
    those tokens are fed back one at a time: step 0 is prefill's last
    position, step t the decode of ``tokens[:, t - 1]``. On the tokens
    ``generate`` returned, they are the logits it sampled from."""
    b, s = prompts.shape
    n = tokens.shape[1]
    cache, _ = model.init_cache(b, max_seq or (s + n))
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = model.prefill(params, batch, cache)
    out = [logits[:, -1]]
    for t in range(n - 1):
        logits, cache = model.decode(
            params, {"token": tokens[:, t:t + 1],
                     "positions": torch.full((b,), s + t, dtype=torch.long,
                                             device=prompts.device)}, cache)
        out.append(logits[:, -1])
    return torch.stack(out)
