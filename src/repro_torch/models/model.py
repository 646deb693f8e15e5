"""Unified model API used by training and serving (``repro.models.model``).

``Model(cfg, device)`` dispatches decoder-only vs encoder-decoder assemblies
and exposes:
  init(generator) / abstract_init()   -> (params, axes); abstract: meta
  loss(params, batch, generator)      -> (loss, metrics)
  init_cache(batch, max_seq)          -> (caches, axes)
  prefill(params, batch, caches)      -> (last-position logits, caches)
  decode(params, batch, caches)       -> (logits, caches)
``params_from_arrays`` carries the reference's initialised weights into the
port's tree. The dry-run's ``abstract_cache``, ``input_specs`` and
``batch_axes`` come with their caller.

Cross-entropy is computed in token chunks, each chunk's logits under
``torch.utils.checkpoint``, so the (tokens, vocab) f32 logits are never
kept for the backward pass at full size.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import DTYPES, carry


CE_CHUNK = 1024     # tokens per cross-entropy chunk


def _dtype(cfg):
    return DTYPES[cfg.dtype]


def _xent_chunk(h, tg, weight, transpose_weight, vocab_mask):
    """One chunk's (sum of CE, sum of lse^2, count of valid targets). The
    product runs in the weight's type, then f32, as the reference's einsum
    followed by ``.astype(f32)``."""
    if transpose_weight:
        logits = torch.einsum("cd,vd->cv", h, weight)
    else:
        logits = h @ weight
    logits = logits.float()
    if vocab_mask is not None:
        logits = logits.masked_fill(vocab_mask, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, tg.clamp_min(0)[:, None])[:, 0]
    valid = (tg >= 0).float()
    return (((lse - tgt) * valid).sum(), (lse.square() * valid).sum(),
            valid.sum())


def chunked_softmax_xent(hidden, weight, targets, transpose_weight,
                         z_loss_coef=1e-4, vocab_size=None,
                         ce_chunk=CE_CHUNK):
    """Mean CE over tokens, computed in chunks. hidden: (T,d) any float
    type, weight: (d,V) or (V,d) if transpose_weight; targets: (T,) int,
    -1 = ignored. vocab_size: logical vocab; padded slots beyond it are
    masked with -1e30. Returns (CE + z_loss_coef * mean lse^2, count)."""
    t, d = hidden.shape
    chunk = min(ce_chunk, t)
    pad = (-t) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    n = hidden.shape[0] // chunk
    hidden = hidden.reshape(n, chunk, d)
    targets = targets.reshape(n, chunk)
    v_padded = weight.shape[0] if transpose_weight else weight.shape[-1]
    vocab_mask = None
    if vocab_size is not None and vocab_size < v_padded:
        vocab_mask = torch.arange(v_padded,
                                  device=hidden.device) >= vocab_size
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    loss_sum, z_sum, count = zero, zero, zero
    for i in range(n):
        args = (hidden[i], targets[i], weight, transpose_weight, vocab_mask)
        if torch.is_grad_enabled():
            part = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            part = _xent_chunk(*args)
        loss_sum = loss_sum + part[0]
        z_sum = z_sum + part[1]
        count = count + part[2]
    count = count.clamp_min(1.0)
    return loss_sum / count + z_loss_coef * z_sum / count, count


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def _assembly(self):
        return encdec if self.cfg.is_encoder_decoder else transformer

    # ------------------------------------------------------------------ init
    def init(self, generator):
        """(params, axes); ``generator`` must draw on ``self.device``."""
        return self._assembly().init_params(self.cfg, generator,
                                            _dtype(self.cfg), self.device)

    def abstract_init(self):
        """(params, axes) with every tensor on the meta device: the tree's
        names, shapes and types without memory."""
        return Model(self.cfg, "meta").init(None)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, generator=None):
        """batch: {"tokens": (B, S+1) int, and for an encoder-decoder
        "frames" (B, enc_seq, d)}. Returns (loss, metrics): the mean
        next-token CE plus its z-loss, plus the MoE's load-balance loss;
        metrics ``ce``, ``tokens``, ``load_balance_loss``,
        ``dropped_frac`` (f32 scalars). ``generator`` draws the MoE's
        router jitter (off in every config)."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(cfg, params, batch["frames"])
            hidden, _ = encdec.decode_full(cfg, params, inputs, enc_out)
            zero = torch.zeros((), dtype=torch.float32,
                               device=hidden.device)
            aux = {"load_balance_loss": zero, "dropped_frac": zero}
            weight, transpose = params["embed"], True
        else:
            hidden, aux, _ = transformer.forward(cfg, params, inputs,
                                                 generator)
            if cfg.tie_embeddings:
                weight, transpose = params["embed"], True
            else:
                weight, transpose = params["unembed"], False
        b, s, d = hidden.shape
        ce, count = chunked_softmax_xent(
            hidden.reshape(b * s, d), weight, targets.reshape(b * s),
            transpose, vocab_size=cfg.vocab_size, ce_chunk=cfg.ce_chunk)
        loss = ce + aux["load_balance_loss"]
        metrics = {"ce": ce, "tokens": count,
                   "load_balance_loss": aux["load_balance_loss"],
                   "dropped_frac": aux["dropped_frac"]}
        return loss, metrics

    # --------------------------------------------------------------- serving
    @torch.inference_mode()
    def init_cache(self, batch, max_seq):
        return self._assembly().init_cache(self.cfg, batch, max_seq,
                                           _dtype(self.cfg), self.device)

    @torch.inference_mode()
    def prefill(self, params, batch, caches):
        """Full-sequence prefill into ``caches`` (in place); returns (f32
        last-position logits (B,1,V), caches)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(cfg, params, batch["frames"])
            hidden, caches = encdec.decode_full(cfg, params, tokens, enc_out,
                                                caches, write_cache=True)
        else:
            hidden, _, caches = transformer.forward(
                cfg, params, tokens, caches=caches, write_cache=True)
        logits = self._assembly().logits_from_hidden(cfg, params,
                                                     hidden[:, -1:, :])
        return logits.float(), caches

    @torch.inference_mode()
    def decode(self, params, batch, caches):
        """batch: {token (B,1), positions (B,)}; one decode step."""
        logits, caches = self._assembly().decode_step(
            self.cfg, params, batch["token"], batch["positions"], caches)
        return logits.float(), caches


def build(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, str(device))


def params_from_arrays(cfg, tree, dtype=None, device="cuda") -> dict:
    """The reference's ``Model(cfg).init(key)[0]``, a nested dict of numpy
    arrays (bfloat16 ones included), -> the port's parameter tree on
    ``device``. Every name and shape is checked against the port's own init
    (drawn on the meta device, so nothing is allocated). Each leaf takes the
    type the port's init gives it for the model dtype ``dtype`` (default:
    the config's): the f32 leaves (MoE router, SSM dt_bias, A_log, D) stay
    f32. Values are carried exactly where the reference's type is that
    type."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    expected, _ = Model(cfg).abstract_init()
    return carry(expected, tree, device=device)
