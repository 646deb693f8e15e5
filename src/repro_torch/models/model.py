"""Unified model API used by serving (``repro.models.model``).

``Model(cfg, device)`` dispatches decoder-only vs encoder-decoder assemblies
and exposes:
  init(generator)                     -> (params, axes)
  init_cache(batch, max_seq)          -> (caches, axes)
  prefill(params, batch, caches)      -> (last-position logits, caches)
  decode(params, batch, caches)       -> (logits, caches)
``params_from_arrays`` carries the reference's initialised weights into the
port's tree. Training (``loss``) and the dry-run (``abstract_*``,
``input_specs``, ``batch_axes``) come with their callers.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import DTYPES, carry


def _dtype(cfg):
    return DTYPES[cfg.dtype]


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
    expected, _ = Model(cfg, "meta").init(None)
    return carry(expected, tree, device=device)
