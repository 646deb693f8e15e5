"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM, dense backbone.

Image VQ tokens share the text vocabulary (early fusion), so the backbone
consumes plain token ids; the VQ image tokenizer is the stubbed frontend
(input_specs() provides token ids directly).

The port's own copy of ``repro.configs.chameleon_34b``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    vocab_multiple=2048,
    head_dim=128,
    rope_theta=10000.0,
    act="silu",
    qk_norm=True,
    fsdp=True,
    remat_policy="full",
    microbatches=(("train_4k", 16),),
    supports_long_context=False,
    notes="Chameleon's qk-norm is included (training-stability feature the "
          "paper highlights). Frontend (VQ-VAE tokenizer) is a stub.",
)

REDUCED = ModelConfig(
    name="chameleon-34b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=257,
    head_dim=16,
    act="silu",
    qk_norm=True,
)
