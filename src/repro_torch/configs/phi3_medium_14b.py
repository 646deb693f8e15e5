"""Phi-3-medium-14B [arXiv:2404.14219] — dense, RoPE, SwiGLU, GQA kv=10.

The port's own copy of ``repro.configs.phi3_medium_14b``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    vocab_multiple=2048,
    head_dim=128,
    rope_theta=10000.0,
    act="silu",
    fsdp=True,
    remat_policy="dots",
    microbatches=(("train_4k", 8),),
    supports_long_context=False,
)

REDUCED = ModelConfig(
    name="phi3-medium-14b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=224,
    vocab_size=257,
    head_dim=16,
    act="silu",
)
