"""Granite-3.0-2B-base [hf:ibm-granite/granite-3.0-2b-base] — dense GQA kv=8.

The port's own copy of ``repro.configs.granite_3_2b``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    vocab_multiple=2048,
    head_dim=64,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    fsdp=True,
    remat_policy="dots",
    microbatches=(("train_4k", 4),),
    supports_long_context=False,
    notes="Granite's logit/residual/embedding multipliers are folded into "
          "init scales (simplification; does not change sharding/roofline).",
)

REDUCED = ModelConfig(
    name="granite-3-2b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=259,
    head_dim=16,
    act="silu",
    tie_embeddings=True,
)
