"""Mamba-2 2.7B [arXiv:2405.21060] — attention-free SSD (state-space duality).

64 pure Mamba-2 blocks (no MLP), d_state=128. Supports long_500k: the decode
state is O(1) in sequence length.

The port's own copy of ``repro.configs.mamba2_2p7b``, number for number.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, SSM, NO_FF

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,                  # d_inner / head_dim = 5120/64 (for bookkeeping)
    n_kv_heads=80,
    d_ff=0,
    vocab_size=50280,
    vocab_multiple=2048,
    layer_pattern=((SSM, NO_FF),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    act="silu",
    fsdp=True,
    remat_policy="dots",
    microbatches=(("train_4k", 8),),
    supports_long_context=True,
    notes="vocab 50280 padded to 51200 (vocab_multiple=2048) for even sharding.",
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=257,
    layer_pattern=((SSM, NO_FF),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                  chunk_size=32, n_groups=1),
    supports_long_context=True,
)
