"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention MoE.

72 layers in 9 blocks of 8: one attention layer per block (1:7 attn:mamba),
MoE replacing the MLP on every other layer (16 experts, top-2).
Param check (see DESIGN.md): ~398B total, ~94B active.

The port's own copy of ``repro.configs.jamba_1p5_large_398b``,
number for number.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                ATTN, SSM, DENSE_FF, MOE_FF)

_BLOCK = tuple(
    (ATTN if i == 4 else SSM, MOE_FF if i % 2 == 1 else DENSE_FF)
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    vocab_multiple=2048,
    head_dim=128,
    layer_pattern=_BLOCK,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared_experts=0,
                  expert_d_ff=24576, shared_d_ff=0),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, n_groups=1),
    rope_theta=10000.0,
    act="silu",
    fsdp=True,
    remat_policy="full",
    microbatches=(("train_4k", 16),),
    supports_long_context=True,
    notes="long_500k runs: only 9/72 layers are attention; their KV cache is "
          "sharded along sequence on the model axis.",
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=257,
    head_dim=16,
    layer_pattern=tuple(
        (ATTN if i == 4 else SSM, MOE_FF if i % 2 == 1 else DENSE_FF)
        for i in range(8)),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                  expert_d_ff=128, shared_d_ff=0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                  chunk_size=32, n_groups=1),
    supports_long_context=True,
)
