"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

MoE: 32 experts, top-8, expert d_ff=512, every layer.

The port's own copy of ``repro.configs.granite_moe_1b``, number for number.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN, MOE_FF

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    vocab_multiple=2048,
    head_dim=64,
    layer_pattern=((ATTN, MOE_FF),),
    moe=MoEConfig(num_experts=32, top_k=8, num_shared_experts=0,
                  expert_d_ff=512, shared_d_ff=0),
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    fsdp=False,
    remat_policy="none",
    microbatches=(("train_4k", 2),),
    supports_long_context=False,
)

REDUCED = ModelConfig(
    name="granite-moe-1b-a400m-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=257,
    head_dim=16,
    layer_pattern=((ATTN, MOE_FF),),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                  expert_d_ff=32, shared_d_ff=0),
)
