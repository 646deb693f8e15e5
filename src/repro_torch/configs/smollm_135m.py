"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small, GQA kv=3.

The port's own copy of ``repro.configs.smollm_135m``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    vocab_multiple=2048,
    head_dim=64,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    fsdp=True,
    remat_policy="none",
    supports_long_context=False,
    # §Perf hillclimb: 9 heads / 3 kv heads do not divide the 16-way model
    # axis, so TP replicates attention 16x. A 135M model needs no TP: map
    # batch over (data x model) = 256-way pure DP (+FSDP for optimizer
    # state). Measured: 8.6x fewer FLOPs/dev, 40x fewer collective bytes.
    sharding_overrides=(
        ("batch", (("data", "model"), ("data",))),
        ("island", (("data", "model"), ("data",))),
        ("heads", ()), ("kv_heads", ()), ("mlp", ()), ("vocab", ()),
        ("expert", ()), ("ssm_inner", ()), ("ssm_heads", ()), ("kv_seq", ()),
        ("__no_tp_fallback__", ((),)),
    ),
    notes="pure-DP production mapping; see EXPERIMENTS.md §Perf.",
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced",
    family="dense",
    n_layers=3,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=257,
    head_dim=16,
    act="silu",
    tie_embeddings=True,
)
