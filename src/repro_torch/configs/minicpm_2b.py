"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense, MHA (GQA kv=36), WSD.

The port's own copy of ``repro.configs.minicpm_2b``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    vocab_multiple=2048,
    head_dim=64,
    rope_theta=10000.0,
    act="silu",
    schedule="wsd",            # the paper-noted Warmup-Stable-Decay schedule
    tie_embeddings=True,       # MiniCPM ties embeddings
    fsdp=True,
    remat_policy="dots",
    microbatches=(("train_4k", 4),),
    # §Perf hillclimb: 36 heads do not divide the 16-way model axis ->
    # attention replicates. Sequence-parallel attention compute recovers it:
    # 4.2x fewer FLOPs/dev (useful-FLOPs fraction 17% -> 73%).
    attn_seq_shard=True,
    supports_long_context=False,
    notes="vocab 122753 is padded to 122880 (vocab_multiple=2048) so the "
          "embedding shards evenly on the model axis; padded logits masked.",
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=257,
    head_dim=16,
    act="silu",
    schedule="wsd",
    tie_embeddings=True,
)
