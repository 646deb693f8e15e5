"""Whisper-base [arXiv:2212.04356] — encoder-decoder audio backbone.

6 encoder + 6 decoder layers, d_model=512, 8 heads, GELU MLP. The conv audio
frontend is a STUB: input_specs() provides precomputed frame embeddings of
shape (batch, 1500, 512) (30 s of audio after the conv downsampler).
Decode shapes exercise the decoder (self-attn KV cache + cross-attn cache).

The port's own copy of ``repro.configs.whisper_base``, number for number.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                 # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    vocab_multiple=2048,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq_len=1500,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    fsdp=False,
    remat_policy="none",
    supports_long_context=False,
    notes="Whisper uses learned absolute positions; we keep RoPE for the "
          "decoder and sinusoidal for the encoder (backbone-equivalent "
          "adaptation, noted per DESIGN.md). vocab 51865 padded to 53248 for even sharding.",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=257,
    head_dim=16,
    is_encoder_decoder=True,
    n_encoder_layers=2,
    encoder_seq_len=24,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
