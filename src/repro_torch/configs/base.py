"""Config system: model architecture configs + input-shape registry.

The port's own copy of ``repro.configs.base``: the two packages share no
module, so a change to one is made to both. Every architecture gets one
``<id>.py`` module exporting ``CONFIG`` (a :class:`ModelConfig` with the
exact published numbers) and optionally ``REDUCED`` (a small same-family
config used by CPU tests). The MoE/MLA/SSM blocks and the sharding
overrides are carried as plain data. ``param_counts`` gives a training
step's model FLOPs (6 N D); ``cells_for`` waits for its caller (the port's
bench harness).

Shapes:
  train_4k     seq_len=4096    global_batch=256   (training)
  prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768   global_batch=128   (inference-decode, 1 new tok)
  long_500k    seq_len=524288  global_batch=1     (long-context decode)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used to describe heterogeneous stacks (Jamba etc.).
ATTN = "attn"            # full (GQA) self-attention
MLA_ = "mla"             # multi-head latent attention (DeepSeek-V2)
SSM = "ssm"              # Mamba-2 SSD layer
DENSE_FF = "dense"       # dense MLP
MOE_FF = "moe"           # mixture-of-experts MLP
NO_FF = "none"           # no feed-forward (pure Mamba-2 blocks)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0                # d_ff of each routed expert
    shared_d_ff: int = 0                # d_ff of the shared expert(s), total
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25       # used by the dropping router variant


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                # 0 = full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128                  # N
    d_conv: int = 4
    expand: int = 2                     # d_inner = expand * d_model
    head_dim: int = 64                  # P; n_heads = d_inner // head_dim
    chunk_size: int = 256               # SSD chunk length
    n_groups: int = 1                   # B/C groups (like GQA for SSM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    # --- heterogeneous stacks -------------------------------------------------
    # Pattern of (mixer, ff) kinds repeated over the stack. Length must divide
    # n_layers. Default: all (ATTN, DENSE_FF).
    layer_pattern: Tuple[Tuple[str, str], ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0            # fixed frame count from the stub frontend
    # --- positional / misc ----------------------------------------------------
    rope_theta: float = 10000.0
    max_seq_len: int = 524288
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    tie_embeddings: bool = False
    act: str = "silu"                   # silu (SwiGLU) | gelu (plain MLP)
    qk_norm: bool = False               # Chameleon-style qk RMSNorm
    # --- numerics / parallelism knobs (hillclimb surface) ---------------------
    dtype: str = "bfloat16"
    remat_policy: str = "dots"          # none | dots | full
    # grad-accum microbatches per shape name (memory knob); default 1
    microbatches: Tuple[Tuple[str, int], ...] = ()
    fsdp: bool = False                  # shard params/opt over data axis too
    use_flash_kernel: bool = True       # B8 in gqa_apply(allow_flash=True)
    # schedule: wsd (MiniCPM) | cosine
    schedule: str = "cosine"
    # skip long_500k (quadratic attention)? set for pure full-attn archs
    supports_long_context: bool = False
    # embedding tables are padded up to a multiple of this so the vocab dim
    # shards evenly on any production mesh axis (padded logits are masked);
    # the standard production trick for "odd" vocabs like minicpm's 122753.
    vocab_multiple: int = 1
    # The reference's dry-run/roofline knobs (its XLA cost analysis needs
    # the layer scan unrolled and the CE loop in one chunk); carried as data.
    unroll_blocks: bool = False
    ce_chunk: int = 1024
    # per-arch logical-rule overrides for the sharding resolver, e.g. the
    # pure-DP mapping for small models whose head counts don't divide the
    # model axis: (("batch", (("data","model"),)), ("__no_tp_fallback__", 1))
    sharding_overrides: Tuple = ()
    # sequence-parallel attention: shard the q-sequence dim of attention
    # compute on the model axis — recovers the model axis for archs whose
    # head counts don't divide it (smollm 9H, minicpm 36H, 8/10 kv heads)
    attn_seq_shard: bool = False
    notes: str = ""

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        if self.layer_pattern:
            if self.n_layers % len(self.layer_pattern):
                raise ValueError(
                    f"{self.name}: pattern len {len(self.layer_pattern)} "
                    f"does not divide n_layers {self.n_layers}")
            return self.layer_pattern
        return ((ATTN, DENSE_FF),)

    @property
    def n_blocks(self) -> int:
        """Number of repeats of the layer pattern (the stacked axis)."""
        return self.n_layers // len(self.pattern)

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) --------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params) — active differs for MoE.
        The reference's count, term for term (its encoder-decoder terms
        included as it writes them)."""
        d, hd = self.d_model, self.resolved_head_dim
        mult = 3 if self.act == "silu" else 2
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        for mixer, ff in self.pattern:
            reps = self.n_blocks
            if mixer == ATTN:
                p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif mixer == MLA_:
                m = self.mla
                p = d * self.n_heads * (m.qk_nope_head_dim
                                        + m.qk_rope_head_dim)
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                      + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
            elif mixer == SSM:
                s = self.ssm
                d_in = s.expand * d
                n_heads = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                p = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)
                p += conv_dim * s.d_conv + n_heads + n_heads
                p += d_in * d
            else:
                raise ValueError(mixer)
            total += p * reps
            active += p * reps
            if ff == DENSE_FF:
                total += mult * d * self.d_ff * reps
                active += mult * d * self.d_ff * reps
            elif ff == MOE_FF:
                mo = self.moe
                per_expert = mult * d * mo.expert_d_ff
                shared = (mult * d * mo.shared_d_ff
                          if mo.num_shared_experts else 0)
                router = d * mo.num_experts
                total += (per_expert * mo.num_experts + shared + router) \
                    * reps
                active += (per_expert * mo.top_k + shared + router) * reps
            elif ff != NO_FF:
                raise ValueError(ff)
        norms = d * (2 * self.n_layers + 1)
        total += norms
        active += norms
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (4 * d * d + mult * d * self.d_ff
                                           + 2 * d)
            xattn = self.n_layers * (4 * d * d + d)
            total += enc + xattn
            active += enc + xattn
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
