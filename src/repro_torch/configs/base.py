"""Model / run configuration dataclasses (a copy of the JAX package's).

One ``ModelConfig`` describes any architecture in the assigned pool; family-
specific fields are zero/empty when unused.  ``ShapeConfig`` describes one
assigned input-shape cell.  Everything is frozen and hashable so configs can
key compilation caches and manifests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "einsum" (GShard dense dispatch, oracle) | "ep" (shard_map all_to_all)
    impl: str = "einsum"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0          # N (mamba2 ssm_state / rwkv head size)
    n_heads: int = 0            # SSD heads / wkv heads
    head_dim: int = 0           # P per head
    expand: int = 2             # mamba2 inner expansion
    chunk: int = 128            # SSD/WKV chunk length
    conv_width: int = 4         # mamba2 depthwise conv


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "swiglu"         # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) freq split
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # pad token id for batched serving (runtime/server.pack_prompts).  Any
    # valid embedding index works — per-row lengths, not sentinel scanning,
    # are the source of truth for what is padding, and pad slots are masked
    # out of attention / recurrent state everywhere — but it must be a
    # legal row of the embedding table (0 <= pad_id < vocab_size).
    pad_id: int = 0
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid (zamba2): one shared attention block applied every k SSM blocks
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0
    # encdec (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    # attention window (0 = full causal). zamba2 shared attn & long-ctx decode
    window: int = 0
    # numerics / runtime
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_quant: str = "none"      # none | int8 (per-token-per-head scales)
    logits_fp32: bool = True
    remat: str = "none"         # none | full | dots_saveable
    attn_impl: str = "auto"     # auto | pallas | ref
    scan_layers: bool = True
    # embeddings fed directly (vlm/audio frontends are stubs)
    embeds_input: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / windowed)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS = 6·N·D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        qo = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        attn = d * qo + 2 * d * kv + qo * d
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = glu * d * ff
        if self.moe.n_experts:
            mlp *= self.moe.n_experts
            mlp += d * self.moe.n_experts          # router
        norms = 2 * d
        if self.family == "ssm":                   # rwkv6 block
            att = self.ssm.n_heads * self.ssm.head_dim
            blk = (4 * d * att                     # r,k,v,g (w is low-rank)
                   + d * 64 + 64 * att             # w lora
                   + att * d                       # out
                   + 3.5 * d * ff / (ff / d) * 0)  # (ffn counted via mlp below)
            mlp = 2 * d * ff                       # rwkv channel-mix: k,v (r small)
            per_layer = blk + mlp + norms
            return int(self.n_layers * per_layer + 2 * v * d)
        if self.family == "hybrid":
            di = self.ssm.expand * d
            mamba = (2 * d * di + di * self.ssm.conv_width
                     + di * 2 * self.ssm.state_dim + di  # B,C,dt proj (grouped)
                     + di * d)
            n_shared = (self.n_layers // max(1, self.shared_attn_every))
            shared = attn + glu * d * ff
            lora = n_shared * 2 * self.shared_attn_lora_rank * d * 2
            return int(self.n_layers * (mamba + norms)
                       + shared + lora + 2 * v * d)
        layers = self.n_layers or (self.encoder_layers + self.decoder_layers)
        per_layer = attn + mlp + norms
        if self.family == "encdec":                # decoder cross-attn
            per_layer = attn + mlp + norms
            dec_extra = attn                        # cross attention block
            return int(self.encoder_layers * per_layer
                       + self.decoder_layers * (per_layer + dec_extra)
                       + v * d + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return int(layers * per_layer + emb + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe.n_experts:
            return self.param_count()
        full = self.param_count()
        d, ff = self.d_model, self.d_ff
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        all_experts = self.n_layers * glu * d * ff * self.moe.n_experts
        active = self.n_layers * glu * d * ff * self.moe.top_k
        return int(full - all_experts + active)


@dataclass(frozen=True)
class ShapeConfig:
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
