"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks w/ LoRA.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab_size=32000,
    act="geglu", rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, n_heads=80, head_dim=64, expand=2,
                  chunk=128, conv_width=4),
    shared_attn_every=6, shared_attn_lora_rank=128,
    remat="dots_saveable")

SMOKE = CONFIG.replace(
    name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256,
    ssm=SSMConfig(state_dim=16, n_heads=16, head_dim=8, expand=2,
                  chunk=16, conv_width=4),
    shared_attn_every=2, shared_attn_lora_rank=8, remat="none")
