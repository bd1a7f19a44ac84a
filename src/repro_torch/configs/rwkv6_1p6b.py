"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=7168, vocab_size=65536,
    act="gelu", rope_theta=0.0,
    ssm=SSMConfig(state_dim=64, n_heads=32, head_dim=64, chunk=64),
    remat="dots_saveable")

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    ssm=SSMConfig(state_dim=8, n_heads=4, head_dim=8, chunk=16),
    remat="none")
