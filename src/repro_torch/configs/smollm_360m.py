"""smollm-360m — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=49152,
    act="swiglu", rope_theta=10_000.0, tie_embeddings=True)

SMOKE = CONFIG.replace(
    name="smollm-smoke", n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
    head_dim=20, d_ff=128, vocab_size=256)
