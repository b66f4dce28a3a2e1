"""qwen3-1.7b — dense, GQA + qk_norm, tied embeddings. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    d_ff=6144,
    vocab_size=151936,
    attention="gqa",
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    remat="full",
)
