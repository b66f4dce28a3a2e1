"""qwen3-14b — dense, GQA + qk_norm. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151936,
    attention="gqa",
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    remat="full",
)
