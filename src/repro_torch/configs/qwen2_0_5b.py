"""qwen2-0.5b — dense, GQA with QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attention="gqa",
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    remat="full",
)
