"""internvl2-1b — VLM: InternViT stub frontend + Qwen2-0.5B-style LM.
[arXiv:2404.16821; hf]

The vision tower is a STUB per the assignment: ``input_specs`` supplies
256 precomputed patch embeddings (B, 256, d_model) that are concatenated
ahead of the token embeddings.  The language backbone keeps the assigned
geometry (24L d896 14H kv2 d_ff 4864, vocab 151655, QKV bias).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151655,
    attention="gqa",
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    frontend_tokens=256,
    rope_theta=1e6,
    remat="full",
)
