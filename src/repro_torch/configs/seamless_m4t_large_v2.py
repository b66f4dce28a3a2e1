"""seamless-m4t-large-v2 — enc-dec multimodal backbone. [arXiv:2308.11596; hf]

24 encoder + 24 decoder layers, d_model=1024, 16 heads (MHA), d_ff=8192
ReLU (non-gated) FFN, vocab 256206.  The audio frontend is a STUB:
``input_specs`` supplies precomputed frame embeddings (B, S, d_model) as
the encoder input.  RoPE replaces the original positions (DESIGN.md §2).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,
    attention="gqa",
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    mlp_act="relu",
    rope_theta=1e4,
    remat="full",
)
