"""zamba2-2.7b — hybrid: Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242; hf]

54 Mamba2 layers (d_model=2560, expand 2 -> d_inner 5120, headdim 64 ->
80 SSM heads, state 64); after every 6 Mamba layers one of 2 weight-shared
transformer blocks (32 heads MHA, d_ff 10240) is applied, alternating.
Sub-quadratic between attention points -> runs the long_500k shape.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32000,
    attention="gqa",
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_period=6,
    num_shared_blocks=2,
    tie_embeddings=True,
    rope_theta=1e4,
    remat="full",
)
