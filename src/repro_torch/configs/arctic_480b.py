"""arctic-480b — Snowflake Arctic base: dense-MoE hybrid.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128 experts top-2 PLUS a dense residual MLP in
parallel with the routed output.  bf16 params + bf16 Adam moments so the
~0.47T parameters fit 256 chips with FSDP (see partitioning.fsdp_rules).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32000,
    attention="gqa",
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
    remat="full",
    fsdp=True,
)
