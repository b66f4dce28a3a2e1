"""deepseek-v2-236b — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

60L d_model=5120, 128 heads with Multi-head Latent Attention
(kv_lora_rank=512, q_lora_rank=1536, decoupled rope dim 64, per-head
nope/v dims 128), vocab 102400.  MoE: 160 routed experts top-6 with
expert hidden 1536 (the assigned d_ff) plus 2 shared experts; layer 0 is
dense (first_k_dense=1).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=1536,
    vocab_size=102400,
    attention="mla",
    num_heads=128,
    num_kv_heads=128,  # MLA: informational (cache is the shared latent)
    head_dim=128,  # per-head "nope" dim
    rope_head_dim=64,
    v_head_dim=128,
    kv_lora_rank=512,
    q_lora_rank=1536,
    num_experts=160,
    experts_per_token=6,
    moe_d_ff=1536,
    num_shared_experts=2,
    first_k_dense=1,
    rope_theta=1e4,
    param_dtype="bfloat16",
    remat="full",
    fsdp=True,
)
