"""mamba2-130m — attention-free SSD LM. [arXiv:2405.21060; unverified]

24 layers, d_model=768 (d_inner 1536, headdim 64 -> 24 SSM heads),
state N=128, conv width 4, GPT-NeoX vocab 50280, tied embeddings.
The chunked SSD scan is the sequence-axis analogue of tilted layer
fusion (DESIGN.md §5) — this arch is the technique's closest LM relative.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
    remat="full",
)
