"""Unified model/run configuration for every assigned architecture.

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
encdec / vlm); family-specific blocks are optional fields.  Exact published
numbers live in ``repro_torch/configs/<arch>.py``; reduced smoke-test
variants are derived with :meth:`ModelConfig.reduced`.  A copy of the JAX
package's ``repro.config``, field for field; the dtype properties return
``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "TrainConfig", "torch_dtype", "resolve_device"]


def torch_dtype(name) -> torch.dtype:
    """The ``torch.dtype`` a config names ("bfloat16", "float32", ...); a
    ``torch.dtype`` passes through."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name).removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on (default the CUDA card).
    A CUDA device where there is none raises: an entry point never carries
    on on the CPU unless the caller asks for ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available "
                           "(pass device 'cpu' to run on the CPU)")
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # ---- identity ----
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # ---- trunk ----
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # ---- attention ----
    attention: str = "gqa"  # gqa | mla | none
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    qk_norm: bool = False  # qwen3 family
    qkv_bias: bool = False  # qwen2 family
    rope_theta: float = 1e6
    attn_chunk: int = 1024  # flash-style KV chunk for long sequences
    # ---- MLA (deepseek-v2) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden size (d_ff used for the dense path)
    num_shared_experts: int = 0  # deepseek: always-on experts
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    first_k_dense: int = 0  # deepseek: first k layers use dense MLP
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # ---- SSM (mamba2 / zamba2) ----
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # ---- hybrid (zamba2): shared attention block every N ssm layers ----
    shared_attn_period: int = 0
    num_shared_blocks: int = 0
    # ---- encoder-decoder (seamless) ----
    encoder_layers: int = 0
    # ---- multimodal stub frontend (vlm: patch embeds; audio: frame embeds) ----
    frontend_tokens: int = 0
    # ---- numerics / execution ----
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "none"  # none | dots | full
    fsdp: bool = False  # ZeRO-3 weight sharding over the data axis
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu | relu

    # ------------------------------------------------------------------
    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def uses_attention(self) -> bool:
        return self.attention != "none"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def supports_long_context(self) -> bool:
        """True for sub-quadratic archs (SSM/hybrid) — long_500k eligibility."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (no encoder-only)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests.

        Shrinks depth/width/experts/vocab while preserving every structural
        feature (GQA ratios, qk_norm, MLA ranks, shared blocks, ...).
        """
        changes = dict(
            num_layers=min(self.num_layers, 4),
            d_model=min(self.d_model, 64),
            d_ff=min(self.d_ff, 128),
            vocab_size=min(self.vocab_size, 512),
            attn_chunk=64,
            ssm_chunk=32,
            dtype="float32",
            param_dtype="float32",
        )
        if self.uses_attention and self.num_heads:
            q_per_kv = max(1, self.num_heads // max(self.num_kv_heads, 1))
            changes["num_kv_heads"] = min(self.num_kv_heads, 2)
            changes["num_heads"] = changes["num_kv_heads"] * min(q_per_kv, 4)
            changes["head_dim"] = min(self.head_dim, 16)
        if self.attention == "mla":
            changes.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                           v_head_dim=16, head_dim=16)
        if self.is_moe:
            changes.update(
                num_experts=min(self.num_experts, 8),
                experts_per_token=min(self.experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 64),
            )
        if self.family in ("ssm", "hybrid"):
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_headdim=16)
        if self.shared_attn_period:
            changes.update(shared_attn_period=2, num_layers=4, num_shared_blocks=2)
        if self.encoder_layers:
            changes["encoder_layers"] = min(self.encoder_layers, 2)
        if self.frontend_tokens:
            changes["frontend_tokens"] = 8
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / runtime knobs for the training loop."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer_dtype: str = "float32"  # adam moment dtype (bf16 for ≥200B archs)
    microbatches: int = 1  # gradient accumulation
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
