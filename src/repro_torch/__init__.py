"""repro_torch — Tilted Layer Fusion (ISCAS 2022) in PyTorch, for an NVIDIA
H100 (Hopper, sm_90a).

The PyTorch package of the repository, beside the JAX package ``repro``
(the reference).  It imports torch and numpy only — never jax, never
``repro``.

Layout (each module is the counterpart of the same path in ``repro``):
  repro_torch.core     — tilted tile geometry, plain PyTorch executors,
                         int8 quantisation
  repro_torch.kernels  — the hand-written CUDA kernel (K1) + its wrapper,
                         plain version and marshalling
  repro_torch.models   — ABPN, the decoder-only LMs (dense, MoE/MLA
                         and vlm families; Mamba2; the Zamba2 hybrid)
                         and the model registry
  repro_torch.engine   — plan, executor, scheduler, session, server
  repro_torch.config, .configs, .layers, .distributed, .launch —
                         the LM path: configs, layers, the train, prefill
                         and decode step functions and their entry points
                         (launch.train, launch.serve)
  repro_torch.optim, .data, .runtime — AdamW, synthetic data and the
                         prefetcher, checkpoints and the resilient loop

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs every kernel's plain version.
"""

__version__ = "0.1.0"
