"""Deterministic synthetic data: LM token streams and SR image pairs — the
port of ``repro.data.synthetic``.

Every batch is a pure function of ``(seed, step)``: its numbers are drawn
on the CPU from a ``torch.Generator`` seeded from the pair, so a restart
replays the same stream, on any device.  They are not the JAX package's
``jax.random`` numbers; tests that compare the two packages hand both the
same arrays.  A batch for a CUDA device is copied up from pinned memory
without blocking (a pageable ``.to(device)`` would synchronize the stream).

The SR pair generator produces band-limited textures (upsampled noise
octaves), so the box-downsampled LR image keeps learnable structure.
``jax.image.resize(..., "bilinear")`` becomes ``F.interpolate(mode=
"bilinear", align_corners=False)``: the textures are only ever upsampled,
where the reference's antialiasing has no effect, and both clamp to the
edge pixel at the border.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["lm_batch", "sr_pair_batch", "downsample", "bilinear_resize", "step_generator",
           "to_device"]


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``(seed, step)``."""
    mixed = np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed) >> 1)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` (on the CPU) on ``device``: a CUDA copy goes from pinned memory
    and does not block the host."""
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def lm_batch(cfg, step: int, batch: int, seq: int, seed: int = 0,
             device="cpu") -> Dict[str, torch.Tensor]:
    """Markov-ish token batch: ``tokens``, next-token ``targets``, ``mask``
    (int32, ``(batch, seq)``).

    Tokens follow a noisy arithmetic progression modulo vocab, so there is
    structure for a model to learn (loss drops well below uniform).
    """
    gen = step_generator(seed, step)
    start = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, dtype=torch.int64)
    stride = torch.randint(1, 7, (batch, 1), generator=gen, dtype=torch.int64)
    pos = torch.arange(seq + 1, dtype=torch.int64)[None, :]
    stream = ((start + stride * pos) % cfg.vocab_size).to(torch.int32)
    out = {"tokens": stream[:, :-1], "targets": stream[:, 1:],
           "mask": torch.ones((batch, seq), dtype=torch.int32)}
    return {k: to_device(v.contiguous(), device) for k, v in out.items()}


def bilinear_resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(H, W, C)`` -> ``(h, w, C)`` bilinear, half-pixel centres."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0)


def _smooth_noise(gen: torch.Generator, h: int, w: int, c: int, octaves: int = 3) -> torch.Tensor:
    """Band-limited texture in [0, 1]: sum of upsampled noise octaves."""
    img = torch.zeros((h, w, c))
    for o in range(octaves):
        f = 2 ** (o + 2)
        coarse = torch.rand((max(h // f, 1), max(w // f, 1), c), generator=gen)
        img = img + bilinear_resize(coarse, h, w) / (o + 1)
    lo, hi = img.min(), img.max()
    return (img - lo) / torch.clamp_min(hi - lo, 1e-6)


def downsample(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """Area (box) downsample of ``(..., H, W, C)`` — the LR degradation
    model.  The ``scale**2`` pixels of a box are summed in row-major order
    and the sum multiplied by ``1 / scale**2``: the order and rounding XLA
    gives the reference's ``mean`` on the CPU, so the result is
    bit-identical to it there."""
    *lead, h, w, c = hr.shape
    x = hr.reshape(*lead, h // scale, scale, w // scale, scale, c)
    acc = x[..., 0, :, 0, :]
    for i in range(1, scale * scale):
        acc = acc + x[..., i // scale, :, i % scale, :]
    return acc * (1.0 / (scale * scale))


def sr_pair_batch(
    step: int,
    batch: int,
    lr_shape: Tuple[int, int] = (60, 64),
    scale: int = 3,
    channels: int = 3,
    seed: int = 0,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lr (B, h, w, C), hr (B, h*s, w*s, C))`` fp32 pairs, deterministic
    in ``(seed, step)``."""
    h, w = lr_shape
    gen = step_generator(seed + 7, step)
    hr = torch.stack([_smooth_noise(gen, h * scale, w * scale, channels) for _ in range(batch)])
    lr = downsample(hr, scale)
    return to_device(lr, device), to_device(hr, device)
