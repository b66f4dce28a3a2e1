"""Whether what the timed path produced is correct.

Once the window has closed and the program's state is freed, the HR frames
that the sampled requests received (coalesced, bucket-padded dispatches
sliced back per request, the band cut, K1 and the epilogue), at positions
in each request drawn from the seed, are compared with the plain reference
of the configuration's model family (``reference/<family>.py`` through
``families/<family>.py``, float32 with TF32 off) computed from the
benchmark's own weights and LR frames, made again from the seed.  The
number compared is the largest absolute difference over every HR value of
every sampled frame (``max_abs_err``), held to the configuration's limit;
a request that failed or never finished makes the run not correct, and so
does a run that compared no frame.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import List, Optional, Tuple

import torch

from harness import inputs

# the correctness control: the reference in the nearest precision below the
# one the configuration serves in
CONTROL = {"fp32": "tf32", "bf16": "fp8"}
BLOCK_FRAMES = 8  # reference frames at a time, so that it fits beside the sample


def compare(sample: List[Tuple[object, List[int], Optional[torch.Tensor]]], cfg: dict,
            family: ModuleType, pool_frames: int, seed: int, device,
            precision: str = "fp32") -> dict:
    """``max_abs_err`` and ``frames`` over the sampled ``(request,
    positions, hr)``, where ``hr`` holds the request's HR frames at
    ``positions``; ``family`` is the configuration's model family
    (``registry.family``); ``precision`` other than ``fp32`` computes the
    reference itself in a lower precision (the correctness control) instead
    of reading the program's frames."""
    device = torch.device(device)
    pool = inputs.make_pool(cfg, pool_frames, seed)
    weights = family.make_weights(cfg, seed, device)
    worst, frames = 0.0, 0
    with family.exact():
        for req, pos, hr in sample:
            lr = torch.from_numpy(pool[[req.start + i for i in pos]]).to(device)
            for i in range(0, len(pos), BLOCK_FRAMES):
                want = family.reference(lr[i:i + BLOCK_FRAMES], weights, cfg)
                if precision != "fp32":
                    part = family.reference(lr[i:i + BLOCK_FRAMES], weights, cfg, precision)
                elif hr is None or tuple(hr.shape) != (len(pos), *want.shape[1:]):
                    worst = math.inf
                    continue
                else:
                    part = hr[i:i + BLOCK_FRAMES]
                err = (part.to(torch.float32) - want).abs().max().item()
                worst = max(worst, err if math.isfinite(err) else math.inf)
                frames += want.shape[0]
    return {"max_abs_err": worst, "frames": frames}


def checks(result: dict, failed: int, limit: float) -> dict:
    """Each number compared, beside its limit."""
    return {
        "max_abs_err": {"value": result["max_abs_err"], "limit": limit},
        "failed_requests": {"value": failed, "limit": 0},
        "frames_compared": {"value": result["frames"], "limit": 1},
    }


def correct(c: dict) -> bool:
    return (c["max_abs_err"]["value"] <= c["max_abs_err"]["limit"]
            and c["failed_requests"]["value"] <= c["failed_requests"]["limit"]
            and c["frames_compared"]["value"] >= c["frames_compared"]["limit"])
