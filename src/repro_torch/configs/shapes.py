"""Assigned input shapes and their ``meta``-tensor specs — the port of
``repro.configs.shapes``.

Four shapes per LM arch (assignment):
  train_4k     seq 4,096   x global batch 256   (training step)
  prefill_32k  seq 32,768  x global batch 32    (inference prefill)
  decode_32k   seq 32,768  x global batch 128   (one-token decode, full cache)
  long_500k    seq 524,288 x global batch 1     (long-context decode)

``decode_*``/``long_*`` run the decode step (a single new token against a
KV cache of ``seq_len``), NOT the train step.  ``long_500k`` requires
sub-quadratic attention: it runs for ssm/hybrid archs and is recorded as a
SKIP for pure full-attention archs.

``input_specs`` returns ``meta`` tensors only (the reference's
``ShapeDtypeStruct``s: int32 tokens, the activation dtype for ``src`` and
``frontend``) — the dry-run never allocates real data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["SHAPES", "ShapeSpec", "batch_specs", "input_specs", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip policy."""
    spec = SHAPES[shape_name]
    if spec.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            f"{cfg.name} is pure full-attention; 524k decode is quadratic-"
            "cost/cache-prohibitive — skipped per assignment (sub-quadratic "
            "archs only)"
        )
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, shape: ShapeSpec, override_batch: Optional[int] = None,
                override_seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Model inputs of one step as ``meta`` tensors (cache/params excluded)."""
    B = override_batch or shape.global_batch
    S = override_seq or shape.seq_len
    i32 = torch.int32
    act = cfg.activation_dtype
    d = cfg.d_model

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {
                "src": _spec((B, S, d), act),
                "tokens": _spec((B, S), i32),
                "targets": _spec((B, S), i32),
                "mask": _spec((B, S), i32),
            }
        out = {
            "tokens": _spec((B, S), i32),
            "targets": _spec((B, S), i32),
            "mask": _spec((B, S), i32),
        }
        if cfg.family == "vlm":
            f = cfg.frontend_tokens
            out["frontend"] = _spec((B, f, d), act)
            out["tokens"] = _spec((B, S - f), i32)
            out["targets"] = _spec((B, S - f), i32)
            out["mask"] = _spec((B, S - f), i32)
        return out

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {
                "src": _spec((B, S, d), act),
                "tokens": _spec((B, S), i32),
            }
        out = {"tokens": _spec((B, S), i32)}
        if cfg.family == "vlm":
            f = cfg.frontend_tokens
            out["frontend"] = _spec((B, f, d), act)
            out["tokens"] = _spec((B, S - f), i32)
        return out

    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), i32)}

    raise ValueError(f"unknown shape kind {shape.kind!r}")


def input_specs(cfg, shape_name: str, **overrides) -> Dict[str, torch.Tensor]:
    return batch_specs(cfg, SHAPES[shape_name], **overrides)
