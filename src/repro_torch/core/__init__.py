"""The paper's primary contribution: tilted layer fusion (PyTorch)."""

from repro_torch.core.fusion import (
    ConvLayer,
    conv_stack_reference,
    run_banded,
    tilted_fused_band,
)
from repro_torch.core.tiling import TileSchedule, make_schedule

__all__ = [
    "ConvLayer",
    "conv_stack_reference",
    "run_banded",
    "tilted_fused_band",
    "TileSchedule",
    "make_schedule",
]
