"""The paper's primary contribution: tilted layer fusion (PyTorch), and its
analytic hardware model (:mod:`~repro_torch.core.analysis`, Tables I/II)."""

from repro_torch.core import analysis
from repro_torch.core.analysis import (
    ABPN_CHANNELS,
    PAPER_TABLE2,
    HWConfig,
    buffer_sizes,
    classical_buffer_sizes,
    dram_reduction,
    dram_traffic,
    on_chip_budget_kb,
    pe_throughput_model,
    weight_bytes,
)
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
    "analysis",
    "ABPN_CHANNELS",
    "PAPER_TABLE2",
    "HWConfig",
    "buffer_sizes",
    "classical_buffer_sizes",
    "dram_reduction",
    "dram_traffic",
    "on_chip_budget_kb",
    "pe_throughput_model",
    "weight_bytes",
]
