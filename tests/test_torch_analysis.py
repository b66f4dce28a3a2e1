"""The port's copy of the paper's analytic model (``repro_torch.core.analysis``,
Tables I/II and the 92% DRAM-bandwidth claim) against the JAX package's
``repro.core.analysis``.

The model is pure Python, so every function must return EXACTLY what the
JAX package's returns (dict equality, no tolerance), for ``HWConfig()`` and
for the tile-width sweep of ``tests/test_analysis.py``.  The paper checks of
that file are twinned on the port's module with their own tolerances.
"""

import dataclasses

import jax
import pytest
import torch

from repro.core import analysis as jan

from repro_torch.core import analysis as tan
from repro_torch.models.abpn import init_abpn

TILE_SWEEP = (2, 4, 8, 16, 32, 60)
CONFIGS = [{}] + [dict(tile_cols=c) for c in TILE_SWEEP] + [
    dict(band_rows=120), dict(bytes_per_elem=2, overlap_queue_slots=7),
    dict(channels=(3, 12, 12, 27), lr_height=120, lr_width=64),
]
FUNCTIONS = {
    "weight_bytes": lambda m, cfg: m.weight_bytes(cfg),
    "weight_bytes_no_bias": lambda m, cfg: m.weight_bytes(cfg, include_bias=False),
    "buffer_sizes": lambda m, cfg: m.buffer_sizes(cfg),
    "classical_buffer_sizes": lambda m, cfg: m.classical_buffer_sizes(cfg),
    "dram_traffic_fused": lambda m, cfg: m.dram_traffic(cfg, "fused"),
    "dram_traffic_layerwise": lambda m, cfg: m.dram_traffic(cfg, "layerwise"),
    "on_chip_budget_kb": lambda m, cfg: m.on_chip_budget_kb(cfg),
    "dram_reduction": lambda m, cfg: m.dram_reduction(cfg),
    "pe_throughput_model": lambda m, cfg: m.pe_throughput_model(cfg),
}


def _cfg(module, over):
    return module.HWConfig(**over)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("over", CONFIGS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items())
                         or "default")
def test_model_equals_the_jax_package_exactly(name, over):
    fn = FUNCTIONS[name]
    assert fn(tan, _cfg(tan, over)) == fn(jan, _cfg(jan, over))


def test_constants_and_exports_equal():
    assert tan.ABPN_CHANNELS == jan.ABPN_CHANNELS
    assert tan.PAPER_TABLE2 == jan.PAPER_TABLE2
    assert tan.PAPER_CLAIMS == jan.PAPER_CLAIMS
    assert tan.__all__ == jan.__all__
    assert dataclasses.asdict(tan.HWConfig()) == dataclasses.asdict(jan.HWConfig())
    assert tan.HWConfig().num_macs == jan.HWConfig().num_macs == 1260
    with pytest.raises(ValueError, match="unknown mode"):
        tan.dram_traffic(mode="tiled")


def test_core_package_exports_the_model():
    from repro_torch import core

    assert core.analysis is tan
    assert core.buffer_sizes is tan.buffer_sizes
    assert core.on_chip_budget_kb() == pytest.approx(tan.buffer_sizes()["total_kb"])


# ----------------------------------------------------------------------
# The paper checks of tests/test_analysis.py, on the port's module
# ----------------------------------------------------------------------
def test_table2_tilted_buffers_exact():
    b = tan.buffer_sizes()
    paper = tan.PAPER_TABLE2["tilted"]
    assert b["ping_pong_kb"] == pytest.approx(paper["ping_pong"], abs=1e-9)
    assert b["overlap_kb"] == pytest.approx(paper["overlap"], abs=1e-9)
    assert b["residual_kb"] == pytest.approx(paper["residual"], abs=1e-9)
    assert b["weight_kb"] == pytest.approx(paper["weight"], rel=0.015)
    assert b["total_kb"] == pytest.approx(paper["total"], rel=0.006)


def test_table2_classical_buffers():
    c = tan.classical_buffer_sizes()
    paper = tan.PAPER_TABLE2["classical"]
    assert c["ping_pong_kb"] == pytest.approx(paper["ping_pong"], abs=1e-9)
    assert c["residual_kb"] == pytest.approx(paper["residual"], abs=1e-9)
    assert c["total_kb"] == pytest.approx(paper["total"], rel=0.006)
    assert 0.55 < 1 - tan.buffer_sizes()["total_kb"] / c["total_kb"] < 0.65


def test_dram_bandwidth_reduction_92_percent():
    assert tan.dram_traffic(mode="layerwise")["gb_s"] == pytest.approx(
        tan.PAPER_CLAIMS["dram_layerwise_gb_s"], rel=0.01)
    assert tan.dram_traffic(mode="fused")["gb_s"] == pytest.approx(
        tan.PAPER_CLAIMS["dram_fused_gb_s"], rel=0.03)
    assert tan.dram_reduction() == pytest.approx(tan.PAPER_CLAIMS["dram_reduction"], abs=0.01)


def test_pe_model_reproduces_table1():
    pe = tan.pe_throughput_model()
    assert pe["num_macs"] == tan.PAPER_CLAIMS["num_macs"]
    assert pe["meets_60fps"]
    assert pe["mpix_s_at_target"] == pytest.approx(tan.PAPER_CLAIMS["throughput_mpix_s"], rel=0.001)
    assert pe["utilization"] == pytest.approx(tan.PAPER_CLAIMS["utilization"], abs=0.02)


def test_weight_bytes_matches_the_port_param_count():
    layers = init_abpn(torch.Generator().manual_seed(0))
    params = sum(l.w.numel() + l.b.numel() for l in layers)
    assert tan.weight_bytes() == params  # 8-bit: bytes == params
    from repro.models.abpn import ABPNConfig, init_abpn as jinit, param_count

    assert params == param_count(jinit(jax.random.PRNGKey(0), ABPNConfig()))


def test_tile_width_sweep_monotone():
    totals = []
    for c in TILE_SWEEP:
        b = tan.buffer_sizes(tan.HWConfig(tile_cols=c))
        totals.append(b["total_kb"])
        assert b["overlap_kb"] == tan.buffer_sizes()["overlap_kb"]
    assert totals == sorted(totals)
