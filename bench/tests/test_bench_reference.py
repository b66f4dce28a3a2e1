"""The benchmark's plain reference against the port, on the CPU at small
sizes.  The test may import both; the reference imports nothing of the
port."""

import pytest
import torch

from harness import inputs, registry
from reference import abpn as ref

from repro_torch import engine
from repro_torch.core.fusion import ConvLayer
from repro_torch.models.abpn import depth_to_space


def small_cfg(scale: int, band_rows: int = 30) -> dict:
    return dict(family="abpn", in_channels=3, feature_channels=28, num_layers=7,
                out_channels=3 * scale ** 2, scale=scale, lr_height=60, lr_width=40,
                serving=dict(band_rows=band_rows),
                init=dict(bias_range=0.05, last_layer_std_scale=0.1))


def port(layers, frames, scale, precision="fp32", backend="tilted"):
    stack = [ConvLayer(w=w, b=b, relu=r) for w, b, r in layers]
    plan = engine.make_plan(stack, tuple(frames.shape[1:]), band_rows=30, tile_cols=8,
                            vertical_policy="zero", backend=backend, scale=scale, clip=True,
                            precision=precision)
    return engine.run(plan, stack, frames, device="cpu")


@pytest.mark.parametrize("scale", [3, 4])
def test_reference_is_the_ports_tilted_backend_under_zero(scale):
    cfg = small_cfg(scale)
    family = registry.family(cfg)
    layers = family.make_weights(cfg, 2 ** 31 + 3, "cpu")
    frames = torch.from_numpy(inputs.make_pool(cfg, 2, 2 ** 31 + 3))
    want = family.reference(frames, layers, cfg)
    got = port(layers, frames, scale)
    assert got.shape == want.shape == (2, 60 * scale, 40 * scale, 3)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("scale", [3, 4])
def test_reference_bands_are_not_the_whole_frame(scale):
    """Under ``zero`` each band sees zero rows at its edges: the result
    differs from one convolution over the whole frame near band edges."""
    cfg = small_cfg(scale)
    family = registry.family(cfg)
    layers = family.make_weights(cfg, 5, "cpu")
    frames = torch.from_numpy(inputs.make_pool(cfg, 1, 5))
    banded = family.reference(frames, layers, cfg)
    whole = family.reference(frames, layers, small_cfg(scale, band_rows=60))
    assert (banded - whole).abs().max().item() > 1e-3


def test_depth_to_space_matches_the_ports_convention():
    x = torch.arange(2 * 3 * 4 * 27, dtype=torch.float32).reshape(2, 3, 4, 27)
    assert torch.equal(ref.depth_to_space(x, 3), depth_to_space(x, 3))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -12), 3.0])
    got = ref.tf32_round(x)
    # ties go away from zero (cvt.rna); below half an ulp rounds down
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -1.0, 3.0]
    y = torch.randn(10000)
    assert ((ref.tf32_round(y) - y).abs() <= y.abs() * 2 ** -11).all()


def test_fp8_rounding_error_is_e4m3s():
    y = torch.randn(10000)
    err = (ref.fp8_round(y) - y).abs()
    # normal e4m3 numbers keep 3 mantissa bits: half an ulp is 2**-4 of the value
    big = y.abs() > y.abs().max() / 2 ** 6
    assert (err[big] <= y.abs()[big] * 2 ** -4 * 1.0001).all()
    assert err.max() > 0


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    src = Path(ref.__file__).read_text()
    names = {a.name.split(".")[0] for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "typing", "torch"}
