"""PyTorch port vs the JAX package: geometry, plan, numerics, model helpers
and the plain executors (``repro_torch.core``, ``models``, ``engine.plan``).

Inputs come from ``np.random.default_rng(seed)`` and cross between the
frameworks as numpy arrays.  Tolerances:

* geometry, plans, halo slabs, int8 codes, ``depth_to_space`` and
  ``make_anchor`` — EXACT: integer arithmetic, copies and the same fp32
  division + round-half-to-even on both sides;
* conv executors — max abs diff 5e-4 (the README support matrix's fp32
  bound): both sides accumulate in fp32, in a different order.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jfusion
from repro.core import quant as jquant
from repro.core import tiling as jtiling
from repro.engine import plan as jplan
from repro.models import abpn as jabpn
from repro.models import registry as jregistry

from repro_torch.core import fusion as tfusion
from repro_torch.core import quant as tquant
from repro_torch.core import tiling as ttiling
from repro_torch.engine import plan as tplan
from repro_torch.models import abpn as tabpn
from repro_torch.models import registry as tregistry

torch.set_num_threads(2)

FP32_TOL = 5e-4  # README support matrix: fp32 max abs diff


def np_stack(seed, channels, scale=0.2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(channels) - 1):
        w = (rng.normal(size=(3, 3, channels[i], channels[i + 1])) * scale).astype(np.float32)
        b = (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32)
        out.append((w, b, i < len(channels) - 2))
    return out


def both_stacks(seed, channels):
    arrays = np_stack(seed, channels)
    jl = [jfusion.ConvLayer(w=jnp.asarray(w), b=jnp.asarray(b), relu=r) for w, b, r in arrays]
    return jl, tabpn.layers_from_numpy(arrays)


# ----------------------------------------------------------------------
# Geometry (the tests/test_tiling.py cases)
# ----------------------------------------------------------------------
SCHEDULES = [(640, 8, 7), (4, 2, 1), (37, 8, 3), (300, 32, 12), (61, 5, 9), (24, 4, 3)]


@pytest.mark.parametrize("width,tile,layers", SCHEDULES)
def test_tile_schedule_equal(width, tile, layers):
    j = jtiling.make_schedule(width, tile, layers)
    t = ttiling.make_schedule(width, tile, layers)
    t.check_invariants()
    assert (t.width, t.tile_cols, t.num_layers) == (j.width, j.tile_cols, j.num_layers)
    assert t.num_tiles == j.num_tiles and t.final_offset == j.final_offset
    assert t.table() == j.table()
    assert [t.fresh_input_cols(k) for k in range(t.num_tiles)] == \
        [j.fresh_input_cols(k) for k in range(j.num_tiles)]


def test_phantom_mask_and_invalid_schedule():
    np.testing.assert_array_equal(ttiling.phantom_mask(-2, 6, 3), jtiling.phantom_mask(-2, 6, 3))
    with pytest.raises(ValueError):
        ttiling.TileSchedule(width=0, tile_cols=8, num_layers=7)


# ----------------------------------------------------------------------
# Plans
# ----------------------------------------------------------------------
def test_band_rows_helpers_equal():
    for h in range(1, 400):
        assert tplan.legal_band_rows(h) == jplan.legal_band_rows(h)
        assert tplan.derive_band_rows(h) == jplan.derive_band_rows(h)
        for s in (1, 2, 3, 4):
            assert tplan.shardable_band_rows(h, s) == jplan.shardable_band_rows(h, s)


PLAN_CASES = [
    dict(lr_shape=(360, 640, 3), num_layers=7),
    dict(lr_shape=(180, 320, 3), num_layers=7, backend="kernel", precision="bf16"),
    dict(lr_shape=(61, 40, 3), num_layers=7, vertical_policy="halo"),
    dict(lr_shape=(24, 32, 3), num_layers=3, tile_cols=4, precision="int8", scale=2),
    dict(lr_shape=(120, 64, 3), num_layers=7, band_rows=40, backend="reference"),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: str(c["lr_shape"]))
def test_srplan_fields_equal(case):
    case = dict(case)
    shape = case.pop("lr_shape")
    with warnings.catch_warnings():  # the 61-row one-band fallback warns
        warnings.simplefilter("ignore", RuntimeWarning)
        j = jplan.SRPlan.from_request(shape, **case)
        t = tplan.SRPlan.from_request(shape, **case)
    fields = [f.name for f in j.__dataclass_fields__.values()]
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    assert (t.num_bands, t.lr_shape, t.hr_shape, t.stack_key) == \
        (j.num_bands, j.lr_shape, j.hr_shape, j.stack_key)
    assert t.schedule.table() == j.schedule.table()


def test_make_plan_and_plan_errors_equal():
    jl, tl = both_stacks(0, [3, 12, 12, 12])
    kw = dict(band_rows=20, tile_cols=4, scale=2, vertical_policy="replicate", backend="kernel")
    assert tplan.make_plan(tl, (40, 24, 3), **kw) == _as_port(jplan.make_plan(jl, (40, 24, 3), **kw))
    for bad in (dict(band_rows=7), dict(tile_cols=1), dict(backend="x"), dict(precision="fp8")):
        args = {**kw, **bad}
        with pytest.raises(ValueError):
            jplan.make_plan(jl, (40, 24, 3), **args)
        with pytest.raises(ValueError):
            tplan.make_plan(tl, (40, 24, 3), **args)
    with pytest.raises(ValueError):
        tplan.make_plan(tl, (40, 24, 4), **kw)  # channel mismatch
    # static verification runs on the port's plan as on the JAX package's
    tfind = tplan.make_plan(tl, (40, 24, 3), **kw).verify()
    jfind = jplan.make_plan(jl, (40, 24, 3), **kw).verify()
    assert [(f.rule, f.severity) for f in tfind] == [(f.rule, f.severity) for f in jfind]


def _as_port(p):
    return tplan.SRPlan(**{f: getattr(p, f) for f in p.__dataclass_fields__})


# ----------------------------------------------------------------------
# Halo slabs, quantisation, model helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,rows,layers", [((2, 40, 24, 3), 20, 3), ((1, 61, 8, 3), 61, 7),
                                               ((1, 360, 16, 3), 60, 7)])
def test_halo_slabs_equal(shape, rows, layers):
    frames = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    js, jb = jfusion.halo_slabs(jnp.asarray(frames), rows, layers)
    ts, tb = tfusion.halo_slabs(torch.from_numpy(frames), rows, layers)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.dtype == torch.int32


def test_quantize_layers_codes_equal():
    arrays = np_stack(2, [3, 28, 28, 27], scale=0.5)
    jl = [jfusion.ConvLayer(w=jnp.asarray(w), b=jnp.asarray(b), relu=r) for w, b, r in arrays]
    tl = tabpn.layers_from_numpy(arrays)
    for jq, tq in zip(jquant.quantize_layers(jl), tquant.quantize_layers(tl)):
        np.testing.assert_array_equal(tq.wq.numpy(), np.asarray(jq.wq))
        np.testing.assert_array_equal(tq.bq.numpy(), np.asarray(jq.bq))
        np.testing.assert_array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale))
        np.testing.assert_array_equal(tq.b_scale.numpy(), np.asarray(jq.b_scale))
    for jd, td in zip(jquant.dequantize_layers(jquant.quantize_layers(jl)),
                      tquant.dequantize_layers(tquant.quantize_layers(tl))):
        np.testing.assert_array_equal(td.w.numpy(), np.asarray(jd.w))
        np.testing.assert_array_equal(td.b.numpy(), np.asarray(jd.b))
    x = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    jq, js = jquant.quantize(jnp.asarray(x))
    tq, ts = tquant.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tquant.fake_quant(torch.from_numpy(x)).numpy(),
                                  np.asarray(jquant.fake_quant(jnp.asarray(x))))


@pytest.mark.parametrize("scale", [2, 3])
def test_depth_to_space_and_anchor_exact(scale):
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(5, 7, 3 * scale * scale)).astype(np.float32)
    np.testing.assert_array_equal(tabpn.depth_to_space(torch.from_numpy(x), scale).numpy(),
                                  np.asarray(jabpn.depth_to_space(jnp.asarray(x), scale)))
    lr = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    anchor = tabpn.make_anchor(torch.from_numpy(lr), scale)
    np.testing.assert_array_equal(anchor.numpy(), np.asarray(jabpn.make_anchor(jnp.asarray(lr), scale)))
    # batched depth_to_space equals the per-frame one
    xb = torch.from_numpy(rng.uniform(size=(2, 5, 7, 3 * scale * scale)).astype(np.float32))
    torch.testing.assert_close(tabpn.depth_to_space(xb, scale)[1],
                               tabpn.depth_to_space(xb[1], scale), rtol=0, atol=0)


def test_abpn_config_registry_and_init():
    assert tabpn.ABPNConfig().channels == jabpn.ABPNConfig().channels
    # the JAX package's models, and RLFN x4, which the port alone serves
    assert set(tregistry.list_sr_models()) == set(jregistry.list_sr_models()) | {"rlfn_x4"}
    for name in ("abpn_x3", "abpn-x3", "abpn"):
        assert tregistry.get_sr_model(name).name == jregistry.get_sr_model(name).name
    with pytest.raises(ValueError, match="did you mean"):
        tregistry.get_sr_model("abpn-3x")
    layers = tabpn.init_abpn(torch.Generator().manual_seed(0))
    again = tabpn.init_abpn(torch.Generator().manual_seed(0))
    assert [tuple(l.w.shape) for l in layers] == \
        [(3, 3, a, b) for a, b in zip(tabpn.ABPNConfig().channels, tabpn.ABPNConfig().channels[1:])]
    assert all(torch.equal(a.w, b.w) for a, b in zip(layers, again))
    assert [l.relu for l in layers] == [True] * 6 + [False]
    assert tabpn.param_count(layers) == jabpn.param_count(jabpn.init_abpn(jax.random.PRNGKey(0)))


# ----------------------------------------------------------------------
# Plain executors vs JAX
# ----------------------------------------------------------------------
def test_conv_stack_reference_matches_jax():
    jl, tl = both_stacks(5, [3, 12, 12, 12])
    img = np.random.default_rng(6).uniform(size=(30, 26, 3)).astype(np.float32)
    j = jfusion.conv_stack_reference(jnp.asarray(img), jl)
    t = tfusion.conv_stack_reference(torch.from_numpy(img), tl)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("row_pad,row_valid", [("zero", None), ("replicate", None), ("zero", (3, 15))])
def test_tilted_fused_band_matches_jax(row_pad, row_valid):
    jl, tl = both_stacks(7, [3, 12, 12, 12])
    band = np.random.default_rng(8).uniform(size=(20, 24, 3)).astype(np.float32)
    j = jfusion.tilted_fused_band(jnp.asarray(band), jl, 4, row_pad=row_pad, row_valid=row_valid)
    t = tfusion.tilted_fused_band(torch.from_numpy(band), tl, 4, row_pad=row_pad, row_valid=row_valid)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
def test_run_banded_matches_jax(policy):
    jl, tl = both_stacks(9, [3, 12, 12, 12])
    img = np.random.default_rng(10).uniform(size=(40, 24, 3)).astype(np.float32)
    j = jfusion.run_banded(jnp.asarray(img), jl, band_rows=20, tile_cols=4, vertical_policy=policy)
    t = tfusion.run_banded(torch.from_numpy(img), tl, band_rows=20, tile_cols=4, vertical_policy=policy)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=FP32_TOL, rtol=0)
    if policy == "halo":  # halo is exact vs the full-image reference
        full = tfusion.conv_stack_reference(torch.from_numpy(img), tl)
        np.testing.assert_allclose(t.numpy(), full.numpy(), atol=1e-5, rtol=0)
