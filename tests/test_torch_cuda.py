"""The CUDA kernels on the card vs their plain versions: K1 (tilted fusion)
and K2 (one SAME 3x3 conv layer), and the serving path on the card vs the
same path on the CPU.  The LM serving path (qwen2-0.5b's widths cut to 2
layers, fp32): decode after prefill vs ``forward``, and prefill on the card
vs the CPU, at the reference's ``atol 2e-4, rtol 1e-3``.  LM training: the
flash backward on the card vs the CPU (qwen2-0.5b's head layout, one and
four KV chunks, ``atol 5e-5, rtol 1e-3``), and one train step of the same
2-layer cut on the card vs the CPU.  The encoder-decoder model (seamless-m4t-large-v2
reduced, fp32): prefill and decode on the card vs the CPU at the same
tolerance.  The int8 error-feedback all-reduce on a ``(data=4,)`` mesh of
the card's streams vs the same positions on the CPU (the mean within one
quantum of the CPU's: a product ``x / scale`` may round differently).  K1's
column segments must not change a bit of its output (``torch.equal``
across segment counts).  ``engine.plan_cost`` counts K1 on the card with
the launch's own segment plan.

Every test here needs a CUDA device and skips where none is present: the
CUDA kernel has no CPU mode.  The file imports torch and the PyTorch
package only, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 and the server, max abs diff fp32 5e-4 and bf16 5e-2, the
README support matrix's — fp32 sums in another order, bf16 feature maps
rounded per layer on both sides.  K2, the JAX package's own K2 tolerances:
fp32 ``atol 2e-5, rtol 1e-5`` (3xTF32 on the tensor cores keeps ~22 bits
of each product, summed in another order) and bf16 ``atol = rtol = 2e-2``
(one rounding at the store, so at most one ulp).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.kernels import conv3x3 as tk2
from repro_torch.kernels import ops
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.models.abpn import ABPNConfig, init_abpn, layers_from_numpy

TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
K2_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stack(seed, channels, scale=0.2):
    """Seeded layers; ``scale=None`` takes He's ``sqrt(2 / (9 Ci))``, which
    keeps the features of a wide stack near 1 (0.2 grows them ~7x a layer
    at 128 channels, past what bf16 holds to 5e-2)."""
    rng = np.random.default_rng(seed)
    return layers_from_numpy([
        ((rng.normal(size=(3, 3, channels[i], channels[i + 1]))
          * (scale or (2.0 / (9 * channels[i])) ** 0.5)).astype(np.float32),
         (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
         i < len(channels) - 2)
        for i in range(len(channels) - 1)
    ])


# K1's stacks by the instance they launch: Chp 8 and 24 pad to the 16 and
# 32 instances, 40 to 48; 48 (ABPN x4's width), 64, 96 and 128 are wide
# instances as packed.  The narrow ones keep their 0.2 weights, the wide
# ones take He's scale.
K1_STACKS = {
    "chp16": ([3, 12, 12, 12], 0.2), "chp32": ([3, 28, 28, 27], 0.2),
    "chp8": ([3, 8, 8, 6], 0.2), "chp24": ([3, 20, 24, 18], 0.2),
    "chp40": ([3, 40, 36, 40], None), "chp48": ([3, 28, 28, 48], None),
    "chp64": ([3, 64, 60, 64], None), "chp96": ([3, 96, 80, 90], None),
    "chp128": ([3, 128, 128, 120], None),
}


@pytest.mark.parametrize("dtype,spread", [(torch.float32, "unit"), (torch.bfloat16, "unit"),
                                          (torch.float32, "wide")],
                         ids=["fp32", "bf16", "fp32_wide"])
@pytest.mark.parametrize("rows", [20, 61])
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo_bounds"])
@pytest.mark.parametrize("stack", list(K1_STACKS))
def test_kernel_matches_plain(cuda, stack, policy, rows, dtype, spread):
    """``wide``: pixels from 1e-3 to 10 of their unit value, where single
    TF32 misses 5e-4 and 3xTF32 holds it (tests/test_torch_k1_tensor_cores.py
    emulates both on these inputs).  61 rows are three row blocks."""
    channels, scale = K1_STACKS[stack]
    layers = [l.to(dtype=dtype) for l in _stack(1, channels, scale)]
    packed = ops.pack_stack(layers, dtype=dtype)
    gen = torch.Generator().manual_seed(2)
    xb = torch.rand((3, rows, 37, 3), generator=gen)
    if spread == "wide":
        xb = xb * 10.0 ** (torch.rand(xb.shape, generator=gen) * 4 - 3)
    xb = xb.to(dtype)
    xs, first = ops.band_streams(xb, 4, len(layers))
    bounds = None
    if policy == "halo_bounds":
        bounds = torch.tensor([[2, rows - 3], [0, rows], [5, 9]], dtype=torch.int32)
    kw = dict(width=37, tile_cols=4, relu_flags=list(packed.relu), add_anchor=True,
              in_channels=3, anchor_repeats=4 if channels[-1] == 12 else min(9, channels[-1] // 3),
              row_policy="replicate" if policy == "replicate" else "zero")
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=bounds, **kw)
    launches = ttf.tilted_fusion_call.launches
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    kw["row_bounds"] = None if bounds is None else bounds.to(cuda)
    got = ttf.tilted_fusion_call(*args, **kw)
    torch.cuda.synchronize()
    assert ttf.tilted_fusion_call.launches == launches + 1
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    # column segments change no bit of the output
    K = xs.shape[2] // 4
    one = ttf.tilted_fusion_call(*args, segments=1, **kw)
    for segments in (2, 3, None, K):
        assert torch.equal(ttf.tilted_fusion_call(*args, segments=segments, **kw), one), segments
    assert torch.equal(got, one)


# A mixed launch: 28 hidden channels (the Chp 32 instance), the last layer's
# outputs in groups of 32 (40 and 48 pad to 48: 32 + 16).  ABPN x4 is 48.
MIXED_OUTPUTS = (40, 48, 64, 96, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo_bounds"])
@pytest.mark.parametrize("out", MIXED_OUTPUTS)
def test_mixed_launch_matches_plain_and_the_wide_instance(cuda, out, policy, dtype):
    """[3, 28, 28, out] stacks with ``hidden_channels`` (the serving
    path's call): the mixed launch against the plain version, bit for bit
    the Chp ``out`` instance on the same packed stack (``hidden_channels=
    None``), and the same for every segment count; the anchor covers every
    output group (``out // 3`` repeats)."""
    layers = [l.to(dtype=dtype) for l in _stack(4, [3, 28, 28, out], None)]
    packed = ops.pack_stack(layers, dtype=dtype)
    assert packed.hidden_channels == 28
    assert ttf.hidden_chp(packed.chp, 28, 8, dtype) == 32 < ttf.launch_chp(packed.chp)
    gen = torch.Generator().manual_seed(5)
    xb = torch.rand((3, 61, 37, 3), generator=gen).to(dtype)
    xs, first = ops.band_streams(xb, 4, len(layers))
    bounds = None
    if policy == "halo_bounds":
        bounds = torch.tensor([[2, 58], [0, 61], [5, 9]], dtype=torch.int32)
    kw = dict(width=37, tile_cols=4, relu_flags=list(packed.relu), add_anchor=True,
              in_channels=3, anchor_repeats=out // 3,
              row_policy="replicate" if policy == "replicate" else "zero")
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=bounds, **kw)
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    kw["row_bounds"] = None if bounds is None else bounds.to(cuda)
    launches = ttf.tilted_fusion_call.launches
    got = ttf.tilted_fusion_call(*args, hidden_channels=28, **kw)
    torch.cuda.synchronize()
    assert ttf.tilted_fusion_call.launches == launches + 1
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    assert torch.equal(got, ttf.tilted_fusion_call(*args, **kw))  # the wide instance
    K = xs.shape[2] // 4
    for segments in (1, 2, 3, K):
        assert torch.equal(ttf.tilted_fusion_call(*args, hidden_channels=28, segments=segments,
                                                  **kw), got), segments


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("out", [48, 96])
def test_mixed_launch_of_one_layer(cuda, out, dtype):
    """A single 3 -> ``out`` layer: ``pack_stack`` records its input width
    as the hidden one, so layer 0 is the last layer and runs in output
    groups from the input stream; against plain and the Chp ``out``
    instance."""
    layers = [l.to(dtype=dtype) for l in _stack(9, [3, out], None)]
    packed = ops.pack_stack(layers, dtype=dtype)
    assert packed.hidden_channels == 3 and ttf.hidden_chp(packed.chp, 3, 8, dtype) == 32
    xb = torch.rand((2, 33, 29, 3), generator=torch.Generator().manual_seed(10))
    xs, first = ops.band_streams(xb.to(dtype), 8, 1)
    kw = dict(width=29, tile_cols=8, relu_flags=[False], add_anchor=True, in_channels=3,
              anchor_repeats=out // 3)
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw)
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    got = ttf.tilted_fusion_call(*args, hidden_channels=3, **kw)
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    assert torch.equal(got, ttf.tilted_fusion_call(*args, **kw))
    assert torch.equal(got, ttf.tilted_fusion_call(*args, hidden_channels=3, segments=2, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("stack", ["x3", "x4"])
@pytest.mark.parametrize("rows", [20, 60, 61, 74, 86, 360])
def test_k1_route_by_band_height(cuda, rows, stack, dtype, monkeypatch):
    """The narrow launch (ABPN x3's shape) and the mixed one (ABPN x4's) at
    band heights of 20, 60, 61 and 74 rows keep a tile's feature maps in
    shared memory (the on-chip route) and allocate no slab in device
    memory, only the overlap queue; an 86-row halo slab (72-row bands) and
    a one-band 360-row fallback take the device-memory route.  The launch
    takes the route the wrapper picks (``ttf.route``, which
    ``kernel_buffers`` reports); each launch holds to the plain version,
    under ``halo`` row bounds too, and every segment count gives the same
    bits.  A launch told to keep maps on chip that do not fit fails."""
    from repro_torch.models.abpn import ABPNConfig

    channels = ABPNConfig(scale=4 if stack == "x4" else 3).channels
    layers = [l.to(dtype=dtype) for l in _stack(12, channels, None)]
    packed = ops.pack_stack(layers, dtype=dtype)
    hid = ttf.hidden_chp(packed.chp, packed.hidden_channels, 8, dtype)
    assert hid == (32 if stack == "x4" else None)
    rt = ttf.route(rows, 8, packed.chp, dtype, hid)
    assert rt.onchip == (rows <= 74)
    kb = ttf.kernel_buffers(channels=channels, band_rows=rows, tile_cols=8, dtype=dtype)
    assert (kb["route"], kb["shared_bytes"]) == (rt.name, rt.shared_bytes)
    assert (kb["device_slab_elements"] == 0) == rt.onchip
    bands, width = (1, 40) if rows == 360 else (2, 48)
    xb = torch.rand((bands, rows, width, 3), generator=torch.Generator().manual_seed(rows))
    xs, first = ops.band_streams(xb.to(dtype), 8, len(layers))
    bounds = torch.tensor([[3, rows - 2]] * bands, dtype=torch.int32)
    kw = dict(width=width, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
              in_channels=3, hidden_channels=packed.hidden_channels)
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    for row_bounds in (None, bounds):
        want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=row_bounds,
                                       **kw)
        rb = None if row_bounds is None else row_bounds.to(cuda)
        got = ttf.tilted_fusion_call(*args, row_bounds=rb, **kw)
        torch.cuda.synchronize()
        last = ttf.tilted_fusion_call.last_launch
        assert (last["route"], last["shared_bytes"]) == (rt.name, rt.shared_bytes)
        plan = ttf.launch_plan(args[0], args[2], tile_cols=8, compute_dtype=dtype,
                               hidden_channels=packed.hidden_channels)
        L, inst = len(layers), hid or packed.chp
        queue = 2 * (L - 1) * rows * 2 * inst  # the overlap queue, per CTA
        slabs = 0 if rt.onchip else 2 * rows * 8 * inst
        head = ttf.packed_weight_bytes(L, ttf.launch_chp(packed.chp, dtype), 8, dtype,
                                       hidden_chp=hid, onchip=rt.onchip)
        assert last["workspace_bytes"] == head + plan.ctas * (queue + slabs) * dtype.itemsize
        np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                                   atol=TOL[dtype], rtol=0)
        K = xs.shape[2] // 8
        for segments in (1, 3, K):
            assert torch.equal(ttf.tilted_fusion_call(*args, row_bounds=rb, segments=segments,
                                                      **kw), got), segments
    if not rt.onchip:
        monkeypatch.setattr(ttf, "route", lambda *a, **k: ttf.Route(True, rt.shared_bytes))
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue|invalid argument"):
            ttf.tilted_fusion_call(*args, **kw)


def test_mixed_launch_plans_on_the_narrow_instance(cuda):
    """ABPN x4's launch at one 360x640 frame: the segment plan and the
    ``plan_cost`` count of the card take the Chp 32 instance's CTAs per SM
    and count the hidden layers at 32 channels."""
    from repro_torch.models.abpn import ABPNConfig

    layers = [l.to(device=cuda) for l in _stack(8, ABPNConfig(scale=4).channels, None)]
    packed = ops.pack_stack(layers)
    xs, first = ops.band_streams(torch.rand((6, 60, 640, 3), device=cuda), 8, 7)
    plan = ttf.launch_plan(xs, packed.w, tile_cols=8, hidden_channels=packed.hidden_channels)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = ttf.segment_plan(6, 81, 8, 7, sms, ttf.blocks_per_sm(cuda, torch.float32, 32))
    assert plan == want
    sr = engine.make_plan(layers, (360, 640, 3), backend="kernel", band_rows=60, scale=4)
    (k1,) = engine.plan_cost_terms(sr, layers, 1)["k1"]
    assert k1["plan"] == plan
    assert k1["flops"] == ttf.launch_cost(plan, band_rows=60, tile_cols=8, c0p=8, chp=48,
                                          num_layers=7, dtype=torch.float32,
                                          hidden_chp=32)["flops"]


def test_auto_plan_fills_the_card_at_one_frame(cuda):
    """One 360x640 frame of ABPN x3: 6 bands of 81 tiles."""
    layers = [l.to(device=cuda) for l in init_abpn(torch.Generator().manual_seed(0))]
    packed = ops.pack_stack(layers)
    xb = torch.rand((6, 60, 640, 3), generator=torch.Generator().manual_seed(9)).to(cuda)
    xs, first = ops.band_streams(xb, 8, 7)
    plan = ttf.launch_plan(xs, packed.w, tile_cols=8)
    assert plan.tiles == 81 and plan.ctas >= 100
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    assert plan.ctas <= sms * ttf.blocks_per_sm(xs.device, torch.float32, 32)  # one wave
    kw = dict(width=640, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
              in_channels=3)
    got = ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw)
    assert torch.equal(got, ttf.tilted_fusion_call(xs, first, packed.w, packed.b, segments=1,
                                                   **kw))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_plan_cost_counts_k1_on_the_card_as_the_plain_version_at_c0p(cuda, policy, precision):
    """``plan_cost``'s K1 term on the card is the launch's own segment plan
    (``launch_plan`` on a stream of the same shape), and its FLOPs are the
    plain version's for that plan (a ``meta`` trace of
    ``tilted_fusion_plain`` with the same segments) with layer 0 over c0p
    = 8 input channels padded to the MMA's k (8 in fp32, 16 in bf16) in
    place of Chp = 32.  Two 120x128 frames: 4 bands of 17 tiles; 60 and 74
    rows, both even, so no row is added."""
    from repro_torch.roofline.trace_cost import trace_cost

    layers = [l.to(device=cuda) for l in init_abpn(torch.Generator().manual_seed(0))]
    plan = engine.make_plan(layers, (120, 128, 3), backend="kernel", precision=precision,
                            vertical_policy=policy, band_rows=60, scale=3)
    (k1,) = engine.plan_cost_terms(plan, layers, 2)["k1"]
    rows = 74 if policy == "halo" else 60
    dtype = engine.compute_dtype_for(precision)
    stream = torch.empty((4, rows, 17 * 8, 8), dtype=dtype, device=cuda)
    w = torch.empty((7, 3, 3, 32, 32), dtype=dtype, device=cuda)
    assert k1["plan"] == ttf.launch_plan(stream, w, tile_cols=8)
    meta = dict(dtype=dtype, device="meta")
    extra = {}
    if policy == "halo":
        extra["row_bounds"] = torch.empty((4, 2), dtype=torch.int32, device="meta")
    traced = trace_cost(
        ttf.tilted_fusion_plain, torch.empty((4, rows, 17 * 8, 8), **meta),
        torch.empty((4, rows, 1, 8), **meta), torch.empty((7, 3, 3, 32, 32), **meta),
        torch.empty((7, 32), **meta), width=128, tile_cols=8, relu_flags=[True] * 6 + [False],
        add_anchor=False, in_channels=3, segments=k1["plan"].segments, **extra)
    k0 = 16 if precision == "bf16" else 8  # layer 0's K on the tensor cores
    padding = k1["tiles"] * 2 * rows * 8 * 9 * 32 * (32 - k0)  # layer 0, every executed tile
    assert k1["flops"] == traced.flops - padding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tilted_chp_128_lane_padding(cuda, dtype):
    """Card twin of ``tests/test_kernels.py::test_tilted_chp_128_lane_padding``:
    a [3, 28, 28, 27] stack packed to Chp 128 runs the widest instance and
    gives the plain version's result at that test's tolerances (fp32; bf16
    at 5e-2), and the Chp 32 instance's bit for bit: the extra channels
    are zeros, whose k-steps add exact zeros to each element's sum."""
    layers = [l.to(device=cuda, dtype=dtype) for l in _stack(6, [3, 28, 28, 27])]
    img = torch.rand((30, 32, 3), generator=torch.Generator().manual_seed(7)).to(cuda, dtype)
    launches = ttf.tilted_fusion_call.launches
    got = ops.tilted_fused_stack(img, layers, band_rows=30, tile_cols=8, chp=128)
    narrow = ops.tilted_fused_stack(img, layers, band_rows=30, tile_cols=8)
    torch.cuda.synchronize()
    assert ttf.tilted_fusion_call.launches == launches + 2
    want = ops.tilted_fused_stack(img.cpu(), [l.to(device="cpu") for l in layers],
                                  band_rows=30, tile_cols=8, chp=128)
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(), **tol)
    assert torch.equal(got, narrow)


def _property_cases(n=8, seed=11):
    """Seeded draws over the ranges of ``test_tilted_fused_property``:
    (width 6-40, tile 2-8, depth 1-4, ch 1-8, bands 1-2, rows 4-10)."""
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in (rng.integers(6, 41), rng.integers(2, 9), rng.integers(1, 5),
                                   rng.integers(1, 9), rng.integers(1, 3), rng.integers(4, 11)))
            for _ in range(n)]


@pytest.mark.parametrize("width,tile,depth,ch,bands,rows", _property_cases())
def test_tilted_fused_property(cuda, width, tile, depth, ch, bands, rows):
    """Card twin of ``tests/test_kernels.py::test_tilted_fused_property``
    (``ch`` 1-8: Chp 8, launched on the Chp 16 instance): the kernel
    against the plain version at that test's tolerances."""
    layers = _stack(depth * 7 + ch, [3] + [ch] * depth)
    img = torch.rand((bands * rows, width, 3), generator=torch.Generator().manual_seed(11))
    want = ops.tilted_fused_stack(img, layers, band_rows=rows, tile_cols=tile)
    launches = ttf.tilted_fusion_call.launches
    got = ops.tilted_fused_stack(img.to(cuda), [l.to(device=cuda) for l in layers],
                                 band_rows=rows, tile_cols=tile)
    torch.cuda.synchronize()
    assert ttf.tilted_fusion_call.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=3e-5, rtol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    layers = _stack(3, [3, 136, 12])  # chp 136: no kernel instance (the widest is 128)
    packed = ops.pack_stack([l.to(device=cuda) for l in layers])
    xs, first = ops.band_streams(torch.rand((1, 8, 16, 3), device=cuda), 4, 2)
    packed12 = ops.pack_stack([l.to(device=cuda) for l in _stack(3, [3, 12, 12])])
    launches = ttf.tilted_fusion_call.launches
    with pytest.raises(ValueError, match="segments"):
        ttf.tilted_fusion_call(xs, first, packed12.w, packed12.b, width=16, tile_cols=4,
                               relu_flags=[True, False], add_anchor=False, in_channels=3,
                               segments=0)
    assert ttf.tilted_fusion_call.launches == launches
    with pytest.raises(ValueError, match="widest instance"):
        ttf.tilted_fusion_call(xs, first, packed.w, packed.b, width=16, tile_cols=4,
                               relu_flags=[True, False], add_anchor=False, in_channels=3)
    wide = ttf.MAX_TILE_COLS + 1  # no 3-row window of this width fits shared memory
    xw, fw = ops.band_streams(torch.rand((1, 8, 2 * wide, 3), device=cuda), wide, 2)
    with pytest.raises(ValueError, match="tile_cols"):
        ttf.tilted_fusion_call(xw, fw, packed12.w, packed12.b, width=2 * wide, tile_cols=wide,
                               relu_flags=[True, False], add_anchor=False, in_channels=3)
    assert ttf.tilted_fusion_call.launches == launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        packed16 = ops.pack_stack([l.to(device=cuda) for l in _stack(3, [3, 12, 12])])
        ttf.tilted_fusion_call(xs.half(), first.half(), packed16.w.half(), packed16.b.half(),
                               width=16, tile_cols=4, relu_flags=[True, False],
                               add_anchor=False, in_channels=3)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_server_on_the_card_matches_the_cpu(cuda, precision):
    layers = init_abpn(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    frames = rng.uniform(size=(3, 40, 48, 3)).astype(np.float32)
    out = {}
    for device in ("cpu", cuda):
        server = engine.SRServer.open("abpn_x3", backend="kernel", precision=precision,
                                      device=device, layers=layers)
        before = ttf.tilted_fusion_call.launches
        out[str(device)] = server.submit(frames).result().cpu()
        launched = ttf.tilted_fusion_call.launches - before
        server.close()
        assert launched == (0 if device == "cpu" else 2)  # warm-up + dispatch
    tol = 5e-2 if precision == "bf16" else 5e-4
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(), atol=tol, rtol=0)


# ----------------------------------------------------------------------
# K1's wide instances on ABPN x3's shape at wider feature maps
# ----------------------------------------------------------------------
def _abpn_at(features, seed):
    """ABPN x3 with ``features`` feature channels (3 -> F x6 -> 27), He
    weights."""
    return _stack(seed, [3] + [features] * 6 + [27], None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("features", [48, 64, 96, 128])
def test_wide_instance_on_abpn_shaped_stacks_matches_plain(cuda, features, dtype):
    """The wide Chp F instance (its ``wide_schedule``: n-groups, slices of
    taps or half a tap) on ABPN x3 at F features over two 61-row bands
    (three row blocks a step) of 40 columns, ``zero``: within the
    tolerance of the plain version, and bit-identical across segments."""
    layers = [l.to(dtype=dtype) for l in _abpn_at(features, features)]
    packed = ops.pack_stack(layers, dtype=dtype)
    assert packed.chp == features and ttf.launch_chp(features, dtype) == features
    xb = torch.rand((2, 61, 40, 3), generator=torch.Generator().manual_seed(features)).to(dtype)
    xs, first = ops.band_streams(xb, 8, 7)
    kw = dict(width=40, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
              in_channels=3, hidden_channels=packed.hidden_channels)
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw)
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    got = ttf.tilted_fusion_call(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    for segments in (1, 3):
        assert torch.equal(ttf.tilted_fusion_call(*args, segments=segments, **kw), got)


def test_wide_instances_hold_the_ctas_their_schedule_claims(cuda):
    """Every wide instance fits as many resident CTAs an SM as its
    ``wide_schedule`` is compiled for (two where it claims two: its shared
    memory and its registers both fit), and the segment plan reads them."""
    for dtype in (torch.float32, torch.bfloat16):
        for chp in (48, 64, 96, 128):
            sched = ttf.wide_schedule(chp, dtype)
            assert ttf.blocks_per_sm(cuda, dtype, chp) == sched.ctas, (dtype, chp)
    xs = torch.zeros((6, 60, 640, 8), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((7, 3, 3, 64, 64), device=cuda, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ttf.launch_plan(xs, w, tile_cols=8)
    assert plan == ttf.segment_plan(6, 80, 8, 7, sms, ttf.wide_schedule(64, torch.bfloat16).ctas)


@pytest.mark.parametrize("precision,policy", [("fp32", "zero"), ("bf16", "zero"),
                                              ("int8", "zero"), ("fp32", "halo")])
def test_server_at_64_features_matches_tilted_on_the_card(cuda, precision, policy):
    """``SRServer.open("abpn_x3", layers=<ABPN x3 at 64 features>,
    backend="kernel")`` on the card: K1's wide Chp 64 instance (the
    prepared stack makes no mixed launch) serving two 60 x 64 frames, held
    to the ``tilted`` backend on the card; a frame served alone equals its
    batch twin."""
    layers = _abpn_at(64, 9)
    frames = np.random.default_rng(5).uniform(size=(2, 60, 64, 3)).astype(np.float32)
    plan = engine.make_plan(layers, (60, 64, 3), backend="kernel", precision=precision,
                            vertical_policy=policy, band_rows=30)
    packed = engine.prepare_stack(plan, layers).packed
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    assert packed.chp == 64 and ttf.hidden_chp(64, packed.hidden_channels, 8, dt) is None
    server = engine.SRServer.open("abpn_x3", backend="kernel", precision=precision,
                                  vertical_policy=policy, layers=layers, device=cuda,
                                  band_rows=30)
    before = ttf.tilted_fusion_call.launches
    hr = server.submit(frames).result()
    alone = server.submit(frames[1]).result()
    server.close()
    assert ttf.tilted_fusion_call.launches > before
    assert torch.equal(alone, hr[1])
    tplan = engine.make_plan(layers, (60, 64, 3), backend="tilted", precision=precision,
                             vertical_policy=policy, band_rows=30)
    want = engine.run(tplan, layers, frames, device=cuda)
    np.testing.assert_allclose(hr.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=5e-2 if precision == "bf16" else 5e-4, rtol=0)


# ----------------------------------------------------------------------
# K2: conv3x3 on the card vs conv3x3_plain
# ----------------------------------------------------------------------
def _k2_inputs(seed, shape, co, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, shape[2], co)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(co,)) * 0.1).astype(np.float32))
    return x, w.to(dtype), b.to(dtype)


def _k2_check(cuda, x, w, b, *, tile_cols, relu):
    want = tk2.conv3x3_plain(x, w, b, tile_cols=tile_cols, relu=relu)
    launches = tk2.conv3x3_call.launches
    got = tk2.conv3x3_call(x.to(cuda), w.to(cuda), b.to(cuda), tile_cols=tile_cols, relu=relu)
    torch.cuda.synchronize()
    assert tk2.conv3x3_call.launches == launches + 1
    assert got.dtype == x.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               **K2_TOL[x.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [60, 360])
@pytest.mark.parametrize("ci,co,relu", [(3, 28, True), (28, 28, True), (28, 27, False)],
                         ids=["3to28", "28to28", "28to27"])
def test_k2_abpn_layer_shapes(cuda, ci, co, relu, rows, dtype):
    x, w, b = _k2_inputs(5, (rows, 640, ci), co, dtype)
    _k2_check(cuda, x, w, b, tile_cols=8, relu=relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape,co,tile", [
    ((60, 64, 28), 28, 8),
    ((60, 37, 28), 16, 8),
    ((15, 8, 3), 5, 4),
    ((8, 9, 1), 1, 2),
])
def test_k2_jax_test_shapes(cuda, shape, co, tile, relu, dtype):
    x, w, b = _k2_inputs(6, shape, co, dtype)
    _k2_check(cuda, x, w, b, tile_cols=tile, relu=relu)


def test_k2_does_not_depend_on_tile_cols(cuda):
    x, w, b = (t.to(cuda) for t in _k2_inputs(7, (37, 101, 28), 28, torch.float32))
    want = tk2.conv3x3_call(x, w, b, tile_cols=8)
    for tile in (1, 3, 64, 65):
        # the kernel picks its own output tile: tile_cols changes nothing
        assert torch.equal(tk2.conv3x3_call(x, w, b, tile_cols=tile), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,co", [
    ((5, 7, 28), 28),       # one tile: a map smaller than the grid
    ((720, 1280, 28), 28),  # 3,600 tiles: many tiles per persistent CTA
    ((37, 101, 28), 27),    # ragged R and W, Co = 27
    ((61, 45, 3), 27),      # Ci = 3 (taps folded into K), Co = 27, ragged
    ((19, 50, 5), 13),      # odd Ci with taps not folded (bf16: plain loads)
])
def test_k2_grid_and_ragged_maps(cuda, shape, co, dtype):
    x, w, b = _k2_inputs(9, shape, co, dtype)
    tiles, ctas = tk2.launch_grid(x.to(cuda))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ctas == min(tiles, sms * tk2.blocks_per_sm(cuda, dtype, shape[2]))
    _k2_check(cuda, x, w, b, tile_cols=8, relu=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,co", [
    ((360, 640, 28), 48),   # ABPN x4's last layer, one frame
    ((60, 640, 48), 48),    # two k-chunks, two n-groups (the second half full)
    ((37, 101, 128), 128),  # the widest: four k-chunks, four n-groups, ragged
    ((19, 50, 5), 40),      # odd Ci, Co past 32 (bf16: plain loads)
    ((21, 33, 40), 27),     # Ci past 32, Co within: one n-group
    ((9, 70, 3), 33),       # Ci <= 3 with Co past 32: the wide instance, taps folded into K
    ((44, 72, 3), 64),      # ABPN x3 at F = 64: the first layer (folded), ragged W
    ((30, 70, 3), 128),     # F = 128's first layer: split outputs, folded
    ((44, 100, 64), 64),    # F = 64's hidden layers: two k-chunks, all outputs a warpgroup
    ((44, 100, 64), 27),    # F = 64's last layer: N = 32
    ((26, 70, 96), 96),     # three k-chunks, split outputs, ragged R and W
    ((37, 101, 128), 27),   # F = 128's last layer: four k-chunks, N = 32
])
def test_k2_wide_layers(cuda, shape, co, dtype):
    """K2 past 32 channels: the wide instance (persistent CTAs, a tile's
    outputs in one CTA, Ci in k-chunks of 32, the taps folded into K at
    Ci <= 3) against the plain version."""
    x, w, b = _k2_inputs(11, shape, co, dtype)
    assert tk2.is_wide(shape[2], co)
    _k2_check(cuda, x, w, b, tile_cols=8, relu=co != 27)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_unaligned_input(cuda, dtype):
    # an input one element past an aligned address: the window copies fall
    # back to a narrower granule and the result does not change, on the
    # persistent instances and on the wide one
    for shape, co in (((24, 70, 28), 28), ((20, 70, 64), 64)):
        x, w, b = _k2_inputs(10, shape, co, dtype)
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        shifted = flat[1:].view(x.shape)
        shifted.copy_(x.to(cuda))
        want = tk2.conv3x3_call(x.to(cuda), w.to(cuda), b.to(cuda))
        assert torch.equal(tk2.conv3x3_call(shifted, w.to(cuda), b.to(cuda)), want)
        _k2_check(cuda, x, w, b, tile_cols=8, relu=True)


SM_SHARED_BYTES = 233472  # an H100 SM's shared memory, 1 KB of it reserved a CTA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("ci,co", [(3, 64), (3, 128), (28, 48), (64, 64), (64, 27), (96, 96),
                                   (128, 128), (128, 27)])
def test_k2_wide_occupancy(cuda, ci, co, dtype):
    """The built wide instance takes the shared memory ``wide_plan`` counts,
    and as many CTAs an SM as the design claims: one where its shared
    memory leaves room for one, at most what shared memory allows
    elsewhere."""
    occ = tk2.wide_occupancy(cuda, dtype, ci, co)
    plan = tk2.wide_plan(ci, co, dtype)
    assert occ["smem_bytes"] == plan["smem_bytes"]
    fit = SM_SHARED_BYTES // (plan["smem_bytes"] + 1024)
    assert 1 <= occ["blocks_per_sm"] <= fit
    if fit == 1:
        assert occ["blocks_per_sm"] == 1


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_k2_wide_stack_layer_by_layer(cuda, precision):
    """ABPN x3 at F = 64 (3 -> 64 x6 -> 27) layer by layer: 7 launches of
    K2's wide instance over a 44x72 frame, the HR frame held against the
    reference backend on the card (TF32 off)."""
    from repro_torch.models.abpn import ABPNConfig

    ch = ABPNConfig(feature_channels=64).channels
    rng = np.random.default_rng(64)
    layers = layers_from_numpy(
        [((rng.normal(size=(3, 3, ch[i], ch[i + 1])) * (2.0 / (9 * ch[i])) ** 0.5)
          .astype(np.float32), (rng.normal(size=(ch[i + 1],)) * 0.1).astype(np.float32),
          i < len(ch) - 2) for i in range(len(ch) - 1)], device=cuda)
    lr = torch.from_numpy(rng.uniform(size=(1, 44, 72, 3)).astype(np.float32)).to(cuda)
    plan = engine.make_plan(layers, (44, 72, 3), backend="reference", precision=precision,
                            scale=3)
    x = lr.to(engine.compute_dtype_for(precision))
    launches = tk2.conv3x3_call.launches
    f = x[0]
    for l in engine.prepare_layers(layers, precision):
        assert tk2.is_wide(l.ci, l.co)
        f = ops.conv3x3(f, l.w, l.b, relu=l.relu)
    hr = engine.sr_epilogue(plan, x, f[None], lr.dtype)
    torch.cuda.synchronize()
    assert tk2.conv3x3_call.launches == launches + 7
    want = engine.run(plan, layers, lr, device=cuda)
    assert tuple(hr.shape) == (1, 132, 216, 3)
    np.testing.assert_allclose(hr.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[x.dtype], rtol=0)


def test_k2_rejects_what_it_does_not_take(cuda):
    x, w, b = (t.to(cuda) for t in _k2_inputs(8, (8, 16, 4), 6, torch.float32))
    launches = tk2.conv3x3_call.launches
    with pytest.raises(ValueError, match="one device"):
        tk2.conv3x3_call(x, w.cpu(), b)
    with pytest.raises(ValueError, match="limit of 128"):
        wide = torch.zeros((3, 3, 4, 129), device=cuda)
        tk2.conv3x3_call(x, wide, torch.zeros(129, device=cuda))
    with pytest.raises(ValueError, match="tile_cols"):
        tk2.conv3x3_call(x, w, b, tile_cols=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk2.conv3x3_call(x.half(), w.half(), b.half())
    assert tk2.conv3x3_call.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k2_holds_the_jax_dtype_tolerance(cuda, dtype):
    """Twin of the JAX package's ``test_conv3x3_dtypes``: Ci = Co = 8, zero
    bias, ReLU, held to its stricter ``atol = rtol = 1e-5`` in fp32 (2e-2 in
    bf16) against the plain version."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(20, 24, 8)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, 8, 8)) * 0.2).astype(np.float32)).to(dtype)
    b = torch.zeros((8,), dtype=dtype)
    want = tk2.conv3x3_plain(x, w, b)
    got = tk2.conv3x3_call(x.to(cuda), w.to(cuda), b.to(cuda))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# The temporal delta path on the card: partial-band K1 dispatches
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo"])
def test_delta_session_on_the_card_is_bit_exact(cuda, policy):
    """Frames served through DeltaSession (dirty bands through K1 as
    partial-band dispatches, clean bands spliced on the card) equal a full
    re-upscale of each frame bit for bit."""
    from repro_torch.engine.temporal import DeltaSession

    layers = init_abpn(torch.Generator().manual_seed(0))
    session = engine.SRSession(layers, backend="kernel", band_rows=20,
                               vertical_policy=policy, device=cuda)
    rng = np.random.default_rng(5)
    f0 = rng.uniform(size=(120, 64, 3)).astype(np.float32)
    f2 = f0.copy()
    f2[45:47] += 0.25  # band 2
    clip = [f0, f0.copy(), f2, rng.uniform(size=(120, 64, 3)).astype(np.float32)]
    before = ttf.tilted_fusion_call.launches
    with DeltaSession(session) as ds:
        for frame in clip:
            out = ds.serve(frame)
            assert out.device.type == "cuda"
            assert torch.equal(out, session.upscale(frame))
    assert ttf.tilted_fusion_call.launches > before
    t = session.temporal_stats()
    assert t["bands_skipped"] == 6 + (6 - (1 if policy != "halo" else 3))
    assert t["cover_violations"] == 0 and t["cache"]["pinned"] == 0


# ----------------------------------------------------------------------
# Schedule autotuning and static analysis on the card
# ----------------------------------------------------------------------
def test_strict_kernel_session_serves_on_the_card(cuda):
    layers = init_abpn(torch.Generator().manual_seed(0))
    frames = np.random.default_rng(6).uniform(size=(2, 120, 64, 3)).astype(np.float32)
    strict = engine.SRSession(layers, backend="kernel", strict=True, autotune="off",
                              device=cuda)
    plain = engine.SRSession(layers, backend="kernel", autotune="off", device=cuda)
    assert strict.plan_for((120, 64, 3)).verify() == []
    assert torch.equal(strict.upscale(frames), plain.upscale(frames))


@pytest.mark.parametrize("precision,policy", [
    ("fp32", "zero"), ("bf16", "zero"), ("int8", "zero"), ("fp32", "halo"), ("bf16", "halo"),
])
def test_audit_session_clean_on_kernel_sessions(cuda, precision, policy):
    """The program audit on the card: one call of a warmed kernel session
    copies nothing to the host, waits for nothing, builds nothing, and
    launches K1's instance of the plan's precision.  Under halo this needs
    the valid-row bounds made on the card (``core.fusion.halo_slabs``)."""
    from repro_torch.analysis import program_audit
    from repro_torch.engine import executor

    layers = init_abpn(torch.Generator().manual_seed(0))
    session = engine.SRSession(layers, backend="kernel", precision=precision,
                               vertical_policy=policy, autotune="off", device=cuda)
    session.upscale(np.zeros((120, 64, 3), np.float32))
    assert program_audit.audit_session(session) == []
    entry = session._cache.entries()[0]
    arts = executor.executor_artifacts(entry.plan, session._stacks[entry.stack_key].stack,
                                       entry.bucket, torch.float32)
    k1 = [k for k in arts["kernels"]["kernels"] if "tilted_fusion_kernel" in k]
    assert len(k1) == 1 and ("bfloat16" in k1[0]) == (precision == "bf16")
    assert arts["kernels"]["syncs"] == [] and arts["builds"] == []


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_server_launch_does_not_wait_for_the_card(cuda, policy):
    """A dispatch's launch holds the server lock, so uploading a request's
    host frames there must not synchronize the stream (each dispatch would
    wait for the one before it, and ``pipeline_depth`` would buy nothing):
    one frame filling its bucket, three frames coalesced into one padded
    dispatch, and under ``halo`` a band request (the delta path's slabs and
    valid-row bounds)."""
    from repro_torch.analysis import program_audit
    from repro_torch.engine.temporal.band_diff import band_slabs

    layers = init_abpn(torch.Generator().manual_seed(0))
    session = engine.SRSession(layers, backend="kernel", vertical_policy=policy,
                               autotune="off", device=cuda)
    server = engine.SRServer({"m": session})
    frame = np.random.default_rng(8).uniform(size=(120, 64, 3)).astype(np.float32)
    assert program_audit.audit_server(server, lambda: server.submit(frame)) == []
    three = [frame + i for i in range(3)]
    assert program_audit.audit_server(
        server, lambda: [server.submit(f) for f in three][-1]) == []
    if policy == "halo":
        plan = session.plan_for(frame.shape)
        slabs = band_slabs(frame, plan.band_rows, plan.num_layers, [0, 1], policy)
        assert program_audit.audit_server(
            server, lambda: server.submit_bands(slabs, (0, 1), plan=plan)) == []


def test_tuned_halo_output_equals_the_default_on_the_card(cuda, tmp_path):
    from repro_torch.engine import autotune

    layers = init_abpn(torch.Generator().manual_seed(0), device=cuda)
    peaks = autotune.RooflinePeaks.detect(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert peaks.cache_bytes == props.L2_cache_size
    assert peaks.flops_per_s > 1e12 and peaks.hbm_bytes_per_s > 1e11
    plan = engine.SRPlan.from_request((120, 64, 3), num_layers=7, vertical_policy="halo",
                                      backend="kernel")
    db = autotune.TuningDB(str(tmp_path / "db.json"))
    entry = autotune.tune(layers, plan, 4, db=db, depths=(1, 2), chunks=2, reps=1)
    assert entry.measured_ms <= entry.default_ms
    assert entry.device_name == torch.cuda.get_device_name(cuda)
    frames = np.random.default_rng(7).uniform(size=(4, 120, 64, 3)).astype(np.float32)
    default = engine.SRSession(layers, backend="kernel", vertical_policy="halo",
                               autotune="off", device=cuda).upscale(frames)
    tuned = engine.SRSession(layers, backend="kernel", vertical_policy="halo",
                             autotune="cached", tuning_db=db.path, device=cuda)
    assert torch.equal(tuned.upscale(frames), default)
    assert tuned.tuning_stats()["hits"] == 1
    for band in sorted({c.band_rows for c in entry.candidates}):
        p = dataclasses.replace(plan, band_rows=band)
        out = engine.SRSession.from_plan(p, layers, autotune="off").upscale(frames)
        assert torch.equal(out, default), band


def _card_mesh(cuda, replicas, shards):
    from repro_torch.launch.mesh import make_sr_mesh

    return make_sr_mesh(replicas, shards, devices=[cuda] * (replicas * shards))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_executor_bit_exact_on_the_card(cuda, precision, policy, shards):
    """The band-sharded executor on ``[cuda:0] * S`` (one stream per shard)
    equals the single-device kernel executor bit for bit, and launches K1
    once per shard."""
    from repro_torch.engine.sharding import MeshSpec, ShardedPlan, build_sharded_executor
    from repro_torch.launch.mesh import band_submesh

    layers = init_abpn(torch.Generator().manual_seed(0), device=cuda)
    plan = engine.SRPlan(height=120, width=64, num_layers=7, band_rows=15,
                         vertical_policy=policy, backend="kernel", precision=precision)
    stack = engine.prepare_stack(plan, layers)
    frames = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(4, 120, 64, 3)).astype(np.float32)).to(cuda)
    want = engine.build_stack_executor(plan, stack)(frames)
    fn = build_sharded_executor(ShardedPlan(plan=plan, spec=MeshSpec(1, shards)), stack,
                                band_submesh(_card_mesh(cuda, 1, shards), 0))
    before = ttf.tilted_fusion_call.launches
    got = fn(frames)
    assert ttf.tilted_fusion_call.launches - before == shards
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_mesh_server_on_the_card_equals_an_unsharded_one(cuda, policy):
    layers = init_abpn(torch.Generator().manual_seed(0))
    flat = engine.SRServer({"m": engine.SRSession(
        layers, backend="kernel", vertical_policy=policy, autotune="off", device=cuda)})
    mesh = engine.SRServer({"m": engine.SRSession(
        layers, backend="kernel", vertical_policy=policy, autotune="off",
        mesh=_card_mesh(cuda, 2, 2))})
    rng = np.random.default_rng(9)
    for _ in range(4):
        frames = rng.uniform(size=(2, 120, 64, 3)).astype(np.float32)
        assert torch.equal(mesh.submit(frames).result(), flat.submit(frames).result())
    stats = mesh.session().sharding_stats()
    assert stats["mesh"] == "2x2" and [r["dispatches"] for r in stats["replicas"]] == [2, 2]


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_audit_server_clean_on_a_mesh_session(cuda, policy):
    """A mesh session's launch forks and joins its shard streams without a
    host wait: no synchronize, no pageable upload, no stream made there."""
    from repro_torch.analysis import program_audit

    layers = init_abpn(torch.Generator().manual_seed(0))
    session = engine.SRSession(layers, backend="kernel", vertical_policy=policy,
                               autotune="off", mesh=_card_mesh(cuda, 2, 2))
    server = engine.SRServer({"m": session})
    frame = np.random.default_rng(8).uniform(size=(120, 64, 3)).astype(np.float32)
    assert program_audit.audit_server(server, lambda: server.submit(frame)) == []


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices: a mesh across cards")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("precision,policy", [("fp32", "zero"), ("fp32", "halo"),
                                              ("bf16", "halo")])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_executor_bit_exact_across_cards(cuda, precision, policy, shards):
    """Shards on different GPUs (the default mesh: the first S cards): the
    row blocks, the halo margins and the HR blocks cross between cards
    with device-to-device copies, and the output still equals the
    single-device executor's bit for bit."""
    from repro_torch.engine.sharding import MeshSpec, ShardedPlan, build_sharded_executor
    from repro_torch.launch.mesh import band_submesh, make_sr_mesh

    _cards(shards)
    layers = init_abpn(torch.Generator().manual_seed(0), device=cuda)
    plan = engine.SRPlan(height=120, width=64, num_layers=7, band_rows=15,
                         vertical_policy=policy, backend="kernel", precision=precision)
    stack = engine.prepare_stack(plan, layers)
    frames = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(4, 120, 64, 3)).astype(np.float32)).to(cuda)
    want = engine.build_stack_executor(plan, stack)(frames)
    mesh = band_submesh(make_sr_mesh(1, shards), 0)
    assert len(mesh.distinct_devices()) == shards
    got = build_sharded_executor(ShardedPlan(plan=plan, spec=MeshSpec(1, shards)), stack,
                                 mesh)(frames)
    torch.cuda.synchronize()
    assert got.device == frames.device and torch.equal(got, want)


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_mesh_server_across_cards_equals_an_unsharded_one(cuda, policy):
    """A (2, 2) mesh over four cards: replica 1 runs from cuda:2 on the
    server's home stream there, and its results come back on the session's
    device (cuda:0)."""
    from repro_torch.analysis import program_audit

    _cards(4)
    layers = init_abpn(torch.Generator().manual_seed(0))
    flat = engine.SRServer({"m": engine.SRSession(
        layers, backend="kernel", vertical_policy=policy, autotune="off", device=cuda)})
    session = engine.SRSession(layers, backend="kernel", vertical_policy=policy,
                               autotune="off", mesh=(2, 2))
    mesh = engine.SRServer({"m": session})
    assert session.device == torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    for _ in range(4):
        frames = rng.uniform(size=(2, 120, 64, 3)).astype(np.float32)
        got = mesh.submit(frames).result()
        assert got.device == session.device
        assert torch.equal(got, flat.submit(frames).result())
    stats = session.sharding_stats()
    assert [r["dispatches"] for r in stats["replicas"]] == [2, 2]
    frame = rng.uniform(size=(120, 64, 3)).astype(np.float32)
    assert program_audit.audit_server(mesh, lambda: mesh.submit(frame)) == []


def _lm_cut(device):
    """qwen2-0.5b at its full widths, cut to 2 layers, fp32, seeded
    weights (QKV biases non-zero) on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.layers.params import init_params
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(lm.schema(cfg), gen, cfg.weight_dtype, device)
    for key in ("bq", "bk", "bv"):
        params["blocks"]["attn"][key].normal_(0.0, 0.1, generator=gen)
    return cfg, params


def test_lm_decode_after_prefill_matches_forward_on_the_card(cuda):
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step
    from repro_torch.models import lm

    cfg, params = _lm_cut(cuda)
    B, S = 2, 40
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        full, _, _ = lm.forward(params, cfg, tokens, mode="train")
    cache = init_cache(cfg, B, S + 3, cuda)
    _, cache = make_prefill_step(cfg)(params, {"tokens": tokens[:, :S]}, cache)
    logits, _ = make_decode_step(cfg)(params, tokens[:, S:S + 1], cache, S)
    torch.testing.assert_close(logits, full[:, S], atol=2e-4, rtol=1e-3)


def test_lm_prefill_on_the_card_matches_the_cpu(cuda):
    from repro_torch.distributed.steps import init_cache, make_prefill_step
    from repro_torch.layers.params import tree_map

    cfg, params = _lm_cut(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    step = make_prefill_step(cfg)
    on_card, _ = step(params, {"tokens": tokens.to(cuda)}, init_cache(cfg, 1, 16, cuda))
    params_cpu = tree_map(lambda t: t.cpu(), params, is_leaf=lambda t: not isinstance(t, dict))
    on_cpu, _ = step(params_cpu, {"tokens": tokens}, init_cache(cfg, 1, 16, "cpu"))
    torch.testing.assert_close(on_card.cpu(), on_cpu, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("S", [128, 512])
def test_flash_vjp_on_the_card_matches_the_cpu(cuda, S):
    """The flash backward (the reference's ``_flash_bwd``) in fp32 with
    qwen2-0.5b's head layout (Kh 2, G 7, D 64), batch 2, causal, KV chunks
    of 128 (one chunk at S = 128, four at S = 512): ``dq``, ``dk``, ``dv`` on
    the card vs the CPU at the reference's VJP tolerance."""
    from repro_torch.layers.attention import flash_attention

    gen = torch.Generator().manual_seed(S)
    q = torch.randn((2, S, 2, 7, 64), generator=gen)
    k = torch.randn((2, S, 2, 64), generator=gen)
    v = torch.randn((2, S, 2, 64), generator=gen)
    g = torch.randn((2, S, 2, 7, 64), generator=gen)

    def grads(device):
        args = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*args, causal=True, chunk=128)
        return torch.autograd.grad(out, args, g.to(device))

    for on_card, on_cpu in zip(grads(cuda), grads("cpu")):
        torch.testing.assert_close(on_card.cpu(), on_cpu, atol=5e-5, rtol=1e-3)


def test_lm_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_train_step`` step of qwen2-0.5b's widths cut to 2 layers,
    fp32, batch 1 x 32 tokens, from the same state on the card and on the
    CPU: every gradient leaf within a relative L2 error of 1e-4 (the
    embedding's gradient is summed by atomics on the card, in another order
    than on the CPU), the loss and grad norm at ``rtol 1e-4``, and every
    parameter after the step within 2 lr of the CPU's (the first AdamW step
    moves an element by about lr times the sign of its gradient, and a
    gradient near zero may have either sign on the two devices)."""
    from repro_torch.config import TrainConfig
    from repro_torch.distributed.steps import compute_grads, make_train_step
    from repro_torch.layers.params import tree_leaves_with_path, tree_map
    from repro_torch.optim.adamw import init_opt_state

    cfg, params = _lm_cut(cuda)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 33), dtype=torch.int32, generator=gen)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": torch.ones((1, 32),
                                                                                dtype=torch.int32)}
    to_cpu = functools.partial(tree_map, lambda t: t.to("cpu", copy=True),
                               is_leaf=lambda t: not isinstance(t, dict))
    on = {"card": (params, {k: v.to(cuda) for k, v in batch.items()}),
          "cpu": (to_cpu(params), batch)}
    grads = {dev: dict(tree_leaves_with_path(compute_grads(cfg, p, b)[1]))
             for dev, (p, b) in on.items()}
    for path, want in grads["cpu"].items():
        err = float((grads["card"][path].cpu() - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= 1e-4, ("/".join(path), err)

    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, tcfg)
    after = {}
    for dev, (p, b) in on.items():
        state, m = step({"params": p, "opt": init_opt_state(p)}, b)
        after[dev] = (to_cpu(state["params"]), float(m["total_loss"]), float(m["grad_norm"]))
    assert after["card"][1] == pytest.approx(after["cpu"][1], rel=1e-4)
    assert after["card"][2] == pytest.approx(after["cpu"][2], rel=1e-4)
    for (path, a), (_, b) in zip(tree_leaves_with_path(after["card"][0]),
                                 tree_leaves_with_path(after["cpu"][0])):
        torch.testing.assert_close(a, b, atol=2 * tcfg.learning_rate, rtol=0,
                                   msg=lambda m: f"{'/'.join(path)}: {m}")


def test_encdec_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    """seamless-m4t-large-v2 reduced (2 + 2 layers), fp32: prefill over a
    20-frame src and a 24-token prompt, then two decode steps, on the card
    and on the CPU from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import init_cache, make_decode_step, make_prefill_step
    from repro_torch.layers.params import init_params, tree_map
    from repro_torch.models import encdec

    cfg = get_config("seamless-m4t-large-v2").reduced()
    params = init_params(encdec.schema(cfg), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    src = torch.randn((2, 20, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 26), dtype=torch.int32, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params, is_leaf=lambda t: not isinstance(t, dict))
        cache = init_cache(cfg, 2, 28, dev, enc_len=20)
        logits, cache = make_prefill_step(cfg)(p, {"src": src.to(dev),
                                                   "tokens": tokens[:, :24].to(dev)}, cache)
        steps = [logits]
        for i in range(2):
            logits, cache = make_decode_step(cfg)(p, tokens[:, 24 + i:25 + i].to(dev), cache,
                                                  24 + i)
            steps.append(logits)
        out[str(dev)] = [t.cpu() for t in steps]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


def test_int8_ef_allreduce_on_card_streams_matches_the_cpu(cuda):
    """The all-reduce over a ``(data=4,)`` mesh of one card's streams and
    over 4 ``cpu`` positions, from the same per-position gradients and
    residuals: every element of the mean within one quantum (``scale / n``)
    of the CPU's and at most 1 % of them off by one; the residuals within
    one quantum."""
    from repro_torch.distributed.grad_sync import int8_ef_allreduce
    from repro_torch.launch.mesh import make_mesh

    gen = torch.Generator().manual_seed(4)
    grads = [{"a": torch.randn((64, 33), generator=gen),
              "b": {"c": torch.randn((257,), generator=gen) ** 3}} for _ in range(4)]
    ef = [{"a": 0.01 * torch.randn((64, 33), generator=gen),
           "b": {"c": 0.01 * torch.randn((257,), generator=gen)}} for _ in range(4)]
    mesh = make_mesh((4,), ("data",), devices=[cuda] * 4)
    move = lambda trees: [{"a": t["a"].to(cuda), "b": {"c": t["b"]["c"].to(cuda)}}  # noqa: E731
                          for t in trees]
    got, got_e = int8_ef_allreduce(move(grads), move(ef), mesh.streams)
    torch.cuda.synchronize()
    want, want_e = int8_ef_allreduce(grads, ef)
    for key in ("a", "c"):
        pick = (lambda t: t["a"]) if key == "a" else (lambda t: t["b"]["c"])
        gf = torch.stack([pick(g) + pick(e) for g, e in zip(grads, ef)])
        quantum = float(gf.abs().max()) / 127 / 4
        diff = (pick(got).cpu() - pick(want)).abs()
        assert float(diff.max()) <= quantum * 1.001, key
        assert float((diff > 0).float().mean()) <= 0.01, key
        for a, b in zip(got_e, want_e):
            assert float((pick(a).cpu() - pick(b)).abs().max()) <= 4 * quantum * 1.001, key


# ----------------------------------------------------------------------
# ABPN's epilogue (kernels.epilogue): the kernel against the plain chain
# ----------------------------------------------------------------------
def _k1_features(cuda, scale, precision, frames, shape=(360, 640), policy="zero", seed=21):
    """K1's output on the card as the serving path hands it to the
    epilogue (the strided view of Chp channels a pixel), with the LR input
    in the compute dtype; He weights, so a good share of HR values clip."""
    layers = [l.to(device=cuda)
              for l in _stack(seed + scale, ABPNConfig(scale=scale).channels, None)]
    plan = engine.make_plan(layers, (*shape, 3), backend="kernel", band_rows=60,
                            precision=precision, scale=scale, vertical_policy=policy)
    stack = engine.prepare_stack(plan, layers)
    rng = np.random.default_rng(seed)
    lr = torch.from_numpy(rng.uniform(size=(frames, *shape, 3)).astype(np.float32)).to(cuda)
    x = lr.to(engine.compute_dtype_for(precision))
    feats = engine.sr_features(plan, stack.layers, x, packed=stack.packed)
    return plan, stack, x, feats


def _assert_epilogue_equal(feats, x, scale):
    from repro_torch.kernels import epilogue

    for clip in (True, False):
        for out in (torch.float32, torch.bfloat16):
            got = epilogue.sr_epilogue_call(feats, x, scale=scale, clip=clip, out_dtype=out)
            want = epilogue.sr_epilogue_plain(feats, x, scale=scale, clip=clip, out_dtype=out)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.is_contiguous()
            assert torch.equal(got, want), (clip, out)


@pytest.mark.parametrize("scale,precision,frames,chp", [
    (3, "fp32", 1, 32), (3, "fp32", 128, 32), (3, "bf16", 1, 32), (3, "int8", 1, 32),
    (4, "bf16", 1, 48), (4, "bf16", 128, 48), (4, "fp32", 1, 48), (2, "fp32", 1, 32),
    (2, "bf16", 1, 32),
], ids=["x3-fp32-1", "x3-fp32-128", "x3-bf16-1", "x3-int8-1", "x4-bf16-1", "x4-bf16-128",
        "x4-fp32-1", "x2-fp32-1", "x2-bf16-1"])
def test_epilogue_kernel_equals_plain_on_k1_features(cuda, scale, precision, frames, chp):
    """The kernel's HR frame is ``torch.equal`` to the plain chain's on K1's
    own output view (ABPN x3 at Chp 32, x4's mixed launch at 48), clip on
    and off, fp32 and bf16 out, at one frame and a full 128-frame dispatch.
    ABPN x2 reads 12 of its view's 32 channels a pixel, element by element
    (a span of whole records would read 2.7x the bytes)."""
    _, _, x, feats = _k1_features(cuda, scale, precision, frames)
    assert feats.stride(2) == chp and not feats.is_contiguous()
    _assert_epilogue_equal(feats, x, scale)


@pytest.mark.parametrize("width", [37, 61])
def test_epilogue_kernel_at_a_width_off_the_vector(cuda, width):
    """HR rows of ``width * 9`` elements, no multiple of a 16-byte vector:
    every row starts at another offset from 16 bytes, and the feature
    spans of K1's view as well."""
    _, _, x, feats = _k1_features(cuda, 3, "fp32", 2, shape=(60, width))
    _assert_epilogue_equal(feats, x, 3)
    _, _, x, feats = _k1_features(cuda, 3, "bf16", 2, shape=(60, width))
    _assert_epilogue_equal(feats, x, 3)


def test_epilogue_kernel_reads_any_layout(cuda):
    """A features tensor with channels not contiguous (channels-first,
    permuted) takes the element-by-element reads, and an fp16 frame the
    third output dtype."""
    from repro_torch.kernels import epilogue

    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(0.5, 0.6, (2, 27, 12, 20)).astype(np.float32)).to(cuda)
    feats = feats.permute(0, 2, 3, 1)  # (2, 12, 20, 27), channel stride 240
    x = torch.from_numpy(rng.uniform(size=(2, 12, 20, 3)).astype(np.float32)).to(cuda)
    _assert_epilogue_equal(feats, x, 3)
    got = epilogue.sr_epilogue_call(feats, x, scale=3, clip=True, out_dtype=torch.float16)
    want = epilogue.sr_epilogue_plain(feats, x, scale=3, clip=True, out_dtype=torch.float16)
    assert got.dtype == torch.float16 and torch.equal(got, want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_epilogue_kernel_on_halo_band_slabs(cuda, precision):
    """The delta path's band executor under ``halo``: its LR rows are a
    slice of each slab, and its HR bands equal the plain chain on the same
    features."""
    from repro_torch.core.fusion import halo_slabs
    from repro_torch.engine import executor
    from repro_torch.kernels import epilogue

    plan, stack, x, _ = _k1_features(cuda, 3, precision, 2, shape=(120, 64), policy="halo")
    slabs, bounds = halo_slabs(x, plan.band_rows, plan.num_layers)
    launches = epilogue.sr_epilogue_call.launches
    got = executor.build_band_executor(plan, stack)(slabs, bounds)
    assert epilogue.sr_epilogue_call.launches == launches + 1
    feats = executor._band_features(plan, stack, slabs, bounds)
    L = plan.num_layers
    lr = slabs[:, L:L + plan.band_rows]
    assert not lr.is_contiguous()
    want = epilogue.sr_epilogue_plain(feats, lr, scale=3, clip=plan.clip, out_dtype=x.dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_epilogue_kernel_passes_nan_through(cuda, precision):
    """A NaN in the features or the LR input comes out as NaN under the
    clip, as ``torch.clamp`` passes it, and every other value is equal."""
    from repro_torch.kernels import epilogue

    _, _, x, feats = _k1_features(cuda, 3, precision, 1, shape=(60, 64))
    feats[0, 5, 7, 4] = float("nan")  # the view writes K1's output buffer
    x = x.clone()
    x[0, 9, 3, 1] = float("nan")
    got = epilogue.sr_epilogue_call(feats, x, scale=3, clip=True, out_dtype=torch.float32)
    want = epilogue.sr_epilogue_plain(feats, x, scale=3, clip=True, out_dtype=torch.float32)
    nan = torch.isnan(want)
    assert int(nan.sum()) == 10  # one feature channel, and a pixel's 9 anchored outputs
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


def test_epilogue_kernel_counts_launches_and_refuses_what_it_does_not_take(cuda):
    from repro_torch.engine import executor
    from repro_torch.kernels import epilogue

    plan, _, x, feats = _k1_features(cuda, 3, "fp32", 1, shape=(60, 64))
    launches = epilogue.sr_epilogue_call.launches
    for k in range(3):
        executor.sr_epilogue(plan, x, feats, torch.float32)
        assert epilogue.sr_epilogue_call.launches == launches + k + 1
    refused = [
        (feats.double(), x.double(), torch.float32),  # compute dtype
        (feats.half(), x.half(), torch.float32),
        (feats, x.bfloat16(), torch.float32),  # one dtype for both
        (feats, x.cpu(), torch.float32),  # devices
        (feats[..., :26], x, torch.float32),  # channels
        (feats, x[..., :2], torch.float32),
    ]
    launches = epilogue.sr_epilogue_call.launches
    for f, lr, out in refused:
        with pytest.raises(ValueError):
            epilogue.sr_epilogue_call(f, lr, scale=3, clip=True, out_dtype=out)
    assert epilogue.sr_epilogue_call.launches == launches


def _plain_epilogue(monkeypatch):
    """Make the executor's epilogue the plain chain (the tests' own
    reference runs), so a comparison with served frames checks the
    kernel."""
    from repro_torch.engine import executor
    from repro_torch.kernels import epilogue

    monkeypatch.setattr(executor, "sr_epilogue", lambda plan, x, feats, in_dtype:
                        epilogue.sr_epilogue_plain(feats, x, scale=plan.scale, clip=plan.clip,
                                                   out_dtype=in_dtype))


def test_served_frames_take_the_epilogue_kernel(cuda, monkeypatch):
    """Every frame the server dispatches on the card has its epilogue run
    by the kernel: ``epilogue_kernel_frames`` equals ``epilogue_frames``,
    and the frames equal the executor's with the plain chain."""
    from repro_torch.kernels import epilogue

    session = engine.SRSession(init_abpn(torch.Generator().manual_seed(0)), backend="kernel",
                               autotune="off", device=cuda, max_bucket=4)
    server = engine.SRServer({"m": session})
    clip = np.random.default_rng(8).uniform(size=(6, 120, 64, 3)).astype(np.float32)
    server.submit(clip[:1]).result()  # warm
    session.reset_stats()
    launches = epilogue.sr_epilogue_call.launches
    hr = server.submit(clip).result()
    st = session.stats()
    assert st["epilogue_frames"] == 6 and st["epilogue_kernel_frames"] == 6
    assert epilogue.sr_epilogue_call.launches > launches
    _plain_epilogue(monkeypatch)
    launches = epilogue.sr_epilogue_call.launches
    want = engine.run(session.plan_for(clip.shape[1:]), session.layers, clip, device=cuda)
    assert epilogue.sr_epilogue_call.launches == launches
    assert torch.equal(hr, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int32])
def test_integer_frames_are_served_through_the_epilogue_kernel(cuda, monkeypatch, dtype):
    """An integer request keeps its dtype: the kernel writes the HR frame
    in the compute dtype and the wrapper casts it, as the chain clamps and
    then casts, so the served frames equal the plain chain's bit for bit."""
    from repro_torch.kernels import epilogue

    session = engine.SRSession(init_abpn(torch.Generator().manual_seed(0)), backend="kernel",
                               autotune="off", device=cuda, max_bucket=4)
    server = engine.SRServer({"m": session})
    rng = np.random.default_rng(11)
    clip = rng.integers(0, 2, size=(3, 120, 64, 3)).astype(dtype)  # values the clip keeps whole
    launches = epilogue.sr_epilogue_call.launches
    hr = server.submit(clip).result()
    assert epilogue.sr_epilogue_call.launches > launches
    st = session.stats()
    assert st["epilogue_kernel_frames"] == st["epilogue_frames"] == 3
    assert hr.dtype == torch.from_numpy(clip).dtype and tuple(hr.shape) == (3, 360, 192, 3)
    _plain_epilogue(monkeypatch)
    want = engine.run(session.plan_for(clip.shape[1:]), session.layers, clip, device=cuda)
    assert want.dtype == hr.dtype and torch.equal(hr, want)
    server.close()


@pytest.mark.parametrize("out", [torch.uint8, torch.int8, torch.int32, torch.float64, torch.bool])
def test_epilogue_kernel_casts_to_a_dtype_it_does_not_write(cuda, out):
    """An HR dtype the kernel does not write is its compute-dtype output,
    cast: ``torch.equal`` to the plain chain, one launch a call."""
    from repro_torch.kernels import epilogue

    for precision in ("fp32", "bf16"):
        _, _, x, feats = _k1_features(cuda, 3, precision, 1, shape=(60, 64))
        for clip in (True, False):
            launches = epilogue.sr_epilogue_call.launches
            got = epilogue.sr_epilogue_call(feats, x, scale=3, clip=clip, out_dtype=out)
            want = epilogue.sr_epilogue_plain(feats, x, scale=3, clip=clip, out_dtype=out)
            assert epilogue.sr_epilogue_call.launches == launches + 1
            assert got.dtype == out and torch.equal(got, want), (precision, clip)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_epilogue_kernel_under_autograd_gives_the_plain_chains_gradients(cuda, precision):
    """Autograd records the kernel (training through ``engine.run``): the
    forward launches it, with the plain chain's bits, and the gradients
    are the plain chain's (the features' bit for bit)."""
    from repro_torch.kernels import epilogue
    from repro_torch.models.abpn import apply_abpn

    _, _, x, feats = _k1_features(cuda, 3, precision, 1, shape=(60, 64))
    f, lr = feats.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
    pf, plr = feats.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
    launches = epilogue.sr_epilogue_call.launches
    got = epilogue.sr_epilogue_call(f, lr, scale=3, clip=True, out_dtype=torch.float32)
    assert got.grad_fn is not None and epilogue.sr_epilogue_call.launches == launches + 1
    want = epilogue.sr_epilogue_plain(pf, plr, scale=3, clip=True, out_dtype=torch.float32)
    assert torch.equal(got.detach(), want.detach())
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    got_f, got_x = torch.autograd.grad(got, (f, lr), grad)
    want_f, want_x = torch.autograd.grad(want, (pf, plr), grad)
    assert torch.equal(got_f, want_f)
    torch.testing.assert_close(got_x, want_x)
    # a training step's gradient through the whole executor on the card
    from repro_torch.core.fusion import ConvLayer

    layers = [ConvLayer(l.w.detach().clone().requires_grad_(),
                        l.b.detach().clone().requires_grad_(), l.relu)
              for l in init_abpn(torch.Generator().manual_seed(0), device=cuda)]
    hr_lr = torch.rand((12, 16, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    launches = epilogue.sr_epilogue_call.launches
    hr = apply_abpn(layers, hr_lr, method="reference", device=cuda)
    assert epilogue.sr_epilogue_call.launches == launches + 1
    grads = torch.autograd.grad(hr.mean(), [l.w for l in layers])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ----------------------------------------------------------------------
# RLFN on the card: K1's Chp 64 instance with a leaky slope and a residual,
# the epilogue without an anchor, rlfn_x4 served
# ----------------------------------------------------------------------
def _rlfb_convs(seed):
    """An RLFB's three 3x3 convs, 52 -> 52, LeakyReLU(0.05), He weights."""
    return [dataclasses.replace(l, relu=True, slope=0.05)
            for l in _stack(seed, [52, 52, 52, 52], None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "halo_bounds"])
def test_rlfb_segment_on_the_chp64_instance_matches_plain(cuda, policy, dtype):
    """An RLFB segment (3 layers 52 -> 52, slope 0.05, the block's input
    added after the last activation) on the Chp 64 instance over two
    61-row bands (three row blocks a step) of 40 columns: within the
    tolerance of the plain version, and bit-identical across segments.
    Under ``halo_bounds`` the residual covers the band's own rows (3..57)."""
    layers = [l.to(dtype=dtype) for l in _rlfb_convs(11)]
    packed = ops.pack_stack(layers, chp=64, dtype=dtype)
    gen = torch.Generator().manual_seed(12)
    xb = torch.rand((2, 61, 40, 52), generator=gen).to(dtype)
    xs, first = ops.band_streams(xb, 8, 3)
    bounds, off, rows = None, 0, 61
    if policy == "halo_bounds":
        bounds, off, rows = torch.tensor([[3, 61], [0, 58]], dtype=torch.int32), 3, 55
    res = torch.rand((2, rows, 40, 52), generator=gen).to(dtype)
    kw = dict(width=40, tile_cols=8, relu_flags=list(packed.relu), add_anchor=False,
              in_channels=52, hidden_channels=packed.hidden_channels, slopes=packed.slopes,
              residual_offset=off)
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=bounds,
                                   residual=res, **kw)
    args = (xs.to(cuda), first.to(cuda), packed.w.to(cuda), packed.b.to(cuda))
    kw.update(row_bounds=None if bounds is None else bounds.to(cuda), residual=res.to(cuda))
    got = ttf.tilted_fusion_call(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    for segments in (1, 3):
        assert torch.equal(ttf.tilted_fusion_call(*args, segments=segments, **kw), got)
    # a slope or a residual on another instance is refused, not run
    narrow = ops.pack_stack([l.to(dtype=dtype) for l in _rlfb_convs(11)], dtype=dtype)
    with pytest.raises(ValueError, match="Chp 64 instance alone"):
        ttf.tilted_fusion_call(xs[..., :8].to(cuda), first[..., :8].to(cuda),
                               narrow.w[:, :, :, :16, :16].contiguous().to(cuda),
                               narrow.b[:, :16].contiguous().to(cuda), width=40, tile_cols=8,
                               relu_flags=[True] * 3, add_anchor=False, in_channels=8,
                               slopes=[0.05] * 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_epilogue_without_anchor_equals_the_chain(cuda, dtype):
    """``anchor=False`` on K1's output view (64 channels a pixel, 48 read)
    at x4: the kernel's HR frames are the plain chain's (shuffle, clip,
    cast) bit for bit, for every output dtype and with and without clip."""
    from repro_torch.kernels import epilogue

    gen = torch.Generator().manual_seed(13)
    base = (torch.rand((2, 12, 37, 64), generator=gen) * 1.4 - 0.2).to(dtype).to(cuda)
    feats = base[..., :48]
    for clip in (True, False):
        for out in epilogue.OUT_DTYPES:
            launches = epilogue.sr_epilogue_call.launches
            got = epilogue.sr_epilogue_call(feats, None, scale=4, clip=clip, out_dtype=out,
                                            anchor=False)
            want = epilogue.sr_epilogue_plain(feats, None, scale=4, clip=clip, out_dtype=out,
                                              anchor=False)
            assert epilogue.sr_epilogue_call.launches == launches + 1
            assert got.shape == (2, 48, 148, 3) and torch.equal(got, want), (clip, out)


def _bench_rlfn_reference():
    """``bench/reference/rlfn.py``, loaded by path (it imports no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "bench" / "reference" / "rlfn.py"
    spec = importlib.util.spec_from_file_location("bench_reference_rlfn", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("precision,tol", [("fp32", 5e-4), ("bf16", 5e-2)])
def test_rlfn_x4_served_on_the_card_matches_the_reference(cuda, precision, tol):
    """``SRServer.open("rlfn_x4", backend="kernel", vertical_policy="halo")``
    on two 360 x 640 frames (weights from the registry's seed, biases set so
    that the HR frame is not all clipped) against the benchmark's plain
    reference in fp32: the README's tolerances, as K1's (fp32 as 3xTF32
    sums in another order; bf16 rounds every feature map)."""
    from repro_torch.models.rlfn import RLFNConfig, init_rlfn, rlfn_model

    ref = _bench_rlfn_reference()
    gen = torch.Generator().manual_seed(14)
    sd = init_rlfn(gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.05
    sd["upsampler.0.weight"] *= 0.1
    sd["upsampler.0.bias"] += 0.5
    frames = torch.rand((2, 360, 640, 3), generator=gen)
    server = engine.SRServer.open("rlfn_x4", layers=rlfn_model(sd, RLFNConfig()),
                                  backend="kernel", precision=precision, vertical_policy="halo",
                                  band_rows=60, device=cuda, autotune="off")
    hr = server.submit(frames).result()  # the first builds and warms its executor
    server.session().reset_stats()
    k1 = ttf.tilted_fusion_call.launches
    again = server.submit(frames).result()
    stats = server.session().stats()
    server.close()
    assert ttf.tilted_fusion_call.launches - k1 == 9  # conv_1, 6 blocks, conv_2, upsampler
    assert stats["esa_frames"] == 2 and stats["esa_device_ms"] > 0 and torch.equal(again, hr)
    with ref.exact():
        want = ref.rlfn(frames.to(cuda), {k: v.to(cuda) for k, v in sd.items()}, 4)
    err = (hr.float() - want).abs().max().item()
    assert hr.shape == (2, 1440, 2560, 3) and err <= tol, err


# ----------------------------------------------------------------------
# RLFN's ESA kernels (kernels/esa.py, csrc/esa.cu) against the plain chain
# ----------------------------------------------------------------------
# fp32 runs the 1x1s and the 3x3s as FMAs in another order than cuDNN (TF32
# off) and the same bilinear rule: a few ulps of values of order 1
ESA_FP32_TOL = 1e-5


def _esa_weights(seed=31):
    """Block 1's c5 and ESA weights from ``init_rlfn`` with biases that are
    not zero, as ``(w, b)`` pairs in ESAStage's order, fp32 on the CPU."""
    from repro_torch.models.rlfn import init_rlfn

    gen = torch.Generator().manual_seed(seed)
    sd = init_rlfn(gen)
    names = ("c5", "esa.conv1", "esa.conv_f", "esa.conv2", "esa.conv3", "esa.conv4")
    return tuple((sd[f"block_1.{n}.weight"],
                  torch.randn(sd[f"block_1.{n}.bias"].shape, generator=gen) * 0.05)
                 for n in names)


def _esa_frames(n, h, w, seed=32):
    return torch.randn((n, h, w, 52), generator=torch.Generator().manual_seed(seed)) * 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w", [(1, 360, 640), (8, 360, 640), (2, 36, 48), (3, 37, 53)])
def test_esa_kernels_match_the_chain(cuda, n, h, w, dtype):
    """``esa_call`` on the card against ``esa_plain``: in fp32 within
    ``ESA_FP32_TOL``; in bf16 the kernels' largest difference from the fp32
    chain at most 1.1x the bf16 chain's.  36 x 48 and 37 x 53 are the
    pool's smallest inputs (4 x 6 and 4 x 7 pooled) and ragged tiles; 37 x 53
    frames leave a partial last pixel tile."""
    from repro_torch.kernels import esa

    pairs = tuple(tuple(t.to(cuda) for t in wb) for wb in _esa_weights())
    x32 = _esa_frames(n, h, w).to(cuda)
    x = x32.to(dtype)
    launches = esa.esa_call.launches
    got = esa.esa_call(x, *pairs)
    torch.cuda.synchronize()
    assert esa.esa_call.launches == launches + esa.ESA_PASSES
    assert got.shape == x.shape and got.dtype == dtype and got.is_contiguous()
    want = esa.esa_plain(x.float(), *pairs)
    err = (got.float() - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= ESA_FP32_TOL, err
    else:
        chain = (esa.esa_plain(x, *pairs).float() - want).abs().max().item()
        assert err <= 1.1 * chain, (err, chain)
    assert torch.equal(esa.esa_call(x, *pairs), got)  # the same bits every call


def test_esa_kernels_refuse_what_they_do_not_take(cuda):
    """A non-contiguous input, other widths, an unsupported dtype and a
    frame below the pool's smallest raise; nothing is launched."""
    from repro_torch.kernels import esa

    pairs = tuple(tuple(t.to(cuda) for t in wb) for wb in _esa_weights())
    x = _esa_frames(1, 36, 48).to(cuda)
    launches = esa.esa_call.launches
    with pytest.raises(ValueError, match="contiguous"):
        esa.esa_call(torch.cat([x, x[..., :12]], -1)[..., :52], *pairs)
    with pytest.raises(ValueError, match="built for 52 features"):
        esa.esa_call(x[..., :48].contiguous(),
                     (pairs[0][0][:48, :48].contiguous(), pairs[0][1][:48]), *pairs[1:])
    wide = (torch.cat([pairs[1][0], pairs[1][0]]), torch.cat([pairs[1][1], pairs[1][1]]))
    with pytest.raises(ValueError, match="built for 52 features"):
        esa.esa_call(x, pairs[0], wide, *pairs[2:])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        esa.esa_call(x.half(), *pairs)
    with pytest.raises(ValueError, match="at least 15 x 15"):
        esa.esa_call(x[:, :14].contiguous(), *pairs)
    assert esa.esa_call.launches == launches


def test_rlfn_x4_dispatch_runs_esa_on_the_kernels(cuda, monkeypatch):
    """A served ``rlfn_x4`` dispatch in bf16 (two 360 x 640 frames, the
    cell's configuration) launches the ESA kernels ``ESA_PASSES`` times a
    block, six blocks (``esa_launches``), and its HR frames are those of the
    same server with ESA on the plain chain, within the cell's limit (0.03)."""
    from repro_torch.kernels import esa
    from repro_torch.models import rlfn

    model = _rlfn_model(14)
    frames = torch.rand((2, 360, 640, 3), generator=torch.Generator().manual_seed(15))

    def serve():
        server = engine.SRServer.open("rlfn_x4", layers=model, backend="kernel",
                                      precision="bf16", vertical_policy="halo", band_rows=60,
                                      device=cuda, autotune="off")
        server.submit(frames).result()  # builds and warms the executor
        server.session().reset_stats()
        hr = server.submit(frames).result()
        stats = server.session().stats()
        server.close()
        return hr, stats

    hr, stats = serve()
    assert stats["esa_launches"] == 6 * esa.ESA_PASSES and stats["esa_frames"] == 2
    monkeypatch.setattr(rlfn, "esa_call", lambda x, *pairs, clock=None: esa.esa_plain(x, *pairs))
    plain, plain_stats = serve()
    assert plain_stats["esa_launches"] == 0 and plain_stats["esa_frames"] == 2
    err = (hr.float() - plain.float()).abs().max().item()
    assert hr.shape == (2, 1440, 2560, 3) and err <= 0.03, err


def _rlfn_model(seed):
    """RLFN x4 from ``init_rlfn(seed)`` with the card tests' biases and
    upsampler (the HR frame mostly inside [0, 1])."""
    from repro_torch.models.rlfn import RLFNConfig, init_rlfn, rlfn_model

    gen = torch.Generator().manual_seed(seed)
    sd = init_rlfn(gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.05
    sd["upsampler.0.weight"] *= 0.1
    sd["upsampler.0.bias"] += 0.5
    return rlfn_model(sd, RLFNConfig())
