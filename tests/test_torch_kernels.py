"""K1 (tilted fusion) in the PyTorch port vs the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version
(``tilted_fusion_plain``); the JAX side runs the Pallas kernel in interpret
mode, as the JAX package's own tests do.  Both get identical raw inputs
made with ``np.random.default_rng``.  Tolerances (max abs diff):

* fp32 — 5e-4, the README support matrix's fp32 bound: both sides
  accumulate in fp32, in a different order (observed ~1e-6);
* bf16 — 5e-2, the support matrix's bf16 bound: feature maps are rounded
  to bf16 after every layer on both sides, and one reordered fp32 sum can
  flip a rounding.

``tests/test_torch_cuda.py`` holds the CUDA kernel against its plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fusion import ConvLayer as JConvLayer
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tilted_fusion as jtf

from repro_torch.analysis.plan_check import SMEM_PER_BLOCK_BYTES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.models.abpn import layers_from_numpy

torch.set_num_threads(2)

TOL = {"fp32": 5e-4, "bf16": 5e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}

# the small stack of the issue: 3 layers, channels [3, 12, 12, 12], R = 20,
# W = 24, C = 4 (chp 16, c0p 8, K = 7)
CHANNELS = [3, 12, 12, 12]
R, W, C, B = 20, 24, 4, 2


def np_stack(seed, channels):
    rng = np.random.default_rng(seed)
    return [
        ((rng.normal(size=(3, 3, channels[i], channels[i + 1])) * 0.2).astype(np.float32),
         (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
         i < len(channels) - 2)
        for i in range(len(channels) - 1)
    ]


def both_stacks(seed, channels, precision="fp32"):
    """The same weights for both packages, rounded to the precision's dtype
    first so both sides start from identical values."""
    arrays = [(_round(w, precision), _round(b, precision), r) for w, b, r in np_stack(seed, channels)]
    jl = [JConvLayer(w=jnp.asarray(w, JDT[precision]), b=jnp.asarray(b, JDT[precision]), relu=r)
          for w, b, r in arrays]
    return jl, layers_from_numpy(arrays, dtype=TDT[precision])


def _round(a, precision):
    return torch.from_numpy(a).to(TDT[precision]).float().numpy()


def raw_inputs(seed, precision, chp=16, c0p=8, layers=3):
    """Raw K1 arguments: the fresh stream, first column, packed weights."""
    rng = np.random.default_rng(seed)
    K = -(-(W + layers - 1) // C)
    x = np.zeros((B, R, K * C, c0p), np.float32)
    x[:, :, : W - 1, :3] = rng.uniform(size=(B, R, W - 1, 3))  # columns 1..W-1
    first = np.zeros((B, R, 1, c0p), np.float32)
    first[..., :3] = rng.uniform(size=(B, R, 1, 3))
    w = np.zeros((layers, 3, 3, chp, chp), np.float32)
    b = np.zeros((layers, chp), np.float32)
    for l, (wl, bl, _) in enumerate(np_stack(seed + 1, CHANNELS)):
        w[l, :, :, : wl.shape[2], : wl.shape[3]] = wl
        b[l, : bl.shape[0]] = bl
    return [_round(a, precision) for a in (x, first, w, b)]


# ----------------------------------------------------------------------
# tilted_fusion_plain vs the Pallas kernel (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("anchor", [False, True], ids=["plain", "anchor"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo_bounds"])
def test_plain_matches_pallas_kernel(policy, precision, anchor):
    x, first, w, b = raw_inputs(11, precision)
    bounds = np.array([[2, 17], [0, 13]], np.int32) if policy == "halo_bounds" else None
    row_policy = "replicate" if policy == "replicate" else "zero"
    kw = dict(width=W, tile_cols=C, relu_flags=[True, True, False], add_anchor=anchor,
              in_channels=3, anchor_repeats=4, row_policy=row_policy)
    jd, td = JDT[precision], TDT[precision]
    j = jtf.tilted_fusion_call(
        jnp.asarray(x, jd), jnp.asarray(first, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
        row_bounds=None if bounds is None else jnp.asarray(bounds), interpret=True, **kw)
    launches = ttf.tilted_fusion_call.launches
    t = ttf.tilted_fusion_call(
        torch.from_numpy(x).to(td), torch.from_numpy(first).to(td),
        torch.from_numpy(w).to(td), torch.from_numpy(b).to(td),
        row_bounds=None if bounds is None else torch.from_numpy(bounds), **kw)
    # a CPU tensor takes the plain version and does not move the counter
    assert ttf.tilted_fusion_call.launches == launches
    assert t.dtype == td and tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[precision], rtol=0)


# ----------------------------------------------------------------------
# ops wrappers vs the JAX ones
# ----------------------------------------------------------------------
def test_pack_stack_equal():
    jl, tl = both_stacks(12, [3, 28, 28, 27])
    jp, tp = jops.pack_stack(jl), tops.pack_stack(tl)
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.b.numpy(), np.asarray(jp.b))
    assert (tp.chp, tp.relu, tp.out_channels, tp.num_layers) == \
        (jp.chp, jp.relu, jp.out_channels, jp.num_layers)
    jp16 = jops.pack_stack(jl, dtype=jnp.bfloat16)
    tp16 = tops.pack_stack(tl, dtype=torch.bfloat16)
    np.testing.assert_array_equal(tp16.w.float().numpy(), np.asarray(jp16.w, np.float32))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
def test_tilted_fused_frames_matches_jax(policy, precision):
    jl, tl = both_stacks(13, CHANNELS, precision)
    frames = _round(np.random.default_rng(14).uniform(size=(2, 40, W, 3)).astype(np.float32),
                    precision)
    kw = dict(band_rows=20, tile_cols=C, vertical_policy=policy)
    j = jops.tilted_fused_frames(jnp.asarray(frames, JDT[precision]), jl,
                                 compute_dtype=JDT[precision], interpret=True, **kw)
    t = tops.tilted_fused_frames(torch.from_numpy(frames).to(TDT[precision]), tl,
                                 compute_dtype=TDT[precision], **kw)
    assert tuple(t.shape) == tuple(j.shape) == (2, 40, W, 12)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[precision], rtol=0)


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_tilted_fused_band_stack_matches_jax(policy):
    from repro.core.fusion import halo_slabs as jhalo
    from repro_torch.core.fusion import halo_slabs as thalo

    jl, tl = both_stacks(15, CHANNELS)
    frames = np.random.default_rng(16).uniform(size=(1, 60, W, 3)).astype(np.float32)
    if policy == "halo":
        js, jb = jhalo(jnp.asarray(frames), 20, 3)
        ts, tb = thalo(torch.from_numpy(frames), 20, 3)
        pick = [2, 0]  # a subset, out of order
        j = jops.tilted_fused_band_stack(js[np.array(pick)], jl, tile_cols=C, vertical_policy="halo",
                                         row_bounds=jb[np.array(pick)], interpret=True)
        t = tops.tilted_fused_band_stack(ts[pick], tl, tile_cols=C, vertical_policy="halo",
                                         row_bounds=tb[pick])
    else:
        bands = frames.reshape(3, 20, W, 3)[[1, 2]]
        j = jops.tilted_fused_band_stack(jnp.asarray(bands), jl, tile_cols=C, interpret=True)
        t = tops.tilted_fused_band_stack(torch.from_numpy(bands), tl, tile_cols=C)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL["fp32"], rtol=0)


def test_tilted_fused_stack_and_ref_match_jax():
    jl, tl = both_stacks(17, [3, 12, 12, 12])
    img = np.random.default_rng(18).uniform(size=(40, W, 3)).astype(np.float32)
    j = jops.tilted_fused_stack(jnp.asarray(img), jl, band_rows=20, tile_cols=C,
                                add_anchor=True, anchor_repeats=4, interpret=True)
    t = tops.tilted_fused_stack(torch.from_numpy(img), tl, band_rows=20, tile_cols=C,
                                add_anchor=True, anchor_repeats=4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL["fp32"], rtol=0)
    jr = jref.tilted_fused_stack_ref(jnp.asarray(img), jl, band_rows=20, add_anchor=True,
                                     anchor_repeats=4)
    tr = tref.tilted_fused_stack_ref(torch.from_numpy(img), tl, band_rows=20, add_anchor=True,
                                     anchor_repeats=4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL["fp32"], rtol=0)
    np.testing.assert_allclose(t.numpy(), tr.numpy(), atol=TOL["fp32"], rtol=0)


# ----------------------------------------------------------------------
# Wrapper contract and buffer accounting
# ----------------------------------------------------------------------
def test_wrapper_rejects_bad_arguments():
    x, first, w, b = (torch.from_numpy(a) for a in raw_inputs(19, "fp32"))
    kw = dict(width=W, tile_cols=C, relu_flags=[True, True, False], add_anchor=False,
              in_channels=3)
    with pytest.raises(ValueError, match="row_policy"):
        ttf.tilted_fusion_call(x, first, w, b, row_policy="edge", **kw)
    with pytest.raises(ValueError, match="relu flags"):
        ttf.tilted_fusion_call(x, first, w, b, **{**kw, "relu_flags": [True]})
    with pytest.raises(ValueError, match="anchor"):
        ttf.tilted_fusion_call(x, first, w, b, **{**kw, "add_anchor": True, "anchor_repeats": 9})
    with pytest.raises(ValueError, match="first_col"):
        ttf.tilted_fusion_call(x, first[:1], w, b, **kw)


def test_kernel_buffers_bounded_in_r():
    """Every band height launches: up to 76 rows the two maps sit in shared
    memory beside one weight stage (ABPN's 60-row bands and 74-row halo
    slabs), and taller bands (86-row halo slabs of 72-row bands, the
    one-band fallback) take the device-memory route, whose slabs are
    workspace and whose shared memory is the same for every R."""
    ch = [3, 28, 28, 28, 28, 28, 28, 27]
    routes = {8: "onchip", 60: "onchip", 61: "onchip", 74: "onchip", 76: "onchip",
              77: "device", 86: "device", 1009: "device"}
    for rows in (8, 60, 61, 74, 76, 77, 86, 1009):
        kb = ttf.kernel_buffers(channels=ch, band_rows=rows, tile_cols=8)
        assert kb["chp"] == 32 and kb["c0p"] == 8
        assert kb["route"] == routes[rows]
        queue = 2 * 6 * rows * 2 * 32  # (2, L-1, R, 2, Chp), in device memory
        stage = 4 * (32 + 9 * 4 * 32 * 8)  # bias, then fp32 B unsplit: 36,992 B
        split = 4 * (32 + 9 * 4 * 32 * 16)  # the device-memory route's, pre-split
        if kb["route"] == "onchip":
            # two maps (R, C + 2, Chp) of 128-byte pixels, the stage, 32 B
            assert kb["shared_bytes"] == 2 * rows * 10 * 128 + stage + 32 <= 232_448
            assert kb["buffers"]["slabs"] == {"shape": (2, rows, 10, 32),
                                              "elements": 2 * rows * 10 * 32,
                                              "memory": "shared"}
            assert kb["device_slab_elements"] == 0 and kb["workspace_elements"] == queue
        else:
            assert kb["shared_bytes"] == 2 * split + 2 * 320 * 128 == 229_632
            assert kb["buffers"]["slabs"]["memory"] == "device"
            assert kb["device_slab_elements"] == 2 * rows * 8 * 32
            assert kb["workspace_elements"] == 2 * rows * 8 * 32 + queue
        assert kb["shared_bytes"] <= 232_448
        assert kb["buffers"]["overlap"]["logical_elements"] == 7 * rows * 2 * 28
    assert ttf.kernel_buffers(channels=ch, band_rows=60, tile_cols=8)["shared_bytes"] < 227 * 1024
    assert ttf.round_up_channels(28) == jtf.round_up_channels(28) == 32


def test_kernel_buffers_launch_total():
    ch = [3, 28, 28, 28, 28, 28, 28, 27]
    kb = ttf.kernel_buffers(channels=ch, band_rows=60, tile_cols=8, bands=6, segments=41)
    per_cta = 2 * 6 * 60 * 2 * 32  # the queue alone, 46,080: ~184 KB in fp32
    assert kb["route"] == "onchip" and kb["workspace_elements"] == per_cta
    assert kb["ctas"] == 6 * 41
    assert kb["launch_workspace_elements"] == 6 * 41 * per_cta
    one = ttf.kernel_buffers(channels=ch, band_rows=60, tile_cols=8)
    assert one["ctas"] == 1 and one["launch_workspace_elements"] == per_cta
    # a one-band fallback of 360 rows keeps its slabs in device memory
    tall = ttf.kernel_buffers(channels=ch, band_rows=360, tile_cols=8, bands=1, segments=41)
    assert tall["route"] == "device"
    assert tall["launch_workspace_elements"] == 41 * (2 * 360 * 8 * 32 + 2 * 6 * 360 * 2 * 32)


# ----------------------------------------------------------------------
# Channel widths: every Chp the Pallas kernel takes (8..128)
# ----------------------------------------------------------------------
def test_tilted_chp_128_lane_padding():
    """Twin of ``tests/test_kernels.py::test_tilted_chp_128_lane_padding``:
    the stack packed to Chp 128 (the widest instance on the card) gives
    the Pallas kernel's result and the reference's, at that test's
    tolerances."""
    jl, tl = both_stacks(6, [3, 28, 28, 27])
    img = np.random.default_rng(7).uniform(size=(30, 32, 3)).astype(np.float32)
    j = jops.tilted_fused_stack(jnp.asarray(img), jl, band_rows=30, tile_cols=8, chp=128,
                                interpret=True)
    t = tops.tilted_fused_stack(torch.from_numpy(img), tl, band_rows=30, tile_cols=8, chp=128)
    want = jref.tilted_fused_stack_ref(jnp.asarray(img), jl, band_rows=30)
    np.testing.assert_allclose(t.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5, rtol=1e-5)
    assert ttf.launch_chp(128) == 128  # the card launches the stack as packed


def _property_cases(n=8, seed=11):
    """Seeded draws over the ranges of ``test_tilted_fused_property``:
    (width 6-40, tile 2-8, depth 1-4, ch 1-8, bands 1-2, rows 4-10)."""
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in (rng.integers(6, 41), rng.integers(2, 9), rng.integers(1, 5),
                                   rng.integers(1, 9), rng.integers(1, 3), rng.integers(4, 11)))
            for _ in range(n)]


@pytest.mark.parametrize("width,tile,depth,ch,bands,rows", _property_cases())
def test_tilted_fused_property(width, tile, depth, ch, bands, rows):
    """Twin of ``tests/test_kernels.py::test_tilted_fused_property`` (``ch``
    1-8, so Chp 8, which the card pads to its Chp 16 instance): the port
    against the Pallas kernel and the reference at that test's
    tolerances."""
    jl, tl = both_stacks(depth * 7 + ch, [3] + [ch] * depth)
    img = np.random.default_rng(11).uniform(size=(bands * rows, width, 3)).astype(np.float32)
    j = jops.tilted_fused_stack(jnp.asarray(img), jl, band_rows=rows, tile_cols=tile,
                                interpret=True)
    t = tops.tilted_fused_stack(torch.from_numpy(img), tl, band_rows=rows, tile_cols=tile)
    want = jref.tilted_fused_stack_ref(jnp.asarray(img), jl, band_rows=rows)
    np.testing.assert_allclose(t.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5, rtol=1e-4)
    assert ttf.launch_chp(tops.pack_stack(tl).chp) == 16


@pytest.mark.parametrize("chp", range(8, 129, 8))
def test_launch_chp_pads_to_the_next_instance(chp):
    """Every multiple of 8 the Pallas kernel takes launches the smallest
    built instance at or above it; every instance fits one CTA's shared
    memory in both dtypes (half the SM where its schedule claims two CTAs
    an SM) and takes ``tile_cols`` 8; a wide instance's n-group divides its
    width and holds at most 96 outputs."""
    inst = ttf.launch_chp(chp)
    assert inst in ttf.SUPPORTED_CHP and inst >= chp
    assert all(c < chp for c in ttf.SUPPORTED_CHP if c < inst)
    assert ttf.launch_chp(chp - 7) == inst  # any count that rounds up to chp
    for dtype in (torch.float32, torch.bfloat16):
        assert ttf.launch_chp(chp, dtype) == inst
        assert ttf.shared_bytes(inst, dtype) <= SMEM_PER_BLOCK_BYTES == 232_448
        assert ttf.max_tile_cols(inst, dtype) >= 8 and ttf.block_rows(8, inst, dtype) >= 1
        assert inst % ttf.n_group(inst, dtype) == 0 and ttf.n_group(inst, dtype) <= 96
        sched = ttf.wide_schedule(inst, dtype)
        if sched:
            assert sched.ng == ttf.n_group(inst, dtype) and 9 % sched.taps == 0
            assert sched.ctas * (ttf.shared_bytes(inst, dtype) + 1024) <= 233_472
    with pytest.raises(ValueError, match="widest instance"):
        ttf.launch_chp(chp + 128)


def test_wrapper_pads_to_the_instance_and_records_it():
    """On ``meta`` tensors a Chp 8 stack is recorded with the Chp 16
    instance the card runs, and its result keeps the packed width."""
    x = torch.empty((2, 6, 16, 8), device="meta")
    first = torch.empty((2, 6, 1, 8), device="meta")
    w, b = torch.empty((2, 3, 3, 8, 8), device="meta"), torch.empty((2, 8), device="meta")
    with ttf.record_launches() as launches:
        out = ttf.tilted_fusion_call(x, first, w, b, width=14, tile_cols=4,
                                     relu_flags=[True, False], add_anchor=False, in_channels=3)
    assert tuple(out.shape) == (2, 6, 16, 8)
    (launch,) = launches
    assert launch.chp == 8 and launch.launch_chp == launch.instance_chp == 16
    with pytest.raises(ValueError, match="widest instance"):
        ttf.tilted_fusion_call(x, first, torch.empty((2, 3, 3, 136, 136), device="meta"),
                               torch.empty((2, 136), device="meta"), width=14, tile_cols=4,
                               relu_flags=[True, False], add_anchor=False, in_channels=3)


@pytest.mark.parametrize("ci,co", [(28, 48), (48, 48), (128, 128)])
def test_conv3x3_wide_plain_matches_pallas_kernel(ci, co):
    """K2 past 32 channels (ABPN x4's 28 -> 48, and the widest, 128 ->
    128): the plain version against the Pallas ``conv3x3_call`` in
    interpret mode at the JAX package's K2 tolerances."""
    from repro.kernels.conv3x3 import conv3x3_call as jconv3x3_call
    from repro_torch.kernels import conv3x3 as tk2

    rng = np.random.default_rng(ci + co)
    x = rng.uniform(size=(10, 20, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    j = jconv3x3_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tile_cols=8, relu=True,
                      interpret=True)
    t = tk2.conv3x3_call(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         tile_cols=8, relu=True)
    assert tk2.is_wide(ci, co) and max(ci, co) <= tk2.MAX_CHANNELS
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5, rtol=1e-5)
