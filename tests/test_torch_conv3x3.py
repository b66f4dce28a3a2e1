"""K2 (one SAME 3x3 conv layer) in the PyTorch port vs the JAX package's
Pallas kernel, and the layer-by-layer ABPN x3 datapath built on it.

On the CPU the port's ``ops.conv3x3`` runs the kernel's plain version
(``conv3x3_plain``); the JAX side runs its Pallas kernel in interpret mode
(``default_interpret()`` on the CPU), as ``tests/test_kernels.py`` does.
Both get identical raw inputs made with ``np.random.default_rng``.
Tolerances:

* fp32 single layer — ``atol 2e-5, rtol 1e-5``, the JAX package's own K2
  vs oracle tolerances: both sides accumulate in fp32, in another order;
* bf16 single layer — ``atol = rtol = 2e-2``: the only rounding is the
  single cast at the store, so one reordered sum can flip one bf16 ulp;
* the 7-layer stack and its HR output — 5e-4 max abs diff, the README
  support matrix's fp32 bound.

``tests/test_torch_cuda.py`` holds the CUDA kernel against its plain
version on the card.  Here, :func:`conv3x3_3xtf32` emulates the persistent
instances' fp32 arithmetic on the tensor cores (3xTF32) in numpy, to show
that it holds the fp32 tolerance where single TF32 does not, and
:func:`conv3x3_wide_3xtf32` the wide instance's (Ci or Co past 32): a
partial sum from zero for each (k-chunk of 32 channels, tap), added to one
fp32 accumulator, the taps folded into K at Ci <= 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core.fusion import ConvLayer as JConvLayer
from repro.core.fusion import conv_stack_reference as jconv_stack_reference
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import engine as tengine
from repro_torch.kernels import conv3x3 as tk2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import tf32_rna, tf32_split
from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

torch.set_num_threads(2)

FP32 = dict(atol=2e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
STACK_TOL = 5e-4


def np_layer(seed, shape, co):
    """Seeded raw (x, w, b) for one layer: x uniform in [0, 1), w and b
    normal, scaled as in ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[2], co)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    return x, w, b


def bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def both(x, w, b, *, tile_cols, relu, jdt=jnp.float32, tdt=torch.float32):
    """The JAX kernel (interpret mode) and the port's op on the same arrays."""
    j = jops.conv3x3(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                     tile_cols=tile_cols, relu=relu)
    launches = tk2.conv3x3_call.launches
    t = tops.conv3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                     torch.from_numpy(b).to(tdt), tile_cols=tile_cols, relu=relu)
    # a CPU tensor takes the plain version and does not move the counter
    assert tk2.conv3x3_call.launches == launches
    assert t.dtype == tdt and tuple(t.shape) == tuple(j.shape)
    return np.asarray(j, np.float32), t.float().numpy()


# ----------------------------------------------------------------------
# One layer: the JAX package's K2 test shapes and dtypes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape,co,tile", [
    ((60, 64, 28), 28, 8),
    ((60, 37, 28), 16, 8),  # width not a tile multiple: the last tile reads zeros
    ((15, 8, 3), 5, 4),
    ((8, 9, 1), 1, 2),      # one channel, a ragged last tile
])
def test_conv3x3_matches_pallas_kernel(shape, co, tile, relu):
    x, w, b = np_layer(1, shape, co)
    j, t = both(x, w, b, tile_cols=tile, relu=relu)
    assert t.shape == (*shape[:2], co)
    np.testing.assert_allclose(t, j, **FP32)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_conv3x3_bf16_matches_pallas_kernel(relu):
    x, w, b = (bf16_round(a) for a in np_layer(2, (20, 24, 8), 8))
    j, t = both(x, w, b, tile_cols=8, relu=relu, jdt=jnp.bfloat16, tdt=torch.bfloat16)
    np.testing.assert_allclose(t, j, **BF16)


def test_conv3x3_ref_matches_jax_ref():
    x, w, b = np_layer(3, (20, 37, 8), 12)
    for relu in (True, False):
        j = jref.conv3x3_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu)
        t = tref.conv3x3_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             relu=relu)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FP32)


@pytest.mark.parametrize("tile", [1, 3, 8, 64])
def test_conv3x3_does_not_depend_on_tile_cols(tile):
    x, w, b = (torch.from_numpy(a) for a in np_layer(4, (20, 37, 8), 12))
    want = tops.conv3x3(x, w, b, tile_cols=8)
    got = tops.conv3x3(x, w, b, tile_cols=tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), tref.conv3x3_ref(x, w, b).numpy(), **FP32)


# ----------------------------------------------------------------------
# The kernel's fp32 numerics on the tensor cores (3xTF32), emulated
# ----------------------------------------------------------------------
def conv3x3_3xtf32(x, w, b, *, relu, terms=3):
    """The kernel's fp32 path in numpy: A and B cut into K = 32 (the 9 taps
    folded into K where 9*Ci <= 32, else one pass per tap with Ci padded to
    32), k-steps of 8 as ``mma.m16n8k8``; each operand split into
    ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, each MMA's products summed
    exactly and rounded once into the fp32 accumulator, in the order
    lo*hi, hi*lo, hi*hi.  ``terms=1`` is single TF32 (hi*hi only)."""
    R, W, ci = x.shape
    co = w.shape[3]
    xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    shifted = [xp[dy:dy + R, dx:dx + W].reshape(R * W, ci) for dy in range(3) for dx in range(3)]
    if 9 * ci <= 32:
        passes = [(np.concatenate(shifted, axis=1), w.reshape(9 * ci, co))]
    else:
        passes = [(a, w[t // 3, t % 3]) for t, a in enumerate(shifted)]
    acc = np.zeros((R * W, co), np.float32)
    for a, bmat in passes:
        a = np.pad(a, ((0, 0), (0, 32 - a.shape[1])))
        bmat = np.pad(bmat, ((0, 32 - bmat.shape[0]), (0, 0)))
        for s in range(4):
            ak, bk = a[:, 8 * s:8 * s + 8], bmat[8 * s:8 * s + 8]
            (ah, al), (bh, bl) = tf32_split(ak), tf32_split(bk)
            products = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
            for pa, pb in products:
                acc = (acc + pa.astype(np.float64) @ pb.astype(np.float64)).astype(np.float32)
    out = acc + b
    if relu:
        out = np.maximum(out, np.float32(0))
    return out.reshape(R, W, co)


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    tie = np.float32(1 + ulp / 2)
    vals = np.array([tie, -tie, np.nextafter(tie, np.float32(0)), 1 + 3 * ulp / 2,
                     np.float32(3.0), np.float32(0.0)], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(vals), want)
    rng = np.random.default_rng(11)
    v = rng.normal(size=1000).astype(np.float32)
    r = tf32_rna(v)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(r - v) <= np.abs(v) * 2.0 ** -11).all()


@pytest.mark.parametrize("ci,co,relu", [(3, 28, True), (28, 28, True), (28, 27, False)],
                         ids=["3to28", "28to28", "28to27"])
def test_3xtf32_holds_the_fp32_tolerance(ci, co, relu):
    x, w, b = np_layer(12, (12, 20, ci), co)
    want = tk2.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             relu=relu).numpy()
    bound = FP32["atol"] + FP32["rtol"] * np.abs(want)
    err3 = np.abs(conv3x3_3xtf32(x, w, b, relu=relu) - want)
    err1 = np.abs(conv3x3_3xtf32(x, w, b, relu=relu, terms=1) - want)
    assert (err3 <= bound).all(), f"3xTF32 max err {err3.max():.3e}"
    # single TF32 misses the same tolerance: the test tells the two apart
    assert not (err1 <= bound).all(), f"single TF32 max err {err1.max():.3e}"
    assert err1.max() > 10 * err3.max()


def conv3x3_wide_3xtf32(x, w, b, *, relu, terms=3):
    """The wide instance's fp32 path in numpy.  Ci is cut into k-chunks of
    32 channels (zero past Ci) and each (chunk, tap) is one pass of K = 32;
    with Ci <= 3 the 9 taps fold into one pass (k = tap * Ci + ci, zero past
    9 * Ci).  A pass runs k-steps of 8 as ``wgmma`` m64nNk8: each operand
    split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, each MMA's
    products summed exactly and rounded once, in the order lo*hi, hi*lo,
    hi*hi, into a partial sum that starts from zero; the partial is then
    added to the one fp32 accumulator.  ``terms=1`` is single TF32."""
    R, W, ci = x.shape
    co = w.shape[3]
    xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    shifted = [xp[dy:dy + R, dx:dx + W].reshape(R * W, ci) for dy in range(3) for dx in range(3)]
    if ci <= tk2.FOLD_MAX_CI:
        passes = [(np.concatenate(shifted, axis=1), w.reshape(9 * ci, co))]
    else:
        passes = [(a[:, c:c + 32], w[t // 3, t % 3, c:c + 32])
                  for c in range(0, ci, 32) for t, a in enumerate(shifted)]
    acc = np.zeros((R * W, co), np.float32)
    for a, bmat in passes:
        a = np.pad(a, ((0, 0), (0, 32 - a.shape[1])))
        bmat = np.pad(bmat, ((0, 32 - bmat.shape[0]), (0, 0)))
        part = np.zeros_like(acc)
        for s in range(4):
            (ah, al), (bh, bl) = tf32_split(a[:, 8 * s:8 * s + 8]), tf32_split(bmat[8 * s:8 * s + 8])
            products = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
            for pa, pb in products:
                part = (part + pa.astype(np.float64) @ pb.astype(np.float64)).astype(np.float32)
        acc = acc + part
    out = acc + b
    if relu:
        out = np.maximum(out, np.float32(0))
    return out.reshape(R, W, co)


@pytest.mark.parametrize("ci,co,relu", [(3, 64, True), (64, 64, True), (128, 128, True),
                                        (128, 27, False)],
                         ids=["3to64", "64to64", "128to128", "128to27"])
def test_wide_3xtf32_holds_the_fp32_tolerance(ci, co, relu):
    """The wide instance's arithmetic (ABPN x3 at 64 and 128 feature
    channels: the folded first layer, the hidden layers, the last) holds
    K2's fp32 tolerance against the plain version; single TF32 misses it."""
    rng = np.random.default_rng(13)
    x = rng.uniform(size=(6, 11, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    assert tk2.is_wide(ci, co)
    want = tk2.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             relu=relu).numpy()
    bound = FP32["atol"] + FP32["rtol"] * np.abs(want)
    err3 = np.abs(conv3x3_wide_3xtf32(x, w, b, relu=relu) - want)
    err1 = np.abs(conv3x3_wide_3xtf32(x, w, b, relu=relu, terms=1) - want)
    assert (err3 <= bound).all(), f"3xTF32 max err {err3.max():.3e}"
    assert not (err1 <= bound).all(), f"single TF32 max err {err1.max():.3e}"


# ----------------------------------------------------------------------
# The wide instance's plan and what it copies, as the CUDA source builds it
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("ci,co", [(28, 48), (3, 64), (64, 64), (64, 27), (3, 128), (96, 96),
                                   (128, 128), (128, 27), (40, 33)])
def test_wide_plan_fits_an_sm(ci, co, dtype):
    """Every wide layer shape gets an instance whose shared memory fits an
    H100 SM (232,448 bytes a block), whose tile is whole 8-row blocks of 32
    columns and whose warpgroups hold all of N between them."""
    plan = tk2.wide_plan(ci, co, dtype)
    assert plan["n"] >= co and plan["n"] in (32, 48, 64, 96, 128)
    assert plan["fold"] == (ci <= 3)
    assert plan["smem_bytes"] <= 232448
    assert plan["rows"] % 8 == 0 and plan["rows"] == 2 * plan["mb"] * (2 // plan["og"])
    assert plan["steps"] == (1 if plan["fold"] else 9 // plan["tp"] * -(-ci // 32))
    assert plan["stages"] >= (1 if plan["fold"] else 2)
    assert 1 <= plan["pp"] <= min(4, plan["mb"] * plan["nh"])
    assert (plan["n"] // plan["og"]) % (16 * plan["nh"]) == 0


def test_wide_plan_rejects_narrow_layers():
    with pytest.raises(ValueError, match="persistent"):
        tk2.wide_plan(28, 28, torch.float32)


def test_wide_copies_at_128_to_128():
    """A 128 -> 128 layer over one 360x640 frame: the windows are copied
    once a (tile, k-chunk), not once a (tile, k-chunk, 32 outputs), and
    every tile copies all 36 of its slices (the weights of all outputs)."""
    plan = tk2.wide_plan(128, 128, torch.float32)
    tiles = -(-360 // plan["rows"]) * 20
    got = tk2.wide_copies(128, 128, 360, 640, torch.float32)
    assert got["cta_chunks"] == tiles * 4
    assert got["window_bytes"] == tiles * 4 * (plan["rows"] + 2) * 34 * 32 * 4
    assert got["weight_bytes"] == tiles * plan["steps"] * plan["tp"] * 32 * 128 * 8
    assert got["smem_bytes"] == got["window_bytes"] + got["weight_bytes"]
    # folded: one slice a CTA, resident
    folded = tk2.wide_copies(3, 64, 360, 640, torch.bfloat16, sms=132)
    assert folded["weight_bytes"] == 132 * 32 * 64 * 2


# ----------------------------------------------------------------------
# The slice: ABPN x3 layer by layer through K2, at 24x32
# ----------------------------------------------------------------------
def abpn_arrays(seed, features=28):
    ch = ABPNConfig(feature_channels=features).channels  # 3, F x6, 27
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(3, 3, ch[i], ch[i + 1])) * (2.0 / (9 * ch[i])) ** 0.5)
             .astype(np.float32),
             (rng.normal(size=(ch[i + 1],)) * 0.1).astype(np.float32),
             i < len(ch) - 2)
            for i in range(len(ch) - 1)]


@pytest.mark.parametrize("features", [28, 64], ids=["F28", "F64"])
def test_layerwise_abpn_matches_jax(features):
    """ABPN x3 layer by layer (F = 28: the persistent instances on the
    card; F = 64: every layer on the wide one), held to the JAX package's
    ``ops.conv3x3`` in interpret mode, its conv-stack reference and its
    reference backend's HR frame."""
    arrays = abpn_arrays(5, features)
    jl = [JConvLayer(w=jnp.asarray(w), b=jnp.asarray(b), relu=r) for w, b, r in arrays]
    tl = layers_from_numpy(arrays)
    lr = np.random.default_rng(6).uniform(size=(24, 32, 3)).astype(np.float32)

    jf, tf = jnp.asarray(lr), torch.from_numpy(lr)
    for jlayer, tlayer in zip(jl, tl):
        jf = jops.conv3x3(jf, jlayer.w, jlayer.b, relu=jlayer.relu)
        tf = tops.conv3x3(tf, tlayer.w, tlayer.b, relu=tlayer.relu)
    assert tuple(tf.shape) == (24, 32, 27)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=STACK_TOL, rtol=0)
    want = jconv_stack_reference(jnp.asarray(lr), jl)
    np.testing.assert_allclose(tf.numpy(), np.asarray(want), atol=STACK_TOL, rtol=0)

    # the HR frame: the port's epilogue over the layer-by-layer features vs
    # the JAX package's reference backend
    plan = tengine.make_plan(tl, lr.shape, backend="reference", scale=3)
    hr = tengine.sr_epilogue(plan, torch.from_numpy(lr)[None], tf[None], torch.float32)
    jplan = jengine.make_plan(jl, lr.shape, backend="reference", scale=3)
    jhr = jengine.run(jplan, jl, jnp.asarray(lr)[None])
    assert tuple(hr.shape) == (1, 72, 96, 3)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), atol=STACK_TOL, rtol=0)


# ----------------------------------------------------------------------
# Argument checks
# ----------------------------------------------------------------------
def _bad_args():
    x, w, b = (torch.from_numpy(a) for a in np_layer(7, (8, 9, 4), 6))
    return {
        "x_ndim": (x[None], w, b, 8, "x must be"),
        "w_ci": (x, w[:, :, :3], b, 8, "w must be"),
        "b_len": (x, w, b[:5], 8, "b must be"),
        "mixed_dtypes": (x, w.double(), b, 8, "one dtype"),
        "tile_cols_0": (x, w, b, 0, "tile_cols"),
    }


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_conv3x3_rejects_bad_arguments(case):
    x, w, b, tile, match = _bad_args()[case]
    with pytest.raises(ValueError, match=match):
        tops.conv3x3(x, w, b, tile_cols=tile)
