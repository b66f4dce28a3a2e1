"""K1's tensor-core datapath (``csrc/tilted_fusion.cu``), emulated on the
CPU and held against the JAX package's Pallas kernel (interpret mode) and
the port's plain version.

The CUDA kernel runs only on the card.  :func:`emulate_k1` walks its loops
in numpy: per band and segment (``SegmentPlan.ranges``) the sweep of tiles
with warm-up tiles that run layers 0..L-2.  On the narrow instances' on-chip
route (``ttf.route``: every band height the tests use) a tile's feature
maps stay in two shared-memory maps of R x (C + 2) pixels that the layer
steps take in turns: F_0 copied from the input stream (``first_col ++
x_stream``, zero left of the image) into the map the tile's layer 0 reads,
each deeper F_l's two carried columns copied from the overlap queue
(double-buffered by tile parity in device memory; zeros at a sweep's first
tile) into columns 0 and 1 of the map layer l - 1 writes its C fresh
columns into; a step's blocks are 256 consecutive pixels of the tile, and
rows outside the band are read as zero (``zero``) or clamped
(``replicate``).  On the device-memory route (the wide instances) the
windows are copied a row block at a time from the input stream or from
the carried columns and the C fresh columns of a ping-pong slab.  The
arithmetic is the MMAs': per tap (dy, dx) and k-step,
fp32 operands split into TF32 hi and lo (``ref.tf32_split``, as
``cvt.rna.tf32.f32`` rounds) and three products summed small terms first,
lo*hi, hi*lo, hi*hi (``terms=1``: hi*hi alone, single TF32), each MMA's
products summed exactly and rounded once into the fp32 accumulator; bf16
products (exact in fp32) summed the same way, k-steps of 16 with layer 0's
channels padded to 16, into a partial that starts at zero for each tap and
is then added to the accumulator in fp32.  Then the bias in fp32, the ReLU, the phantom-column
and row-bound masks, one rounding to the storage dtype.  A wide instance
walks its schedule (``ttf.wide_schedule``): per row block each n-group, and
in each the weight slices of ``taps`` taps (or half a tap).  A mixed launch
(ABPN x4's shape: hidden feature maps of 28 channels, 48 outputs) runs its
hidden layers at Chp 32 and its last layer in output groups of 32 + 16,
each group its own pass over the row blocks.

Tolerances (max abs diff): 5e-4 fp32, 5e-2 bf16, the README support
matrix's, against both the Pallas kernel and ``tilted_fusion_plain``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fusion import ConvLayer as JConvLayer
from repro.kernels import ops as jops
from repro.kernels import tilted_fusion as jtf

from repro_torch.core.fusion import halo_slabs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.kernels.ref import tf32_split
from repro_torch.models.abpn import ABPNConfig, layers_from_numpy

torch.set_num_threads(2)

TOL = {"fp32": 5e-4, "bf16": 5e-2}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
CHANNELS = ABPNConfig().channels  # 3, 28 x6, 27: L = 7, Chp 32, c0p 8
L, C, BAND_ROWS, WIDTH = len(CHANNELS) - 1, 8, 12, 64
# the wide instances' stacks: three layers to Chp 48 (ABPN x4's width, one
# n-group of 48, slices of three taps) and to Chp 128 (two n-groups of 64;
# fp32 slices of half a tap); "abpn64", ABPN x3 at 64 feature channels cut
# to four layers (one n-group of 64 in fp32, two of 32 in bf16); "x4", ABPN
# x4's shape cut to three layers, runs the mixed launch
WIDE = {"x3": CHANNELS, "chp48": [3, 40, 44, 48], "chp128": [3, 128, 120, 128],
        "abpn64": [3, 64, 64, 64, 27], "x4": [3, 28, 28, 48]}


def _round(a, precision):
    """float32 values representable in the precision's dtype."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(TDT[precision]).float().numpy()


def he_arrays(seed, precision, channels):
    """He weights and non-zero biases, ``(w, b, relu)`` a layer, rounded to
    the precision's dtype, drawn from ``seed`` (or a numpy ``Generator``,
    which goes on from where they end)."""
    rng = np.random.default_rng(seed)
    n = len(channels) - 1
    arrays = [((rng.normal(size=(3, 3, channels[i], channels[i + 1]))
                * (2.0 / (9 * channels[i])) ** 0.5).astype(np.float32),
               (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
               i < n - 1)
              for i in range(n)]
    return [(_round(w, precision), _round(b, precision), r) for w, b, r in arrays]


def abpn_stack(seed, precision, channels=CHANNELS):
    arrays = he_arrays(seed, precision, channels)
    return tops.pack_stack(layers_from_numpy(arrays, dtype=TDT[precision]), dtype=TDT[precision])


def k1_inputs(seed, precision, policy, spread="unit", layers=L, width=WIDTH, rows=BAND_ROWS):
    """Two bands of ``rows`` x ``width`` (``halo``: two slabs of rows + 2 L
    rows with bounds) of a frame made with numpy, and their K1
    arguments."""
    rng = np.random.default_rng(seed)
    frame = rng.uniform(size=(1, 2 * rows, width, 3)).astype(np.float32)
    if spread == "wide":  # pixels from 1e-3 to 10 of their unit value
        frame *= (10.0 ** rng.uniform(-3, 1, size=frame.shape)).astype(np.float32)
    frame = torch.from_numpy(_round(frame, precision)).to(TDT[precision])
    bounds = None
    if policy == "halo":
        bands, bounds = halo_slabs(frame, rows, layers)
    else:
        bands = frame.reshape(2, rows, width, 3)
    xs, first = tops.band_streams(bands, C, layers)
    return xs, first, bounds


def _kw(packed, policy, width=WIDTH):
    return dict(width=width, tile_cols=C, relu_flags=list(packed.relu), add_anchor=False,
                in_channels=3, row_policy="replicate" if policy == "replicate" else "zero")


def _mma_sum(acc, a, b, precision, terms):
    """acc + a @ b over one k-step as the tensor cores take it."""
    if precision == "bf16":
        pairs = [(a, b)]
    else:
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    for pa, pb in pairs:
        acc = (acc + pa.astype(np.float64) @ pb.astype(np.float64)).astype(np.float32)
    return acc


def emulate_k1(xs, first, w, b, *, width, tile_cols, relu_flags, row_policy="zero",
               row_bounds=None, precision="fp32", terms=3, segments=1, hidden=None, **_):
    """The CUDA kernel's loops and arithmetic in numpy -> tilted
    ``(B, R, K*C, Chp)`` float32 (values of the storage dtype).  ``w`` is
    packed to the instance's Chp.  Each (tile, layer) step walks the row
    blocks of the instance's window (``ttf.block_rows``) and, in each, the
    n-groups of its outputs (``ttf.n_group``: all Chp on a narrow instance)
    and in each n-group its weight slices (a narrow instance's stage holds
    all 9 taps; a wide one's slice ``ttf.wide_schedule(...).taps``
    consecutive taps, or half a tap's k-steps), tap by tap and k-step by
    k-step.  ``hidden`` (``ttf.hidden_chp``) emulates a mixed launch: the
    feature maps, the queue and the layers' K at ``hidden`` channels (the
    first ``hidden`` of the packed stack's), and the last layer one step an
    output group (``ttf.output_groups``), each walking every row block."""
    x = xs.float().numpy()
    f0 = first.float().numpy()
    wn, bn = w.float().numpy(), b.float().numpy()
    B, R, KC, c0p = x.shape
    Lw, chp = wn.shape[0], wn.shape[3]
    hid = hidden or chp  # the hidden feature maps' channels
    Cn, K = tile_cols, KC // tile_cols
    kk = 16 if precision == "bf16" else 8
    k0pad = -(-c0p // kk) * kk
    nr = ttf.block_rows(Cn, hid, TDT[precision])  # rows of a row block
    ng = ttf.n_group(chp, TDT[precision])  # outputs of an n-group
    sched = None if hidden else ttf.wide_schedule(chp, TDT[precision])
    taps = sched.taps if sched else 9  # taps of one weight slice (a narrow stage: all 9)
    halves = sched.halves if sched else 1  # slices a tap
    plan = ttf.segment_plan(B, K, Cn, Lw, sms=1, segments=segments)
    out = np.zeros((B, R, KC, chp), np.float32)
    rows = np.arange(R)
    if ttf.route(R, Cn, chp, TDT[precision], hidden).onchip:
        return _emulate_onchip(x, f0, wn, bn, out, plan, hid, k0pad, kk, width=width,
                               relu_flags=relu_flags, row_policy=row_policy,
                               row_bounds=row_bounds, precision=precision, terms=terms,
                               hidden=hidden)
    for band in range(B):
        ext = np.concatenate([f0[band], x[band]], axis=1)  # column a = input column a
        lo, hi = (0, R) if row_bounds is None else (int(row_bounds[band, 0]),
                                                    int(row_bounds[band, 1]))
        row_ok = ((rows >= lo) & (rows < hi))[:, None, None]
        for kw, k0, k1 in plan.ranges():
            queue = np.zeros((2, Lw - 1, R, 2, hid), np.float32)  # parity kw & 1 zeroed
            slab = [None, None]
            for k in range(kw, k1):
                for l in range(Lw if k >= k0 else Lw - 1):
                    if l == 0:  # the stream's columns kC-1 .. kC+C, zero left of the image
                        win = np.zeros((R, Cn + 2, k0pad), np.float32)
                        for wc in range(Cn + 2):
                            a = k * Cn - 1 + wc
                            if a >= 0:
                                win[:, wc, :c0p] = ext[:, a]
                        kdim = k0pad
                    else:
                        win = np.concatenate([queue[k & 1, l - 1], slab[(l - 1) & 1]], axis=1)
                        kdim = hid
                    if row_policy == "replicate":
                        win = np.concatenate([win[:1], win, win[-1:]], axis=0)
                    else:
                        win = np.pad(win, ((1, 1), (0, 0), (0, 0)))
                    # (row block, outputs) in the kernel's order: the row
                    # blocks of the instance's window and in each the
                    # n-groups (all Chp on a narrow instance; a wide one's
                    # (tap, n-group) slice of weights at a time); a mixed
                    # launch's last layer an output group at a time, each
                    # over every row block
                    nout = chp if l == Lw - 1 else hid
                    rows0 = range(0, R, nr)
                    if hidden and l == Lw - 1:
                        parts, g0 = [], 0
                        for gw in ttf.output_groups(chp):
                            parts += [(r0, g0, gw) for r0 in rows0]
                            g0 += gw
                    else:  # a mixed launch's hidden layers are narrow: one group
                        gw = nout if hidden else ng
                        parts = [(r0, g0, gw) for r0 in rows0 for g0 in range(0, nout, gw)]
                    acc = np.zeros((R, Cn, nout), np.float32)
                    for r0, g0, gw in parts:
                        rb = min(nr, R - r0)
                        blk = win[r0:r0 + rb + 2]  # the block's (rows + 2) x (C + 2) window
                        gacc = np.zeros((rb * Cn, gw), np.float32)
                        nk = kdim // kk  # k-steps a tap
                        for j in range(9 // taps * halves):  # one weight slice (stage)
                            h, piece = j % halves, -(-nk // halves)
                            for t in range(j // halves * taps, j // halves * taps + taps):
                                dy, dx = divmod(t, 3)
                                A = blk[dy:dy + rb, dx:dx + Cn].reshape(rb * Cn, kdim)
                                wt = wn[l, dy, dx, :, g0:g0 + gw]  # the (tap, group) B
                                # bf16 (whole taps): the tap's k-steps from
                                # zero, then one fp32 add
                                part = gacc if precision == "fp32" else np.zeros_like(gacc)
                                for s in range(h * piece, min(nk, (h + 1) * piece)):
                                    part = _mma_sum(part, A[:, kk * s:kk * (s + 1)],
                                                    wt[kk * s:kk * (s + 1)], precision, terms)
                                gacc = part if precision == "fp32" else gacc + part
                        acc[r0:r0 + rb, :, g0:g0 + gw] = gacc.reshape(rb, Cn, gw)
                    y = acc + bn[l, :nout]
                    if relu_flags[l]:
                        y = np.maximum(y, np.float32(0))
                    acol = k * Cn - l + np.arange(Cn)
                    keep = ((acol >= 0) & (acol < width))[None, :, None] & row_ok
                    y = _round(np.where(keep, y, np.float32(0)), precision)
                    if l < Lw - 1:
                        slab[l & 1] = y
                        queue[(k + 1) & 1, l] = y[:, Cn - 2:]
                    else:
                        out[band, :, k * Cn:(k + 1) * Cn] = y
    return out


def _emulate_onchip(x, f0, wn, bn, out, plan, hid, k0pad, kk, *, width, relu_flags, row_policy,
                    row_bounds, precision, terms, hidden):
    """:func:`emulate_k1` on the on-chip route of a narrow instance (or a
    mixed launch): the maps, the queue and the blocks of
    ``tilted_fusion_kernel_onchip``, the same arithmetic."""
    B, R, KC, c0p = x.shape
    Lw, chp = wn.shape[0], wn.shape[3]
    Cn = KC // plan.tiles
    rows = np.arange(R)
    pix = np.arange(R * Cn)
    pr, pc = pix // Cn, pix % Cn  # each pixel's row and column in the tile
    for band in range(B):
        ext = np.concatenate([f0[band], x[band]], axis=1)  # column a = input column a
        lo, hi = (0, R) if row_bounds is None else (int(row_bounds[band, 0]),
                                                    int(row_bounds[band, 1]))
        row_ok = ((rows >= lo) & (rows < hi))[:, None, None]
        for kw, k0, k1 in plan.ranges():
            queue = np.zeros((2, Lw - 1, R, 2, hid), np.float32)  # in device memory
            maps = [np.zeros((R, Cn + 2, hid), np.float32) for _ in range(2)]  # shared memory
            base = 0  # the sweep's layer steps before tile k: F_l sits in maps[(base + l) & 1]
            for k in range(kw, k1):
                nl = Lw if k >= k0 else Lw - 1
                # F_0: the stream's columns kC-1 .. kC+C into the map layer 0
                # reads, c0p channels and zeros to k0pad (the rest not read)
                m0 = maps[base & 1]
                m0[:, :, :k0pad] = 0
                for wc in range(Cn + 2):
                    if k * Cn - 1 + wc >= 0:
                        m0[:, wc, :c0p] = ext[:, k * Cn - 1 + wc]
                for l in range(nl):
                    src = maps[(base + l) & 1]
                    if l + 1 < nl:  # the carried columns of the map this layer writes
                        maps[(base + l + 1) & 1][:, :2] = 0 if k == kw else queue[k & 1, l]
                    kdim = k0pad if l == 0 else hid
                    win = src[:, :, :kdim]
                    if row_policy == "replicate":  # the MMAs clamp the row, or read zeros
                        win = np.concatenate([win[:1], win, win[-1:]], axis=0)
                    else:
                        win = np.pad(win, ((1, 1), (0, 0), (0, 0)))
                    # a mixed launch's last layer: one step an output group
                    groups = ttf.output_groups(chp) if hidden and l == Lw - 1 else \
                        [chp if l == Lw - 1 else hid]
                    nout = chp if l == Lw - 1 else hid
                    acc = np.zeros((R * Cn, nout), np.float32)
                    g0 = 0
                    for gw in groups:
                        for p0 in range(0, R * Cn, 256):  # a step's blocks of 256 pixels
                            blk = slice(p0, min(p0 + 256, R * Cn))
                            gacc = np.zeros((blk.stop - blk.start, gw), np.float32)
                            for t in range(9):
                                dy, dx = divmod(t, 3)
                                A = win[pr[blk] + dy, pc[blk] + dx]
                                wt = wn[l, dy, dx, :kdim, g0:g0 + gw]
                                part = gacc if precision == "fp32" else np.zeros_like(gacc)
                                for s in range(kdim // kk):
                                    part = _mma_sum(part, A[:, kk * s:kk * (s + 1)],
                                                    wt[kk * s:kk * (s + 1)], precision, terms)
                                gacc = part if precision == "fp32" else gacc + part
                            acc[blk, g0:g0 + gw] = gacc
                        g0 += gw
                    y = acc.reshape(R, Cn, nout) + bn[l, :nout]
                    if relu_flags[l]:
                        y = np.maximum(y, np.float32(0))
                    acol = k * Cn - l + np.arange(Cn)
                    keep = ((acol >= 0) & (acol < width))[None, :, None] & row_ok
                    y = _round(np.where(keep, y, np.float32(0)), precision)
                    if l < Lw - 1:
                        if l + 1 < nl:
                            maps[(base + l + 1) & 1][:, 2:] = y
                        queue[(k + 1) & 1, l] = y[:, Cn - 2:]
                    else:
                        out[band, :, k * Cn:(k + 1) * Cn] = y
                base += nl
    return out


def _jax_k1(xs, first, packed, bounds, policy, precision, width=WIDTH):
    jd = JDT[precision]
    return np.asarray(jtf.tilted_fusion_call(
        jnp.asarray(xs.float().numpy(), jd), jnp.asarray(first.float().numpy(), jd),
        jnp.asarray(packed.w.float().numpy(), jd), jnp.asarray(packed.b.float().numpy(), jd),
        row_bounds=None if bounds is None else jnp.asarray(bounds.numpy()), interpret=True,
        **_kw(packed, policy, width)), np.float32)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo"])
@pytest.mark.parametrize("stack", sorted(WIDE))
def test_emulated_datapath_matches_pallas_and_plain(stack, policy, precision):
    """Over two bands: ABPN x3 at full width (a narrow instance, Chp 32),
    three-layer stacks on the wide instances (Chp 48 and 128) and ABPN x3's
    shape at 64 features cut to four layers (Chp 64), on 32-row bands of 16
    columns: two row blocks a step, and ABPN x4's shape on the
    mixed launch (28 hidden channels at Chp 32, 48 outputs in groups of 32
    and 16, same bands): the emulated kernel against the Pallas kernel in
    interpret mode and against ``tilted_fusion_plain``, and bit-identical
    across segment counts; the mixed launch also bit-identical to the Chp 48
    instance on the same packed stack, whose extra k-steps add exact
    zeros."""
    channels = WIDE[stack]
    layers = len(channels) - 1
    width, rows = (WIDTH, BAND_ROWS) if stack == "x3" else (16, 32)
    packed = abpn_stack(3, precision, channels)
    assert packed.chp == ttf.launch_chp(max(channels))  # packed to the instance
    hidden = ttf.hidden_chp(packed.chp, packed.hidden_channels, 8, TDT[precision])
    assert hidden == (32 if stack == "x4" else None)
    xs, first, bounds = k1_inputs(4, precision, policy, layers=layers, width=width, rows=rows)
    kw = _kw(packed, policy, width)
    got = emulate_k1(xs, first, packed.w, packed.b, row_bounds=bounds, precision=precision,
                     hidden=hidden, **kw)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    want = _jax_k1(xs, first, packed, bounds, policy, precision, width)
    plain = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=bounds,
                                    **kw).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)
    np.testing.assert_allclose(got, plain, atol=TOL[precision], rtol=0)
    # each output element sums in one order wherever its tile falls
    three = emulate_k1(xs, first, packed.w, packed.b, row_bounds=bounds, precision=precision,
                       segments=3, hidden=hidden, **kw)
    np.testing.assert_array_equal(three, got)
    if hidden:
        wide = emulate_k1(xs, first, packed.w, packed.b, row_bounds=bounds,
                          precision=precision, **kw)
        np.testing.assert_array_equal(wide, got)


@pytest.mark.parametrize("spread", ["unit", "wide"])
def test_one_tf32_term_is_far_worse_than_three(spread):
    """Single TF32 (hi*hi) against 3xTF32, fp32 ``zero``, both against the
    plain version: three terms hold 5e-4 and one term is at least 10x worse.
    Over pixels spread from 1e-3 to 10 of their unit value (as the card
    test's wide case spreads them), one term misses 5e-4 outright."""
    packed = abpn_stack(5, "fp32")
    xs, first, _ = k1_inputs(6, "fp32", "zero", spread)
    kw = _kw(packed, "zero")
    plain = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw).float().numpy()
    err3 = np.abs(emulate_k1(xs, first, packed.w, packed.b, **kw) - plain).max()
    err1 = np.abs(emulate_k1(xs, first, packed.w, packed.b, terms=1, **kw) - plain).max()
    assert err3 <= TOL["fp32"], err3
    assert err1 >= 10 * err3, (err1, err3)
    if spread == "wide":
        assert err1 > TOL["fp32"], err1


def test_tf32_split_is_exact_in_two_words():
    """hi + lo keeps ~22 of a float32's 24 bits: the rest is below 2^-21 of
    the value, and hi and lo are TF32 values (13 low bits clear)."""
    v = np.random.default_rng(7).normal(size=4096).astype(np.float32) * 10.0 ** \
        np.random.default_rng(8).uniform(-3, 3, size=4096).astype(np.float32)
    hi, lo = tf32_split(v)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rest = np.abs(v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (rest <= np.abs(v.astype(np.float64)) * 2.0 ** -21).all()
    assert (np.abs(v - hi) > 0).any()  # one word alone is not the value


def test_wrapper_shapes_the_launch_as_the_kernel_does():
    """What the wrapper sizes for the kernel: the workspace head holds the
    packed stages (layer 0 at its own k-steps; on the on-chip route fp32
    unsplit, two words a lane an n8 block like bf16's pairs, on the
    device-memory route pre-split, four), the shared memory of the
    device-memory route is the same at every R and the on-chip route's
    holds the two maps, and a tile wider than the window's rows raises."""
    fp32 = ttf.packed_weight_bytes(7, 32, 8, torch.float32)
    bf16 = ttf.packed_weight_bytes(7, 32, 8, torch.bfloat16)
    assert fp32 == 4 * ((32 + 9 * 1 * 32 * 8) + 6 * (32 + 9 * 4 * 32 * 8))
    assert bf16 == 4 * ((32 + 9 * 1 * 32 * 8) + 6 * (32 + 9 * 2 * 32 * 8))
    assert fp32 % 16 == 0 and bf16 % 16 == 0
    split = ttf.packed_weight_bytes(7, 32, 8, torch.float32, onchip=False)
    assert split == 4 * ((32 + 9 * 1 * 32 * 16) + 6 * (32 + 9 * 4 * 32 * 16))
    assert ttf.packed_weight_bytes(7, 32, 8, torch.bfloat16, onchip=False) == bf16
    assert ttf.shared_bytes(32, torch.float32) == 229_632 < 232_448
    assert ttf.shared_bytes(32, torch.bfloat16) == 78_080
    assert ttf.shared_bytes(16, torch.float32) == 2 * 4 * (16 + 9 * 2 * 32 * 8) + 2 * 320 * 64
    for R in (12, 60, 74, 1009):
        kb = ttf.kernel_buffers(channels=CHANNELS, band_rows=R, tile_cols=C,
                                dtype=torch.bfloat16)
        rt = ttf.route(R, C, 32, torch.bfloat16)
        assert (kb["route"], kb["shared_bytes"]) == (rt.name, rt.shared_bytes)
        assert kb["packed_weight_bytes"] == bf16
        assert rt.onchip == (R <= 75) and (rt.shared_bytes == 78_080) == (R > 75)
    # a mixed launch (ABPN x4: 28 hidden channels, 48 outputs) packs x3's
    # stages and one more, the last layer's 16-output group (2 n8 blocks of
    # 2 words a lane), and runs on the Chp 32 instance's shared memory
    x4 = ABPNConfig(scale=4).channels
    for dt, words16, x3 in ((torch.float32, 16 + 9 * 4 * 32 * 4, fp32),
                            (torch.bfloat16, 16 + 9 * 2 * 32 * 4, bf16)):
        mixed = ttf.packed_weight_bytes(7, 48, 8, dt, hidden_chp=32)
        assert mixed == x3 + 4 * words16 and mixed % 16 == 0
        assert ttf.shared_bytes(48, dt, hidden_chp=32) == ttf.shared_bytes(32, dt)
        # the wide instance's own: two slices and its window
        assert ttf.shared_bytes(48, dt) == (177_152 if dt == torch.float32 else 63_488)
        kb = ttf.kernel_buffers(channels=x4, band_rows=60, tile_cols=C, dtype=dt)
        assert (kb["chp"], kb["hidden_chp"]) == (48, 32)
        assert kb["packed_weight_bytes"] == mixed
        assert kb["route"] == "onchip"
        assert kb["shared_bytes"] == (190_624 if dt == torch.float32 else 95_392)
        assert kb["buffers"]["slabs"]["shape"] == (2, 60, C + 2, 32)
        assert kb["buffers"]["slabs"]["memory"] == "shared"
        assert kb["buffers"]["overlap"]["shape"] == (2, 6, 60, 2, 32)
        assert kb["buffers"]["stream_out_per_column"]["shape"] == (60, 1, 48)
    assert ttf.output_groups(48) == [32, 16] and ttf.output_groups(128) == [32] * 4


@pytest.mark.parametrize("hidden", [0, -1, 49, 2.5, True, "28"])
def test_wrapper_rejects_a_hidden_width_outside_the_stack(hidden):
    """``hidden_channels`` must be None or an integer in [1, Chp]: on the
    CPU as on the card, before anything runs."""
    packed = abpn_stack(3, "fp32", [3, 28, 28, 48])
    xs, first, _ = k1_inputs(4, "fp32", "zero", layers=3, width=16, rows=4)
    with pytest.raises(ValueError, match="hidden_channels"):
        ttf.tilted_fusion_call(xs, first, packed.w, packed.b, hidden_channels=hidden,
                               **_kw(packed, "zero", 16))


def test_wrapper_on_the_cpu_computes_the_whole_stack_whatever_the_hidden_width():
    """The plain version ignores ``hidden_channels`` (its zero channels are
    the same function), and 1..Chp all pass the check; which launch the card
    makes of each (``ttf.hidden_chp``): mixed where F_0..F_{L-1} pad to 32
    and the stack is wider."""
    packed = abpn_stack(3, "fp32", [3, 28, 28, 48])
    xs, first, _ = k1_inputs(4, "fp32", "zero", layers=3, width=16, rows=4)
    kw = _kw(packed, "zero", 16)
    want = ttf.tilted_fusion_call(xs, first, packed.w, packed.b, **kw)
    for hidden in (1, 28, 32, 48):
        got = ttf.tilted_fusion_call(xs, first, packed.w, packed.b, hidden_channels=hidden, **kw)
        assert torch.equal(got, want), hidden
    assert [ttf.hidden_chp(48, h, 8) for h in (None, 1, 16, 28, 32, 33, 48)] == \
        [None, 32, 32, 32, 32, None, None]
    assert ttf.hidden_chp(32, 28, 8) is None and ttf.hidden_chp(128, 28, 40) is None


def test_wide_schedules_are_the_sources():
    """``ttf.wide_schedule`` is ``wide_sched`` in the CUDA source line for
    line, for every built wide instance in both dtypes (it sizes the
    packed weights the wrapper allocates and the shared memory the
    accounting reports); a narrow width has none, and a wide width no
    instance is built for raises."""
    src = (Path(ttf.__file__).parent / "csrc" / "tilted_fusion.cu").read_text()
    table = {}
    for neg, chp, fields in re.findall(
            r"  if \((!?)f32 && chp == (\d+)\) return \{([\d, ]+)\};", src):
        dt = torch.bfloat16 if neg else torch.float32
        table[(dt, int(chp))] = ttf.WideSchedule(*(int(v) for v in fields.split(",")))
    wide = [c for c in ttf.SUPPORTED_CHP if c > 32]
    assert set(table) == {(dt, c) for dt in TDT.values() for c in wide}
    for (dt, chp), sched in table.items():
        assert ttf.wide_schedule(chp, dt) == sched, (dt, chp)
    assert ttf.wide_schedule(32) is None and ttf.wide_schedule(16, torch.bfloat16) is None
    for chp in (40, 136):
        with pytest.raises(ValueError, match=f"no wide instance .* Chp {chp}"):
            ttf.wide_schedule(chp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wide_instances_shared_memory_and_packing(dtype):
    """Each wide instance's shared memory is two slices of ``taps`` (tap,
    n-group) B blocks (or half a tap's k-steps) and one window of 320
    pixels, within one CTA's 232,448 B and, where the schedule claims two
    CTAs an SM, half the SM; every instance keeps 30-row blocks at tile 8
    and tiles up to 104 columns; the packed weights do not depend on the
    schedule."""
    esize, k = dtype.itemsize, 16 if dtype == torch.bfloat16 else 8
    for chp in (48, 64, 96, 128):
        sched = ttf.wide_schedule(chp, dtype)
        words = (2 if dtype == torch.bfloat16 else 4) * sched.ng // 8  # a lane's, a k-step
        slice_bytes = sched.taps * (chp // k // sched.halves) * 32 * words * 4
        pix = chp * esize if chp * esize % 128 == 0 else chp * esize + 16
        want = 2 * slice_bytes + 320 * pix
        assert ttf.shared_bytes(chp, dtype) == want <= 232_448
        assert sched.ctas * (want + 1024) <= 233_472
        assert sched.halves == 1 or (sched.taps == 1 and dtype == torch.float32)
        assert ttf.window_pixels(chp, dtype) == 320 and ttf.block_rows(8, chp, dtype) == 30
        assert ttf.max_tile_cols(chp, dtype) == 104
        packed = ttf.packed_weight_bytes(7, chp, 8, dtype)
        ks0 = -(-8 // k)
        assert packed == 9 * (chp // sched.ng) * 32 * words * 4 * (ks0 + 6 * chp // k)
    if dtype == torch.float32:
        assert {c: ttf.shared_bytes(c) for c in (48, 64, 96, 128)} == {
            48: 177_152, 64: 147_456, 96: 196_608, 128: 229_376}
    else:
        assert {c: ttf.shared_bytes(c, dtype) for c in (48, 64, 96, 128)} == {
            48: 63_488, 64: 65_536, 96: 121_856, 128: 180_224}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_abpn_shaped_wide_stack_matches_pallas_and_plain(policy, precision, monkeypatch):
    """ABPN x3's shape at 64 feature channels ([3, 64, 64, 64, 27], Chp
    64) over two 32-row bands of a 64 x 16 image through the port's
    ``ops.tilted_fused_stack(..., chp=64)``, with K1 the emulated kernel
    (the wide instance's schedule), against the JAX package's
    ``ops.tilted_fused_stack(..., chp=64)`` in interpret mode and against
    the port's plain path."""
    rng = np.random.default_rng(64)
    arrays = he_arrays(rng, precision, [3, 64, 64, 64, 27])
    tl = layers_from_numpy(arrays, dtype=TDT[precision])
    jl = [JConvLayer(w=jnp.asarray(w, JDT[precision]), b=jnp.asarray(b, JDT[precision]), relu=r)
          for w, b, r in arrays]
    img = _round(rng.uniform(size=(64, 16, 3)).astype(np.float32), precision)
    kw = dict(band_rows=32, tile_cols=C, chp=64, vertical_policy=policy)
    want = np.asarray(jops.tilted_fused_stack(jnp.asarray(img, JDT[precision]), jl,
                                              interpret=True, **kw), np.float32)
    timg = torch.from_numpy(img).to(TDT[precision])
    plain = tops.tilted_fused_stack(timg, tl, **kw).float().numpy()
    calls = []

    def emulated(xs, first, w, b, *, compute_dtype=None, hidden_channels=None, **args):
        assert w.shape[-1] == 64 and ttf.launch_chp(64, xs.dtype) == 64
        assert ttf.hidden_chp(64, hidden_channels, xs.shape[3], xs.dtype) is None  # wide
        calls.append(xs.shape)
        out = emulate_k1(xs, first, w, b, precision=precision, **args)
        return torch.from_numpy(out).to(xs.dtype)

    monkeypatch.setattr(ttf, "tilted_fusion_call", emulated)
    got = tops.tilted_fused_stack(timg, tl, **kw).float().numpy()
    assert len(calls) == 1 and got.shape == (64, 16, 27)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)
    np.testing.assert_allclose(got, plain, atol=TOL[precision], rtol=0)
