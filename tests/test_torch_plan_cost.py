"""The port's ``engine.plan_cost`` against the JAX package's, and K1's own
accounting (``kernels.tilted_fusion.launch_cost``) against what its plain
version and its wrapper do.

* ``plan_cost(device="cpu")`` vs the JAX ``plan_cost`` on the same ABPN x3
  weights (``init_abpn(PRNGKey(0))`` crossing through numpy), 24x32 LR,
  ``band_rows`` 12, ``tile_cols`` 8, batch 2, for every backend x policy x
  precision that ``make_plan`` takes: the same six keys; ``flops``,
  ``flops_per_frame`` and ``weight_bytes_resident`` exactly equal.  Both
  count 2 FLOPs per multiply-add of every product (the reference's HLO
  dots, the port's ``FlopCounterMode`` plus ``launch_cost`` for K1, whose
  plain version pads layer 0 to Chp channels as the interpreted Pallas
  kernel does).
* ``hbm_bytes`` is not compared: XLA counts the operands of fused HLO
  instructions, the port the bytes of its eager operators plus what K1
  issues, so the two differ by design.  It is held to a floor every
  program must move: the frames read, the HR output written and the
  resident weights.
* ``launch_cost``: its FLOPs on the plain route equal a ``meta`` trace of
  ``tilted_fusion_plain`` exactly for every forced segment count; its part
  (a) equals the bytes of the tensors the wrapper is given and returns;
  its part (b) equals a count made by walking the CUDA source's loops.
* At the design point (360x640, batch 8) ``plan_cost`` on the CPU traces
  ``meta`` frames only and counts K1 with ``launch_cost``, never the
  plain tile loop.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import engine as jengine
from repro.models.abpn import init_abpn as jinit_abpn
from repro_torch import engine as tengine
from repro_torch.kernels import ops
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.models.abpn import init_abpn, layers_from_numpy
from repro_torch.roofline.trace_cost import trace_cost

torch.set_num_threads(2)

LR, BAND_ROWS, TILE_COLS, BATCH, SCALE = (24, 32, 3), 12, 8, 2, 3
JLAYERS = jinit_abpn(jax.random.PRNGKey(0))
TLAYERS = layers_from_numpy([(np.asarray(l.w), np.asarray(l.b), l.relu) for l in JLAYERS])
MATRIX = [(b, p, q) for b in ("reference", "tilted", "kernel")
          for p in ("zero", "halo", "replicate") for q in ("fp32", "bf16", "int8")]
KEYS = {"batch", "flops", "hbm_bytes", "flops_per_frame", "hbm_bytes_per_frame",
        "weight_bytes_resident"}
L, CHP, C0P = 7, 32, 8  # ABPN x3: 7 layers, widest 28 -> Chp 32, 3 input channels -> 8


@pytest.mark.parametrize("backend,policy,precision", MATRIX)
def test_plan_cost_matches_jax(backend, policy, precision):
    kw = dict(band_rows=BAND_ROWS, tile_cols=TILE_COLS, scale=SCALE, vertical_policy=policy,
              precision=precision, backend=backend)
    want = jengine.plan_cost(jengine.make_plan(JLAYERS, LR, **kw), JLAYERS, BATCH)
    got = tengine.plan_cost(tengine.make_plan(TLAYERS, LR, **kw), TLAYERS, BATCH, device="cpu")
    assert set(got) == set(want) == KEYS
    for k in ("batch", "flops", "flops_per_frame", "weight_bytes_resident"):
        assert got[k] == want[k], k
    frames_in = BATCH * 24 * 32 * 3 * 4
    hr_out = BATCH * 72 * 96 * 3 * 4
    assert got["hbm_bytes"] >= frames_in + hr_out + got["weight_bytes_resident"]
    assert got["hbm_bytes_per_frame"] == got["hbm_bytes"] // BATCH


@pytest.mark.parametrize("backend,policy,flops", [
    ("reference", "zero", 131_604_480), ("tilted", "zero", 164_505_600),
    ("tilted", "replicate", 164_505_600), ("tilted", "halo", 356_428_800),
    ("kernel", "zero", 247_726_080), ("kernel", "replicate", 247_726_080),
    ("kernel", "halo", 536_739_840)])
def test_plan_cost_flops_by_hand(backend, policy, flops):
    """The counts the parity test finds, from the geometry: 2 x 9 x Ci x Co
    per output pixel and layer.  ``reference`` runs the unpadded stack over
    the frames; ``tilted`` its K = 5 tiles of 8 columns (the tilt's L - 1
    extra columns); the plain K1 pads every layer to 32 x 32; ``halo`` runs
    12 + 2 x 7 = 26 rows a band."""
    plan = tengine.make_plan(TLAYERS, LR, band_rows=BAND_ROWS, tile_cols=TILE_COLS, scale=SCALE,
                             vertical_policy=policy, backend=backend)
    macs = sum(9 * l.ci * l.co for l in TLAYERS)  # 42,840 a pixel
    rows = BAND_ROWS + 2 * L if policy == "halo" else BAND_ROWS
    by_backend = {"reference": 24 * 32 * macs, "tilted": 2 * rows * 5 * TILE_COLS * macs,
                  "kernel": 2 * rows * 5 * TILE_COLS * L * 9 * CHP * CHP}
    assert 2 * BATCH * by_backend[backend] == flops
    assert tengine.plan_cost(plan, TLAYERS, BATCH, device="cpu")["flops"] == flops


def test_plan_cost_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tengine.make_plan(TLAYERS, LR, band_rows=BAND_ROWS, scale=SCALE, backend="kernel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.plan_cost(plan, TLAYERS, BATCH)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tengine.plan_cost(plan, TLAYERS, BATCH, device="meta")


@pytest.mark.parametrize("backend", ["tilted", "kernel"])
def test_plan_cost_reuses_a_prepared_stack(backend, monkeypatch):
    plan = tengine.make_plan(TLAYERS, LR, band_rows=BAND_ROWS, scale=SCALE, backend=backend,
                             precision="bf16")
    stack = tengine.prepare_stack(plan, TLAYERS)
    want = tengine.plan_cost(plan, TLAYERS, BATCH, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a given stack must not be prepared again")

    monkeypatch.setattr("repro_torch.engine.executor.prepare_stack", refuse)
    assert tengine.plan_cost(plan, None, BATCH, stack=stack, device="cpu") == want
    assert want["weight_bytes_resident"] == stack.nbytes() == (86_070 if backend == "tilted"
                                                               else 215_542)


def test_plan_cost_is_the_sum_of_its_terms():
    plan = tengine.make_plan(TLAYERS, LR, band_rows=BAND_ROWS, scale=SCALE, backend="kernel",
                             vertical_policy="halo")
    terms = tengine.plan_cost_terms(plan, TLAYERS, BATCH, device="cpu")
    cost = tengine.plan_cost(plan, TLAYERS, BATCH, device="cpu")
    (k1,) = terms["k1"]  # the whole batch is one launch
    assert k1["plan"] == ttf.segment_plan(2 * BATCH, 5, TILE_COLS, L, sms=1)
    assert terms["glue"]["flops"] == 0  # the glue multiplies nothing
    assert terms["cost"] == cost
    assert cost["flops"] == k1["flops"]
    assert cost["hbm_bytes"] == terms["glue"]["hbm_bytes"] + k1["io_bytes"] + k1["workspace_bytes"]
    assert k1["bytes"] == k1["io_bytes"] + k1["workspace_bytes"]
    assert terms["glue"]["hbm_bytes"] > 0 and k1["workspace_bytes"] > 0


def test_plan_cost_counts_the_instance_a_chp8_stack_launches(monkeypatch):
    """A [3, 8, 8, 3] stack (scale 1) packs to Chp 8, which the card runs on
    its Chp 16 instance: ``plan_cost``'s K1 term on the card counts
    ``launch_cost`` at Chp 16, on the CPU the plain version's at Chp 8.
    The card's segment plan is replaced by one SM's, so that the count is
    made here: 4 bands of 5 tiles, 96 pixels a tile in 6 m16 fragments,
    layer 0's 8 input channels one fp32 k-step, 16 outputs a layer."""
    rng = np.random.default_rng(5)
    layers = layers_from_numpy([
        ((rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32),
         (rng.normal(size=(co,)) * 0.1).astype(np.float32), i < 2)
        for i, (ci, co) in enumerate([(3, 8), (8, 8), (8, 3)])])
    plan = tengine.make_plan(layers, LR, band_rows=BAND_ROWS, tile_cols=TILE_COLS, scale=1,
                             backend="kernel")
    one_sm = ttf.segment_plan(2 * BATCH, 5, TILE_COLS, 3, sms=1)
    monkeypatch.setattr(ttf.Launch, "plan", lambda self, device: one_sm)
    (card,) = tengine.plan_cost_terms(plan, layers, BATCH, device="cuda")["k1"]
    (cpu,) = tengine.plan_cost_terms(plan, layers, BATCH, device="cpu")["k1"]
    common = dict(band_rows=BAND_ROWS, tile_cols=TILE_COLS, c0p=8, num_layers=3,
                  dtype=torch.float32)
    assert card == dict(ttf.launch_cost(one_sm, chp=16, **common), plan=one_sm)
    assert cpu == dict(ttf.launch_cost(one_sm, chp=8, plain=True, **common), plan=one_sm)
    assert card["flops"] == 4 * 5 * 2 * 96 * 9 * 16 * (8 + 16 + 16) == 22_118_400
    assert cpu["flops"] == 4 * 5 * 2 * 96 * 9 * 8 * (3 * 8)
    # the tilted result is the instance's 16 channels on the card
    assert card["io_bytes"] - cpu["io_bytes"] == 4 * (4 * BAND_ROWS * 5 * TILE_COLS * 8
                                                      + 3 * (9 * (16 ** 2 - 8 ** 2) + 8))


def _x4_layers():
    """ABPN x4's shape (3 -> 28 x6 -> 48) with seeded weights."""
    from repro_torch.models.abpn import ABPNConfig

    rng = np.random.default_rng(6)
    ch = ABPNConfig(scale=4).channels
    return layers_from_numpy([
        ((rng.normal(size=(3, 3, ch[i], ch[i + 1])) * 0.1).astype(np.float32),
         (rng.normal(size=(ch[i + 1],)) * 0.1).astype(np.float32), i < len(ch) - 2)
        for i in range(len(ch) - 1)])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plan_cost_counts_abpn_x4_at_the_hidden_width(precision, monkeypatch):
    """ABPN x4 on the card is a mixed launch: its hidden layers at Chp 32
    and its last layer's 48 outputs from 32 channels, 9 x (8 x 32 + 5 x 32
    x 32 + 32 x 48) = 62,208 multiply-adds a pixel that the MMAs cover
    (``_mma_pixels``), on every tile of the plan (one SM's, so no warm-up
    tile: 4 bands of 5).  bf16 reads layer 0's 8 channels in a k-step of
    16.  The wide Chp 48 instance would execute 127,872 (fp32); the CPU's
    plain version pads everything to 48."""
    layers = _x4_layers()
    plan = tengine.make_plan(layers, LR, band_rows=BAND_ROWS, tile_cols=TILE_COLS, scale=4,
                             backend="kernel", precision=precision)
    one_sm = ttf.segment_plan(2 * BATCH, 5, TILE_COLS, L, sms=1)
    assert one_sm.segments == 1  # no segment restarts, so no warm-up tile
    monkeypatch.setattr(ttf.Launch, "plan", lambda self, device: one_sm)
    (card,) = tengine.plan_cost_terms(plan, layers, BATCH, device="cuda")["k1"]
    (cpu,) = tengine.plan_cost_terms(plan, layers, BATCH, device="cpu")["k1"]
    k0 = 16 if precision == "bf16" else C0P
    macs = 9 * (k0 * 32 + 5 * 32 * 32 + 32 * 48)
    assert 9 * (8 * 32 + 5 * 32 * 32 + 32 * 48) == 62_208
    tiles = one_sm.bands * one_sm.tiles
    assert card["flops"] == 2 * macs * ttf._mma_pixels(BAND_ROWS, TILE_COLS) * tiles
    assert cpu["flops"] == 2 * 9 * 48 * 48 * L * BAND_ROWS * TILE_COLS * tiles
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    wide = ttf.launch_cost(one_sm, band_rows=BAND_ROWS, tile_cols=TILE_COLS, c0p=C0P, chp=48,
                           num_layers=L, dtype=dtype)
    assert wide["flops"] == 2 * 9 * 48 * (k0 + 6 * 48) * ttf._mma_pixels(BAND_ROWS, TILE_COLS) \
        * tiles
    assert 9 * 48 * (8 + 6 * 48) == 127_872
    # the same output: (a) differs by the weight blocks the packing reads
    assert wide["io_bytes"] - card["io_bytes"] == dtype.itemsize * 9 * (
        6 * 48 * 48 + 48 * 48 - 6 * 32 * 32 - 32 * 48) + dtype.itemsize * 6 * (48 - 32)


# ----------------------------------------------------------------------
# launch_cost
# ----------------------------------------------------------------------
def _meta_args(bands, rows, tiles, dtype=torch.float32, bounds=False):
    meta = dict(device="meta", dtype=dtype)
    args = (torch.empty((bands, rows, tiles * TILE_COLS, C0P), **meta),
            torch.empty((bands, rows, 1, C0P), **meta),
            torch.empty((L, 3, 3, CHP, CHP), **meta), torch.empty((L, CHP), **meta))
    extra = dict(width=tiles * TILE_COLS - L + 1, tile_cols=TILE_COLS,
                 relu_flags=[True] * (L - 1) + [False], add_anchor=False, in_channels=3)
    if bounds:
        extra["row_bounds"] = torch.empty((bands, 2), dtype=torch.int32, device="meta")
    return args, extra


@pytest.mark.parametrize("policy", ["zero", "replicate", "halo"])
@pytest.mark.parametrize("segments", [1, 2, 3, "K"])
def test_launch_cost_on_the_plain_route_equals_the_traced_plain(segments, policy):
    """4 bands of 12 x 32 (K = 5 tiles; 26-row slabs with bounds under
    halo): the FLOPs of ``tilted_fusion_plain`` on ``meta`` tensors, every
    warm-up tile of the forced segments included."""
    K = 5
    S = K if segments == "K" else segments
    rows = BAND_ROWS + 2 * L if policy == "halo" else BAND_ROWS
    args, kw = _meta_args(4, rows, K, bounds=policy == "halo")
    if policy == "replicate":
        kw["row_policy"] = "replicate"
    traced = trace_cost(ttf.tilted_fusion_plain, *args, segments=S, **kw)
    plan = ttf.segment_plan(4, K, TILE_COLS, L, sms=1, segments=S)
    got = ttf.launch_cost(plan, band_rows=rows, tile_cols=TILE_COLS, c0p=C0P, chp=CHP,
                          num_layers=L, dtype=torch.float32, bounds=policy == "halo", plain=True)
    assert got["flops"] == traced.flops
    if policy != "halo" and S <= 3:
        assert got["flops"] == {1: 247_726_080, 2: 332_660_736, 3: 375_128_064}[S]


def test_launch_cost_counts_the_kernels_rows_and_channels():
    """The card's count differs from the plain's in two ways only: layer 0
    reads c0p channels padded to the MMA's k (8 in fp32, 16 in bf16), and
    each row block's pixels run in whole m16 fragments (an odd R runs one
    more row at C = 8)."""
    plan = ttf.segment_plan(3, 6, TILE_COLS, L, sms=4, segments=2)
    for dtype, k0 in ((torch.float32, C0P), (torch.bfloat16, 16)):
        common = dict(tile_cols=TILE_COLS, c0p=C0P, chp=CHP, num_layers=L, dtype=dtype)
        tiles = ttf.launch_cost(plan, band_rows=13, **common)["tiles"]
        assert tiles == 3 * (6 + plan.warmup)  # the second segment re-runs w tiles
        per_tile = 2 * TILE_COLS * 9 * CHP * (CHP - k0)  # layer 0's padding, a row
        card = ttf.launch_cost(plan, band_rows=14, **common)["flops"]
        plain = ttf.launch_cost(plan, band_rows=14, plain=True, **common)["flops"]
        assert plain - card == tiles * 14 * per_tile
        assert ttf.launch_cost(plan, band_rows=13, **common)["flops"] == card
        assert ttf.launch_cost(plan, band_rows=13, plain=True, **common)["flops"] == plain * 13 // 14
    # C = 3: a 13 x 3 tile is one row block of 39 pixels, three m16 fragments
    plan3 = ttf.segment_plan(1, 4, 3, L, sms=1, segments=1)
    got = ttf.launch_cost(plan3, band_rows=13, tile_cols=3, c0p=C0P, chp=CHP, num_layers=L,
                          dtype=torch.float32)
    assert got["flops"] == 4 * 2 * 48 * 9 * CHP * (C0P + (L - 1) * CHP)
    # the window's 320 pixels hold 3 rows of a tile up to C = 104
    assert ttf.MAX_TILE_COLS == 104 and ttf.block_rows(104) == 1 and ttf.block_rows(105) == 0
    assert ttf.block_rows(TILE_COLS) == 30 and ttf.block_rows(4) == 51


@pytest.mark.parametrize("bounds", [False, True], ids=["no_bounds", "bounds"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_launch_cost_io_bytes_are_the_wrapper_tensors(dtype, bounds):
    """(a) is the bytes of what the wrapper is given (stream, first column,
    packed weights and bias, int32 bounds) and of what it returns."""
    layers = [l.to(dtype=dtype) for l in init_abpn(torch.Generator().manual_seed(0))]
    packed = ops.pack_stack(layers, dtype=dtype)
    frame = torch.rand((1, 24, 32, 3), generator=torch.Generator().manual_seed(1)).to(dtype)
    if bounds:
        from repro_torch.core.fusion import halo_slabs

        xb, row_bounds = halo_slabs(frame, BAND_ROWS, L)
    else:
        xb, row_bounds = frame.reshape(2, BAND_ROWS, 32, 3), None
    xs, first = ops.band_streams(xb, TILE_COLS, L)
    out = ttf.tilted_fusion_call(xs, first, packed.w, packed.b, width=32, tile_cols=TILE_COLS,
                                 relu_flags=list(packed.relu), add_anchor=False, in_channels=3,
                                 row_bounds=row_bounds)
    tensors = [xs, first, packed.w, packed.b, out]
    if bounds:
        tensors.append(row_bounds.to(torch.int32))
    plan = ttf.segment_plan(xs.shape[0], xs.shape[2] // TILE_COLS, TILE_COLS, L, sms=1)
    got = ttf.launch_cost(plan, band_rows=xs.shape[1], tile_cols=TILE_COLS, c0p=xs.shape[3],
                          chp=packed.chp, num_layers=L, dtype=dtype, bounds=bounds)
    assert got["io_bytes"] == sum(t.numel() * t.element_size() for t in tensors)


def _walk_the_source(plan, R, C, c0p, chp, L, dtype, bounds, replicate, hidden=None):
    """Bytes one launch reads and writes beyond (a), walking
    ``csrc/tilted_fusion.cu`` loop by loop: the packing kernel, then per CTA
    its bounds and per (tile, step) its weight stage; then, on the on-chip
    route (``tilted_fusion_kernel_onchip``), per tile F_0's copy (pixel by
    pixel, R rows) and per layer the next layer's carried columns copied
    (zero-filled at a sweep's first tile) and its own two stored; on the
    device-memory route (``tilted_fusion_kernel``), per CTA the queue's
    start state and per step each row block's window copies (pixel by
    pixel) and the carried layers' stores.  A step is a layer, or on a
    mixed launch (``hidden`` channels in the hidden layers) one of the last
    layer's output groups of 32 (``group_width``), which on the
    device-memory route walks the row blocks again.  Each loop over a
    buffer touches each element once."""
    es = dtype.itemsize
    k = 8 if dtype == torch.float32 else 16
    hid = hidden or chp
    ks0, ks = -(-c0p // k), hid // k
    onchip = ttf.route(R, C, chp, dtype, hidden).onchip

    # bias as fp32, then the B fragments: 2 words a lane an n8 block, on the
    # device-memory route 4 in fp32 (pre-split)
    words = 4 if dtype == torch.float32 and not onchip else 2

    def stage(nout, ksteps):
        return 4 * (nout + 9 * ksteps * 32 * words * (nout // 8))

    groups = [min(32, chp - g) for g in range(0, chp, 32)] if hidden else [chp]
    steps = [(l, hid) for l in range(L - 1)] + [(L - 1, n) for n in groups]
    # what the packing reads: each layer's (K, N) block, and its bias
    weights = (L - 1) * (9 * hid * hid + hid) + 9 * hid * chp + chp
    nr = min(256 // C, 320 // (C + 2) - 2)
    total = weights * es + sum(stage(n, ks0 if l == 0 else ks) for l, n in steps)  # packing
    for _ in range(plan.bands):
        for kw, k0, k1 in plan.ranges():
            total += 8 if bounds else 0
            if onchip:
                for kt in range(kw, k1):
                    nl = L if kt >= k0 else L - 1
                    for l, nout in steps if kt >= k0 else steps[:L - 1]:
                        total += stage(nout, ks0 if l == 0 else ks)
                    for r in range(R):  # F_0: the stream's columns kC-1 .. kC+C
                        for wc in range(C + 2):
                            if kt * C - 1 + wc >= 0:
                                total += c0p * es
                    for l in range(nl):
                        if l + 1 < nl and kt != kw:  # the next layer's carried columns
                            total += R * 2 * hid * es
                        if l < L - 1:
                            total += R * 2 * hid * es  # this layer's, stored to the queue
                continue
            total += (L - 1) * R * 2 * hid * es  # one parity of the queue zeroed
            for kt in range(kw, k1):
                for l, nout in steps if kt >= k0 else steps[:L - 1]:
                    total += stage(nout, ks0 if l == 0 else ks)
                    for r0 in range(0, R, nr):
                        for wr in range(min(nr, R - r0) + 2):
                            if not 0 <= r0 - 1 + wr < R and not replicate:
                                continue  # zero-filled
                            for wc in range(C + 2):
                                if l > 0:
                                    total += hid * es  # carried columns, then the slab
                                elif kt * C - 1 + wc >= 0:
                                    total += c0p * es  # the first column or the stream
                    if l < L - 1:
                        total += R * C * hid * es + R * 2 * hid * es  # slab, queue stored
    # (a) once: stream, first column, weights, bias and bounds (the output
    # is (a) alone)
    K = plan.tiles
    total -= plan.bands * R * (K * C * c0p + c0p) * es + weights * es
    return total - (8 * plan.bands if bounds else 0)


@pytest.mark.parametrize("bounds", [False, True], ids=["no_bounds", "bounds"])
@pytest.mark.parametrize("segments", [1, 2, 3, 7])
def test_launch_cost_workspace_bytes_walk_the_kernels_loops(segments, bounds):
    plan = ttf.segment_plan(3, 7, TILE_COLS, L, sms=8, segments=segments)
    for dtype in (torch.float32, torch.bfloat16):
        # on chip but the last (a band too tall for its maps: the device-memory route)
        for R, C, replicate in ((13, TILE_COLS, False), (13, TILE_COLS, True),
                                (61, TILE_COLS, False), (9, 3, True), (90, TILE_COLS, True)):
            assert ttf.route(R, C, CHP, dtype).onchip == (R < 90)
            want = _walk_the_source(plan, R, C, C0P, CHP, L, dtype, bounds, replicate)
            got = ttf.launch_cost(plan, band_rows=R, tile_cols=C, c0p=C0P, chp=CHP,
                                  num_layers=L, dtype=dtype, bounds=bounds, replicate=replicate)
            assert got["workspace_bytes"] == want, (dtype, R, C, replicate)


@pytest.mark.parametrize("out", [48, 64, 128])
@pytest.mark.parametrize("segments", [1, 3])
def test_launch_cost_of_a_mixed_launch_walks_the_kernels_loops(segments, out):
    """A mixed launch (hidden Chp 32, ``out`` outputs in groups of 32 and
    16): part (b) as the walk of its loops finds it, and part (a) with the
    weight blocks its packing reads."""
    plan = ttf.segment_plan(3, 7, TILE_COLS, L, sms=8, segments=segments)
    for dtype in (torch.float32, torch.bfloat16):
        for R, C, replicate, bounds in ((13, TILE_COLS, False, True), (61, TILE_COLS, True, False),
                                        (9, 3, True, True), (90, TILE_COLS, False, True)):
            want = _walk_the_source(plan, R, C, C0P, out, L, dtype, bounds, replicate, hidden=32)
            got = ttf.launch_cost(plan, band_rows=R, tile_cols=C, c0p=C0P, chp=out, num_layers=L,
                                  dtype=dtype, bounds=bounds, replicate=replicate, hidden_chp=32)
            assert got["workspace_bytes"] == want, (dtype, R, C, replicate)
            stream = 3 * R * 7 * C
            weights = 6 * (9 * 32 * 32 + 32) + 9 * 32 * out + out
            assert got["io_bytes"] == dtype.itemsize * (
                stream * (C0P + out) + 3 * R * C0P + weights) + (8 * 3 if bounds else 0)


def _walk_the_wide_source(plan, R, C, c0p, chp, L, dtype, bounds, replicate):
    """Part (b) of a launch of a wide instance, walking
    ``tilted_fusion_wide_kernel`` loop by loop: the packing (the weights
    read, the slices written), then per CTA its bounds and the queue's
    start state, and per (tile, layer) step and row block the window's
    copies (pixel by pixel), every n-group's weight slices of ``taps``
    (tap, n-group) B blocks each, or of half a tap's k-steps, the bias the
    block's epilogues read, and the carried layers' stores."""
    es = dtype.itemsize
    k = 8 if dtype == torch.float32 else 16
    ks0, ks = -(-c0p // k), chp // k
    sched = ttf.wide_schedule(chp, dtype)
    words = (2 if dtype == torch.bfloat16 else 4) * sched.ng // 8  # a lane's, a k-step

    def slice_bytes(ksteps, j):  # slice j: its taps' k-steps (or piece j % 2's) x 32 lanes
        if sched.halves == 1:
            return sched.taps * ksteps * 32 * words * 4
        half = -(-ksteps // 2)
        return (min(ksteps, (j % 2 + 1) * half) - j % 2 * half) * 32 * words * 4

    weights = L * (9 * chp * chp + chp)
    packed = 9 * (chp // sched.ng) * 32 * words * 4 * (ks0 + (L - 1) * ks)
    nr = min(256 // C, 320 // (C + 2) - 2)
    total = weights * es + packed
    for _ in range(plan.bands):
        for kw, k0, k1 in plan.ranges():
            total += 8 if bounds else 0
            total += (L - 1) * R * 2 * chp * es  # one parity of the queue zeroed
            for kt in range(kw, k1):
                for l in range(L if kt >= k0 else L - 1):
                    for r0 in range(0, R, nr):
                        for _grp in range(chp // sched.ng):
                            for j in range(9 // sched.taps * sched.halves):
                                total += slice_bytes(ks0 if l == 0 else ks, j)
                        total += chp * es  # the bias
                        for wr in range(min(nr, R - r0) + 2):
                            if not 0 <= r0 - 1 + wr < R and not replicate:
                                continue  # zero-filled
                            for wc in range(C + 2):
                                if l > 0:
                                    total += chp * es
                                elif kt * C - 1 + wc >= 0:
                                    total += c0p * es
                    if l < L - 1:
                        total += R * C * chp * es + R * 2 * chp * es  # slab, queue stored
    K = plan.tiles
    total -= plan.bands * R * (K * C * c0p + c0p) * es + weights * es
    return total - (8 * plan.bands if bounds else 0)


@pytest.mark.parametrize("chp", [48, 64, 96, 128])
@pytest.mark.parametrize("segments", [1, 3])
def test_launch_cost_of_a_wide_launch_walks_the_kernels_loops(segments, chp):
    """A wide instance's part (b), as the walk of its loops finds it, for
    its own schedule (n-groups, taps or half a tap a slice)."""
    plan = ttf.segment_plan(2, 5, TILE_COLS, 4, sms=8, segments=segments)
    for dtype in (torch.float32, torch.bfloat16):
        for R, C, replicate, bounds in ((13, TILE_COLS, False, True), (61, TILE_COLS, True, False),
                                        (9, 3, True, True)):
            want = _walk_the_wide_source(plan, R, C, C0P, chp, 4, dtype, bounds, replicate)
            got = ttf.launch_cost(plan, band_rows=R, tile_cols=C, c0p=C0P, chp=chp, num_layers=4,
                                  dtype=dtype, bounds=bounds, replicate=replicate)
            assert got["workspace_bytes"] == want, (dtype, R, C, replicate)


def test_the_wrapper_on_meta_tensors_records_and_launches_nothing():
    args, kw = _meta_args(4, BAND_ROWS, 5, dtype=torch.bfloat16, bounds=True)
    before = ttf.tilted_fusion_call.launches
    with ttf.record_launches() as launches:
        out = ttf.tilted_fusion_call(*args, segments=2, **kw)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (4, BAND_ROWS, 5 * TILE_COLS, CHP)
    assert launches == [ttf.Launch(bands=4, band_rows=BAND_ROWS, tiles=5, tile_cols=TILE_COLS,
                                   c0p=C0P, chp=CHP, num_layers=L, dtype=torch.bfloat16,
                                   bounds=True, segments=2)]
    assert launches[0].out_bytes == out.numel() * out.element_size()
    ttf.tilted_fusion_call(*args, **kw)  # outside the block: nothing recorded
    assert len(launches) == 1 and ttf.tilted_fusion_call.launches == before


class _Allocations(TorchDispatchMode):
    """The largest tensor any operator makes off ``meta``."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("backend,policy", [("reference", "zero"), ("tilted", "zero"),
                                            ("tilted", "halo"), ("kernel", "zero"),
                                            ("kernel", "halo"), ("kernel", "replicate")])
def test_plan_cost_at_the_design_point_traces_meta_frames_only(backend, policy, monkeypatch):
    """360x640, batch 8: no frame buffer (nothing off ``meta`` as large as
    one LR frame) and, on the kernel backend, K1 counted once by
    ``launch_cost``, its plain tile loop never run."""
    layers = init_abpn(torch.Generator().manual_seed(0))
    plan = tengine.make_plan(layers, (360, 640, 3), backend=backend, vertical_policy=policy,
                             scale=SCALE)
    calls = []
    counted = ttf.launch_cost

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return counted(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("plan_cost must not run the plain tile loop")

    monkeypatch.setattr(ttf, "launch_cost", spy)
    monkeypatch.setattr(ttf, "tilted_fusion_plain", refuse)
    with _Allocations() as seen:
        cost = tengine.plan_cost(plan, layers, 8, device="cpu")
    assert seen.largest < 360 * 640 * 3 * 4
    assert len(calls) == (1 if backend == "kernel" else 0)
    if backend == "kernel":
        assert calls[0]["plain"] and calls[0]["band_rows"] == (74 if policy == "halo" else 60)
    assert cost["flops_per_frame"] >= 2 * 360 * 640 * sum(9 * l.ci * l.co for l in layers)
