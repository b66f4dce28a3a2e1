"""Column segments of K1 (tilted fusion): the segment plan, and the plain
version swept segment by segment as the kernel's CTAs sweep a band.

A segment restarted at tile ``k0`` re-runs ``w = ceil((2L-1)/C)`` warm-up
tiles from the true F_0 columns and zeroed deeper queue slots, so the output
must be bit-identical (``torch.equal``) for every segment count: no
tolerance.  One case shows that ``w - 1`` warm-up tiles are too few, so the
comparison can see a contaminated column.  The JAX package's Pallas kernel
(interpret mode) is the reference for one segmented sweep, at the 5e-4 /
5e-2 max abs diff of ``tests/test_torch_kernels.py`` (fp32 sums in another
order; bf16 feature maps rounded per layer).

``tests/test_torch_cuda.py`` holds the CUDA kernel's segments against each
other on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tilted_fusion as jtf

from repro_torch.kernels import ops as tops
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.models.abpn import layers_from_numpy

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised only without hypothesis
    from _hypothesis_compat import given, settings, strategies as st

torch.set_num_threads(2)

TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"fp32": 5e-4, "bf16": 5e-2}


def _stack(seed, num_layers, precision="fp32"):
    channels = [3] + [12] * num_layers
    rng = np.random.default_rng(seed)
    return layers_from_numpy([
        ((rng.normal(size=(3, 3, channels[i], channels[i + 1])) * 0.2).astype(np.float32),
         (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
         i < num_layers - 1)
        for i in range(num_layers)
    ], dtype=TDT[precision])


def _inputs(seed, *, num_layers, tile_cols, width, policy, precision, bands=2, rows=6):
    """Raw K1 arguments for a small band batch, made with numpy."""
    dt = TDT[precision]
    packed = tops.pack_stack(_stack(seed, num_layers, precision), dtype=dt)
    rng = np.random.default_rng(seed + 1)
    xb = torch.from_numpy(rng.uniform(size=(bands, rows, width, 3)).astype(np.float32)).to(dt)
    xs, first = tops.band_streams(xb, tile_cols, num_layers)
    bounds = None
    if policy == "halo_bounds":
        bounds = torch.tensor([[1, rows - 2], [0, rows]][:bands], dtype=torch.int32)
    kw = dict(width=width, tile_cols=tile_cols, relu_flags=list(packed.relu), add_anchor=True,
              in_channels=3, anchor_repeats=4,
              row_policy="replicate" if policy == "replicate" else "zero", row_bounds=bounds)
    return xs, first, packed, kw


# ----------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("L,C", [(7, 8), (7, 4), (3, 2), (7, 2), (4, 3), (7, 16), (1, 2)])
def test_warmup_tiles_formula(L, C):
    assert ttf.warmup_tiles(L, C) == math.ceil((2 * L - 1) / C)


@pytest.mark.parametrize("K,S,w", [(81, 41, 2), (81, 5, 2), (10, 3, 4), (7, 7, 2), (5, 1, 3),
                                   (9, 4, 0)])
def test_segment_ranges_partition_the_tiles(K, S, w):
    ranges = ttf.SegmentPlan(bands=1, tiles=K, segments=S, warmup=w, cost=0.0).ranges()
    assert len(ranges) == S
    own = [k for _, k0, k1 in ranges for k in range(k0, k1)]
    assert own == list(range(K))  # every tile in exactly one segment, in order
    for kw, k0, k1 in ranges:
        assert k1 > k0
        assert kw == (k0 - w if k0 >= w else 0)  # no warm-up before tile 0
    assert max(k1 - k0 for _, k0, k1 in ranges) - min(k1 - k0 for _, k0, k1 in ranges) <= 1


def _executed(plan):
    return sum(k1 - kw for kw, _, k1 in plan.ranges())


def test_segment_plan_one_segment_and_more_than_k():
    one = ttf.segment_plan(6, 81, 8, 7, sms=132, ctas_per_sm=2, segments=1)
    assert (one.segments, one.ctas, _executed(one)) == (1, 6, 81)
    assert one.cost == 81  # 6 CTAs, each alone on its SM
    many = ttf.segment_plan(6, 81, 8, 7, sms=132, ctas_per_sm=2, segments=500)
    assert (many.segments, many.ctas) == (81, 486)
    # tiles 0 and 1 start the band; every later tile re-runs w = 2 tiles
    assert _executed(many) == 1 + 2 + 79 * 3
    # 486 CTAs on 264 slots: two waves of 3 tiles, two CTAs to an SM
    assert many.cost == pytest.approx(2 * 3 * ttf.SHARED_SM_TILE_COST)


def test_segment_plan_design_point():
    # one 360x640 frame: 6 bands of 81 tiles on 132 SMs, one CTA of the fp32
    # instance fits on each.  21 segments of at most 4 own + 2 warm-up tiles
    # leave every CTA an SM of its own; 41 segments would take two waves.
    plan = ttf.segment_plan(6, 81, 8, 7, sms=132, ctas_per_sm=1)
    assert plan.warmup == 2 and plan.ctas >= 100 and plan.ctas <= 132
    assert (plan.segments, plan.cost) == (21, 6.0)
    # eight frames: 48 bands; 5 segments of at most 17 + 2 tiles in two
    # waves of 132 CTAs beat one wave of 2 segments (41 + 2 tiles)
    eight = ttf.segment_plan(48, 81, 8, 7, sms=132, ctas_per_sm=1)
    assert (eight.segments, eight.cost) == (5, 38.0)


def test_segment_plan_design_point_two_ctas_per_sm():
    # the bf16 instance fits two CTAs on an SM: at one frame 41 segments of
    # at most 2 + 2 tiles, two CTAs on most SMs, beat 21 of 4 + 2 alone,
    # since a CTA that shares its SM is less than twice as slow
    plan = ttf.segment_plan(6, 81, 8, 7, sms=132, ctas_per_sm=2)
    assert plan.ctas == 246 <= 264
    assert (plan.segments, plan.cost) == (41, pytest.approx(4 * ttf.SHARED_SM_TILE_COST))
    assert 1.0 < ttf.SHARED_SM_TILE_COST < 1.5
    # eight frames: 5 segments fill 240 of the 264 slots in one wave
    eight = ttf.segment_plan(48, 81, 8, 7, sms=132, ctas_per_sm=2)
    assert (eight.segments, eight.cost) == (5, pytest.approx(19 * ttf.SHARED_SM_TILE_COST))


def _costs(B, K, C, L, sms, per_sm):
    return {s: ttf.segment_plan(B, K, C, L, sms, per_sm, segments=s).cost
            for s in range(1, K + 1)}


@settings(max_examples=60)
@given(B=st.integers(1, 64), K=st.integers(1, 90), sms=st.integers(1, 200),
       per_sm=st.integers(1, 3), C=st.sampled_from([2, 4, 8]), L=st.sampled_from([3, 7]))
def test_segment_plan_fills_the_card_where_that_pays(B, K, C, L, sms, per_sm):
    auto = ttf.segment_plan(B, K, C, L, sms, per_sm)
    costs = _costs(B, K, C, L, sms, per_sm)
    best = min(costs.values())
    assert auto.cost == best
    assert auto.segments == min(s for s, m in costs.items() if m == best)  # ties: fewer
    # If filling min(slots, B*K) CTAs beats every plan with fewer CTAs, the
    # automatic plan fills at least that many.
    fill = min(sms * per_sm, B * K)
    s_fill = -(-fill // B)
    if all(costs[s_fill] < m for s, m in costs.items() if B * s < fill):
        assert auto.ctas >= fill


@pytest.mark.parametrize("bad", [0, -1, 1.5, True, "2"])
def test_segments_must_be_a_positive_integer(bad):
    xs, first, packed, kw = _inputs(3, num_layers=3, tile_cols=4, width=9, policy="zero",
                                    precision="fp32")
    with pytest.raises(ValueError, match="segments"):
        ttf.tilted_fusion_call(xs, first, packed.w, packed.b, segments=bad, **kw)
    with pytest.raises(ValueError, match="segments"):
        ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, segments=bad, **kw)
    with pytest.raises(ValueError, match="segments"):
        ttf.segment_plan(2, 5, 4, 3, sms=8, segments=bad)


def test_launch_plan_on_the_cpu_is_one_segment():
    xs, first, packed, kw = _inputs(4, num_layers=3, tile_cols=4, width=30, policy="zero",
                                    precision="fp32")
    plan = ttf.launch_plan(xs, packed.w, tile_cols=4)
    assert plan.segments == 1 and plan.ctas == xs.shape[0]
    assert ttf.launch_plan(xs, packed.w, tile_cols=4, segments=3).segments == 3


# ----------------------------------------------------------------------
# The plain version, segment by segment
# ----------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "replicate", "halo_bounds"])
@pytest.mark.parametrize("L", [3, 7])
@pytest.mark.parametrize("C,width", [(2, 13), (4, 21), (8, 29)])
def test_plain_segments_are_bit_identical(C, width, L, policy, precision):
    assert width % C  # the last tile is ragged
    xs, first, packed, kw = _inputs(5, num_layers=L, tile_cols=C, width=width, policy=policy,
                                    precision=precision)
    K = xs.shape[2] // C
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, segments=1, **kw)
    assert torch.equal(ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw), want)
    for n in range(2, K + 1):
        got = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, segments=n, **kw)
        assert torch.equal(got, want), f"segments={n} of K={K}"


def test_plain_segments_through_the_wrapper_on_the_cpu():
    xs, first, packed, kw = _inputs(6, num_layers=7, tile_cols=8, width=45, policy="zero",
                                    precision="fp32")
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, **kw)
    launches = ttf.tilted_fusion_call.launches
    got = ttf.tilted_fusion_call(xs, first, packed.w, packed.b, segments=3, **kw)
    assert ttf.tilted_fusion_call.launches == launches  # the CPU runs the plain version
    assert torch.equal(got, want)


def test_one_warmup_tile_too_few_is_seen(monkeypatch):
    """L = 7, C = 8: w = 2.  With one warm-up tile a restarted segment
    starts from wrong carried columns that reach its output."""
    xs, first, packed, kw = _inputs(7, num_layers=7, tile_cols=8, width=45, policy="zero",
                                    precision="fp32")
    K = xs.shape[2] // 8
    want = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, segments=1, **kw)
    w = ttf.warmup_tiles(7, 8)
    assert w == 2
    monkeypatch.setattr(ttf, "warmup_tiles", lambda L, C: w - 1)
    for n in range(2, K + 1):
        got = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, segments=n, **kw)
        assert not torch.equal(got, want), f"segments={n}: w - 1 warm-up tiles went unseen"


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_segmented_plain_matches_pallas_kernel(precision):
    L, C, width = 3, 4, 22
    xs, first, packed, kw = _inputs(8, num_layers=L, tile_cols=C, width=width,
                                    policy="halo_bounds", precision=precision)
    bounds = kw.pop("row_bounds")
    jd = JDT[precision]
    j = jtf.tilted_fusion_call(
        *(jnp.asarray(t.float().numpy(), jd) for t in (xs, first, packed.w, packed.b)),
        row_bounds=jnp.asarray(bounds.numpy()), interpret=True, **kw)
    t = ttf.tilted_fusion_plain(xs, first, packed.w, packed.b, row_bounds=bounds, segments=3,
                                **kw)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[precision], rtol=0)
