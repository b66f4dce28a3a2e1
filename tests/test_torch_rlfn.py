"""RLFN x4 on the port, on the CPU: ``SRServer.open("rlfn_x4")`` at the
published widths (52 features, ESA 16, 6 blocks) on every backend against
the benchmark's plain reference (``bench/reference/rlfn.py``, loaded by
path: it imports neither JAX nor the port), K1's plain path with a leaky
slope and a residual against ``F.conv2d``, the ``halo`` segments against
the whole-frame stack, the epilogue without an anchor, and ABPN's dispatch
unchanged (one K1 launch, no slope, no residual).

Frames are 36 x 48 (ESA's strided conv and 7x7 pool need at least 15
rows) in 12-row bands, so that every segment's halo slabs cross bands.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import engine
from repro_torch.core.fusion import ConvLayer, conv_stack_reference, exact_fp32
from repro_torch.core.stages import Segment, StagedModel
from repro_torch.engine.executor import plan_cost_terms
from repro_torch.kernels import epilogue, ops
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.models.abpn import init_abpn
from repro_torch.models.registry import get_sr_model
from repro_torch.models.rlfn import RLFNConfig, init_rlfn, param_count, rlfn_model

REPO = Path(__file__).resolve().parents[1]
H, W, R = 36, 48, 12
# fp32 everywhere; the plain K1 sums each tap's products by matmul and the
# reference by F.conv2d, in other orders, through 21 convs and 6 ESA gates:
# a few ulps of values near 1, far below a bf16 ulp (3.9e-3)
TOL = 2e-5


def _reference():
    spec = importlib.util.spec_from_file_location("bench_reference_rlfn",
                                                  REPO / "bench" / "reference" / "rlfn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _weights(seed=5):
    """The registry's init with biases that are not zero and an upsampler
    that keeps the HR frame inside [0, 1] (few values clip)."""
    gen = torch.Generator().manual_seed(seed)
    sd = init_rlfn(gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.05
    sd["upsampler.0.weight"] *= 0.3
    sd["upsampler.0.bias"] += 0.5
    return sd


def _frames(n=3, seed=6):
    return torch.rand((n, H, W, 3), generator=torch.Generator().manual_seed(seed))


def test_rlfn_registered_at_the_published_widths():
    spec = get_sr_model("rlfn_x4")
    cfg = spec.config
    assert (cfg.feature_channels, cfg.esa_channels, cfg.num_blocks, cfg.slope, cfg.scale) == \
        (52, 16, 6, 0.05, 4)
    assert param_count(cfg) == 543_740 and get_sr_model("rlfn") is spec
    model = spec.init(torch.Generator().manual_seed(0))
    assert isinstance(model, StagedModel) and not model.anchor
    kinds = ["k1" if isinstance(st, Segment) else st.name for st in model.stages]
    assert kinds == ["k1"] + ["k1", "esa"] * 6 + ["k1", "k1"]
    assert [st.residual for st in model.stages if isinstance(st, Segment)] == \
        [None, 1, 3, 5, 7, 9, 11, 1, None]
    assert model.max_depth == 3
    assert list(_reference().param_shapes()) == list(init_rlfn(0))


@pytest.mark.parametrize("backend", ["reference", "tilted", "kernel"])
def test_served_rlfn_matches_the_reference(backend):
    """Two requests, the second split by a carry (``max_bucket=2``: frame 0
    and frame 1 share a dispatch, frame 2 follows), ``halo`` at 12-row
    bands, fp32, against the reference over whole frames."""
    ref = _reference()
    sd, lr = _weights(), _frames()
    server = engine.SRServer.open("rlfn_x4", layers=rlfn_model(sd, RLFNConfig()),
                                  backend=backend, vertical_policy="halo", band_rows=R,
                                  max_bucket=2, device="cpu", autotune="off")
    a, b = server.submit(lr[:1].numpy()), server.submit(lr[1:].numpy())
    got = torch.cat([a.result(), b.result()])
    session = server.session()
    stats = session.stats()
    plan = session.plan_for((H, W, 3))
    server.close()
    with ref.exact():
        want = ref.rlfn(lr, sd, 4)
    assert got.shape == (3, 4 * H, 4 * W, 3)
    assert (got - want).abs().max().item() <= TOL
    assert plan.num_layers == 3 and not session.staged.anchor
    assert stats["esa_frames"] == 3 and stats["k1_frames"] == 3 and stats["esa_device_ms"] > 0
    assert stats["k1_segments"] == 9  # conv_1, six blocks, conv_2, the upsampler


def _dispatched_batches(monkeypatch, model, **kw):
    """The batch sizes the single-device executor is given while a server
    of ``model`` serves three frames at ``max_bucket=4`` (one dispatch of
    bucket 4), the HR frames and the scheduler's counters."""
    seen = []
    execute = engine.executor._execute_stack

    def spy(plan, stack, frames):
        seen.append(frames.shape[0])
        return execute(plan, stack, frames)

    monkeypatch.setattr(engine.executor, "_execute_stack", spy)
    server = engine.SRServer.open(model, max_bucket=4, device="cpu", autotune="off", **kw)
    hr = server.submit(_frames().numpy()).result()
    stats = server.scheduler_stats()
    server.close()
    return seen, hr, stats


def test_a_staged_dispatch_computes_its_real_frames_alone(monkeypatch):
    """Three frames form a dispatch of bucket 4: RLFN's executor is given
    the three, not the bucket zero padded."""
    seen, hr, stats = _dispatched_batches(monkeypatch, "rlfn_x4", backend="tilted",
                                          vertical_policy="halo", band_rows=R)
    assert hr.shape[0] == 3 and seen[-1] == 3 and 4 in seen  # the warm-up ran the bucket
    assert stats["slots_dispatched"] == 4 and stats["frames_dispatched"] == 3


def test_a_chain_dispatch_computes_its_real_frames_alone(monkeypatch):
    """The same for ABPN: the single-device executor takes any batch, so
    whether a dispatch is padded does not depend on the model."""
    layers = init_abpn(torch.Generator().manual_seed(0))
    seen, hr, stats = _dispatched_batches(monkeypatch, "abpn_x3", layers=layers,
                                          backend="kernel", band_rows=R)
    assert hr.shape == (3, 3 * H, 3 * W, 3) and seen[-1] == 3 and 4 in seen
    assert stats["slots_dispatched"] == 4 and stats["frames_dispatched"] == 3


def _convs(seed, channels):
    gen = torch.Generator().manual_seed(seed)
    return [ConvLayer(w=torch.randn((3, 3, a, b), generator=gen) * (2 / (9 * a)) ** 0.5,
                      b=torch.randn((b,), generator=gen) * 0.1, relu=True, slope=0.05)
            for a, b in zip(channels, channels[1:])]


def _conv_chain(x, layers, residual=None):
    """The layers as F.conv2d with zero padding over whole NHWC frames, the
    residual added after the last activation."""
    with exact_fp32():
        h = x.permute(0, 3, 1, 2)
        for l in layers:
            h = F.conv2d(h, l.w.permute(3, 2, 0, 1), l.b, padding=1)
            if l.relu:
                h = F.leaky_relu(h, l.slope)
    h = h.permute(0, 2, 3, 1)
    return h if residual is None else h + residual


def test_k1_plain_slope_and_residual_match_conv2d():
    """K1's plain path (a CPU tensor) on one 36-row band: 3 layers 20 -> 20,
    slope 0.05 on each, a residual added after the last, against F.conv2d."""
    layers = _convs(7, [20, 20, 20, 20])
    gen = torch.Generator().manual_seed(8)
    x, res = torch.rand((2, H, W, 20), generator=gen), torch.rand((2, H, W, 20), generator=gen)
    got = ops.tilted_fused_frames(x, layers, band_rows=H, residual=res)
    assert (got - _conv_chain(x, layers, res)).abs().max().item() <= TOL
    without = ops.tilted_fused_frames(x, layers, band_rows=H)
    assert (without - _conv_chain(x, layers)).abs().max().item() <= TOL


@pytest.mark.parametrize("path", ["k1_plain", "tilted"])
def test_halo_segments_equal_the_whole_frame_stack(path):
    """A segment under ``halo`` at 12-row bands (each band's slab carries a
    3-row margin, the residual added on its own rows) equals the same
    segment over whole frames."""
    layers = _convs(9, [20, 20, 20, 20])
    gen = torch.Generator().manual_seed(10)
    x, res = torch.rand((2, H, W, 20), generator=gen), torch.rand((2, H, W, 20), generator=gen)
    want = conv_stack_reference(x, layers) + res
    if path == "k1_plain":
        got = ops.tilted_fused_frames(x, layers, band_rows=R, vertical_policy="halo",
                                      residual=res)
    else:
        plan = engine.SRPlan(height=H, width=W, num_layers=3, band_rows=R,
                             vertical_policy="halo", backend="tilted")
        got = engine.executor._features_tilted(plan, layers, x) + res
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_epilogue_without_anchor_is_a_shuffle_and_a_clamp(dtype):
    """``anchor=False`` reads no LR input: the features pixel-shuffled
    (PyTorch's channel order), clamped to [0, 1] and cast."""
    feats = (torch.rand((2, 5, 7, 64), generator=torch.Generator().manual_seed(11)) * 1.4
             - 0.2).to(dtype)[..., :48]
    got = epilogue.sr_epilogue_call(feats, None, scale=4, clip=True, out_dtype=torch.float32,
                                    anchor=False)
    want = F.pixel_shuffle(feats.permute(0, 3, 1, 2), 4).clamp(0, 1).permute(0, 2, 3, 1)
    assert torch.equal(got, want.float())
    with pytest.raises(ValueError, match="must be \\(N, H, W, C\\)"):
        epilogue.sr_epilogue_call(feats, None, scale=4, clip=True, out_dtype=torch.float32)


def _launches(plan, model, batch=2):
    """K1's launches in one dispatch, recorded on ``meta`` frames."""
    stack = engine.executor._stack_on(engine.prepare_stack(plan, model), "meta")
    frames = torch.empty((batch, *plan.lr_shape), device="meta")
    with ttf.record_launches() as launches:
        engine.executor._execute_stack(plan, stack, frames)
    return launches


def test_abpn_dispatch_launches_one_plain_k1_and_rlfn_nine():
    """What one dispatch launches, recorded on ``meta`` frames: ABPN's one
    K1 launch of its whole stack, with no residual and no slope, as before
    there were staged models; RLFN's nine (conv_1, six blocks, conv_2, the
    upsampler), the block segments and conv_2 with their residuals."""
    layers = init_abpn(torch.Generator().manual_seed(0))
    plan = engine.make_plan(layers, (60, 64, 3), backend="kernel", band_rows=30)
    launches = _launches(plan, layers)
    assert len(launches) == 1 and launches[0].num_layers == 7
    assert launches[0].bands == 4 and launches[0].residual_elems == 0
    assert len(plan_cost_terms(plan, layers, 2, device="cpu")["k1"]) == 1
    assert ops.pack_stack(layers).slopes is None
    server = engine.SRServer.open("abpn_x3", layers=layers, backend="kernel", band_rows=30,
                                  device="cpu", autotune="off")
    server.submit(np.zeros((1, 60, 64, 3), np.float32)).result()
    stats = server.session().stats()
    server.close()
    assert stats["k1_segments"] == 1 and stats["esa_frames"] == 0
    session = engine.SRSession(get_sr_model("rlfn_x4").init(torch.Generator().manual_seed(0)),
                               backend="kernel", vertical_policy="halo", band_rows=R,
                               scale=4, device="cpu", autotune="off")
    launches = _launches(session.plan_for((H, W, 3)), session.staged)
    assert [l.num_layers for l in launches] == [1] + [3] * 6 + [1, 1]
    assert [l.residual_elems for l in launches] == [0] + [R * W * 52] * 7 + [0]
    assert all(l.bounds and l.band_rows == R + 2 * l.num_layers for l in launches)


def test_staged_model_refuses_what_it_cannot_serve():
    model = get_sr_model("rlfn_x4").init(torch.Generator().manual_seed(0))
    session = engine.SRSession(model, backend="tilted", vertical_policy="halo", band_rows=R,
                               scale=4, device="cpu", autotune="off")
    plan = session.plan_for((H, W, 3))
    with pytest.raises(ValueError, match="partial-band serving takes a ConvLayer chain"):
        session.band_executor_for(plan, 1, torch.float32)
    with pytest.raises(ValueError, match="not on a mesh"):
        engine.SRSession(model, mesh=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="residual reads value"):
        StagedModel((Segment(model.stages[0].layers, residual=3),))
    with pytest.raises(ValueError, match="int8 serves a ConvLayer chain"):
        engine.prepare_stack(dataclasses.replace(plan, precision="int8"), model)
    assert np.isclose(RLFNConfig().slope, 0.05)


def _chain_before(x, stage):
    """ESA as ``ESAStage`` computed it before the kernels: the PyTorch chain
    on the NCHW view, in the frames' dtype (fp32 with TF32 off)."""
    dt = x.dtype

    def conv(t, wb, **kw):
        return F.conv2d(t, wb[0].to(dt), wb[1].to(dt), **kw)

    with exact_fp32():
        h = x.permute(0, 3, 1, 2)
        u = conv(h, stage.c5)
        c1_ = conv(u, stage.conv1)
        c3 = conv(F.max_pool2d(conv(c1_, stage.conv2, stride=2), kernel_size=7, stride=3),
                  stage.conv3, padding=1)
        c3 = F.interpolate(c3, size=u.shape[2:], mode="bilinear", align_corners=False)
        c3 += conv(c1_, stage.conv_f)
        del c1_
        m = torch.sigmoid_(conv(c3, stage.conv4))
        return u.mul_(m).permute(0, 2, 3, 1).contiguous()


def _esa_stage(dtype=torch.float32):
    return rlfn_model(_weights(), RLFNConfig()).stages[2].to(dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_esa_stage_on_the_cpu_is_the_chain_it_was(dtype, monkeypatch):
    """Off the card ``ESAStage`` runs ``esa_plain``, ``torch.equal`` to the
    chain it ran before the kernels, and launches nothing."""
    from repro_torch.kernels import esa

    stage = _esa_stage(dtype)
    x = (torch.randn((2, H, W, 52), generator=torch.Generator().manual_seed(12)) * 0.5).to(dtype)
    calls = []
    plain = esa.esa_plain
    monkeypatch.setattr(esa, "esa_plain", lambda *a: calls.append(1) or plain(*a))
    launches = esa.esa_call.launches
    got = stage(x)
    assert calls == [1] and esa.esa_call.launches == launches
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, _chain_before(x, stage))
    # a strided view of the frames gives the same bits
    wide = torch.cat([x, x[..., :12]], -1)[..., :52]
    assert torch.equal(stage(wide), got)


def test_esa_stage_on_meta_runs_the_plain_chain():
    """On ``meta`` (``plan_cost``'s trace) the stage runs the plain chain's
    operators and keeps the frames' shape; the wrapper still checks what it
    is given."""
    from repro_torch.kernels import esa
    from repro_torch.roofline.trace_cost import trace_cost

    stage = _esa_stage().to(device="meta")
    x = torch.empty((2, H, W, 52), device="meta")
    got = stage(x)
    assert got.device.type == "meta" and got.shape == x.shape
    now, before = trace_cost(stage, x), trace_cost(_chain_before, x, stage)
    assert dataclasses.replace(now, result=None) == dataclasses.replace(before, result=None)
    assert now.flops_by_op and now.op_count == before.op_count > 10
    with pytest.raises(ValueError, match=r"\(N, H, W, C\) frames"):
        esa.esa_call(x[0], stage.c5, stage.conv1, stage.conv_f, stage.conv2, stage.conv3,
                     stage.conv4)


def test_served_rlfn_counts_no_esa_launches_off_the_card():
    """``esa_launches`` is 0 on the CPU, where ESA is the plain chain, and
    ``esa_call.launches`` does not move."""
    from repro_torch.kernels import esa

    launches = esa.esa_call.launches
    server = engine.SRServer.open("rlfn_x4", layers=rlfn_model(_weights(), RLFNConfig()),
                                  backend="kernel", vertical_policy="halo", band_rows=R,
                                  device="cpu", autotune="off")
    server.submit(_frames(2).numpy()).result()
    stats = server.session().stats()
    server.close()
    assert stats["esa_launches"] == 0 and stats["esa_frames"] == 2
    assert esa.esa_call.launches == launches


# engine.plan_cost of rlfn_x4 (the _weights() model, 36 x 48, halo at 12 rows,
# the tilted backend) on two frames before the ESA kernels
PLAN_COST_BEFORE = {
    "fp32": {"batch": 2, "flops": 5902060032, "hbm_bytes": 552407628,
             "flops_per_frame": 2951030016, "hbm_bytes_per_frame": 276203814,
             "weight_bytes_resident": 2174960},
    "bf16": {"batch": 2, "flops": 5902060032, "hbm_bytes": 500171484,
             "flops_per_frame": 2951030016, "hbm_bytes_per_frame": 250085742,
             "weight_bytes_resident": 1087480},
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plan_cost_of_rlfn_is_unchanged(precision, monkeypatch):
    """``engine.plan_cost`` of ``rlfn_x4`` (a meta trace of the executor,
    ESA on its plain chain) counts what it counted before the kernels, and
    what it counts with the stage replaced by that chain."""
    from repro_torch.models import rlfn

    session = engine.SRSession(rlfn_model(_weights(), RLFNConfig()), backend="tilted",
                               vertical_policy="halo", band_rows=R, scale=4, device="cpu",
                               autotune="off", precision=precision)
    plan = session.plan_for((H, W, 3))
    now = engine.plan_cost(plan, session.staged, 2, device="cpu")
    assert now == PLAN_COST_BEFORE[precision]
    monkeypatch.setattr(rlfn, "esa_call", lambda x, *pairs, clock=None: _chain_before(
        x, rlfn.ESAStage(*pairs)))
    assert engine.plan_cost(plan, session.staged, 2, device="cpu") == now
