"""RLFN's family (``families/rlfn.py``), on the CPU: its weights are the
seed's, its work counts are the published model's at 360x640, the fp8
control is not correct where the program is, and the three readers this
configuration adds read a run of the cell."""

import time

import pytest
import torch

from harness import cell, check, inputs, registry

SEED = 2 ** 31 + 77
CELL = "x4_bf16_rlfn_vod"


def _config() -> dict:
    b = registry.load_benchmark()
    return registry.config(b, registry.workload(b, CELL)["config"])


def _small(cfg: dict) -> dict:
    cfg = dict(cfg, lr_height=36, lr_width=48)
    cfg["serving"] = dict(cfg["serving"], band_rows=12, max_bucket=4)
    return cfg


def test_rlfn_weights_are_the_seeds():
    cfg = _config()
    family = registry.family(cfg)
    a, b = (family.make_weights(cfg, SEED, "cpu") for _ in range(2))
    other = family.make_weights(cfg, SEED + 1, "cpu")
    assert list(a) == list(family.ref.param_shapes())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_1.weight"], other["conv_1.weight"])
    assert sum(t.numel() for t in a.values()) == 543_740  # the paper's 543.7 K


def test_rlfn_work_counts_are_the_published_models():
    cfg = _config()
    family = registry.family(cfg)
    assert family.flops_per_frame(cfg) == 238_596_461_568
    assert family.k1_work(cfg, "bf16") == (224_064_921_600, 360 * 640 * 935 * 2)
    assert family.esa_work(cfg, "bf16") == (14_531_539_968, 360 * 640 * 104 * 6 * 2)


def test_rlfn_fp8_control_is_not_correct_where_bf16_is():
    """On a 36x48 frame of the seed: the reference in fp8 misses the cell's
    limit, the port served in bf16 (the ``reference`` backend: cuDNN's
    arithmetic, the served roundings) meets it."""
    cfg = _small(_config())
    family = registry.family(cfg)
    weights = family.make_weights(cfg, SEED, "cpu")
    lr = torch.from_numpy(inputs.make_pool(cfg, 2, SEED))
    limit = float(cfg["limits"]["max_abs_err"])
    with family.exact():
        want = family.reference(lr, weights, cfg)
        fp8 = family.reference(lr, weights, cfg, "fp8")
    server = family.open_server(cfg, weights, "cpu", backend="reference")
    got = server.submit(lr.numpy()).result()
    server.close()
    assert (fp8 - want).abs().max().item() > limit
    assert (got - want).abs().max().item() < limit


@pytest.fixture(scope="module")
def traced_run():
    b = registry.load_benchmark()
    wl = registry.workload(b, CELL)
    cfg = _small(registry.config(b, wl["config"]))
    tr = registry.traffic(wl["traffic"])
    tr.update(pool_frames=12, warm_seconds=0.2, warm_max_bucket=4, sample_requests=2,
              sample_frames=2, clients=2, frames_per_request=3)
    record, checks, _ = cell.run(wl, cfg, tr, SEED, 0.5, True, "cpu", time.time(),
                                 backend="tilted")
    return record, checks


def test_rlfn_cell_runs_and_its_readers_read(traced_run):
    record, checks = traced_run
    assert check.correct(checks), checks
    frames = record.sched["frames_dispatched"]
    assert frames > 0 and record.session["esa_frames"] > 0
    esa_ms = registry.reader("esa_ms_per_frame.rlfn_vod")(record)
    assert esa_ms == pytest.approx(record.session["esa_device_ms"]
                                   / record.session["esa_frames"])
    flops, nbytes = record.family.esa_work(record.config, "bf16")
    least = max(flops / record.peak_flops, nbytes / 3.35e12) * frames
    assert registry.reader("esa_roofline.rlfn_vod")(record) == pytest.approx(
        100 * least / (record.session["esa_device_ms"] / 1e3))
    # the CPU's trace has no device kernels: K1's share finds nothing there
    # and reads the family's work on a synthetic device time
    seg = registry.reader("k1_seg_roofline.rlfn_vod")
    assert seg(record) is None

    class _Trace:
        def device_seconds(self, pred):
            return 2.0

    flops, nbytes = record.family.k1_work(record.config, "bf16")
    record.trace, saved = _Trace(), record.trace
    try:
        assert seg(record) == pytest.approx(
            100 * max(flops / record.peak_flops, nbytes / 3.35e12) * frames / 2.0)
    finally:
        record.trace = saved


def test_rlfn_readers_find_nothing_in_an_abpn_run(traced_run):
    """A run whose program has no whole-frame stage and whose family counts
    no K1 segment work (the parent's, or ABPN's) leaves the metrics out."""
    record, _ = traced_run

    class _Run:
        session = {"esa_device_ms": 0.0, "esa_frames": 0}
        sched = record.sched
        family = object()
        trace = record.trace

    for name in ("esa_ms_per_frame.rlfn_vod", "esa_roofline.rlfn_vod",
                 "k1_seg_roofline.rlfn_vod"):
        assert registry.reader(name)(_Run()) is None
    _Run.session = {}
    assert registry.reader("esa_ms_per_frame.rlfn_vod")(_Run()) is None
