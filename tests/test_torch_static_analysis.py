"""The port's static-analysis subsystem (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``): twins of ``tests/test_static_analysis.py``
and of the shard checks of ``tests/test_sharding.py``.

* ``verify_plan`` gives the same ``(rule, severity)`` findings as the JAX
  package on the same plan, with one documented divergence: the
  ``on_chip_budget`` rule reads the Hopper kernels' own accounting.  The
  JAX package makes a past-budget ``band_rows`` an error on the ``kernel``
  backend because its Pallas kernel's VMEM scratch grows with R; on the
  card K1's shared memory does not depend on R (two fp32 stages of one
  layer's weights), so the port's error fires when a kernel's shared
  memory does not fit an H100 CTA or SM, and the Table II budget is an
  advisory warning on both banded backends (checked by the tests named
  ``*budget*`` and ``*shared_memory*`` below).
* The concurrency lint gives the same findings as the JAX package's on the
  same snippets, and flags torch's blocking calls too.
* The program audit is clean on real CPU sessions and catches a seeded
  ``aten.round``, ``.item()``, host-to-device copy, bf16 upcast, build,
  ignored donation and rebuild.

Everything is exact (findings are compared as lists or sets); no tensor
tolerance is involved.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.analysis import concurrency_lint as jlint
from repro.analysis import plan_check as jcheck
from repro.engine import plan as jplan
from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.analysis import (
    PlanVerificationError,
    concurrency_lint,
    plan_check,
    program_audit,
    sweep,
)
from repro_torch.analysis.findings import Finding, count_by_severity, errors
from repro_torch.core import analysis as core_analysis
from repro_torch.core.fusion import halo_slabs
from repro_torch.engine import executor
from repro_torch.engine.plan import BACKENDS, PRECISIONS, VERTICAL_POLICIES, SRPlan
from repro_torch.kernels import _build
from repro_torch.kernels import tilted_fusion as ttf
from repro_torch.kernels.tilted_fusion import kernel_buffers, round_up_channels
from repro_torch.models.abpn import layers_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


LAYERS = layers_from_numpy(init_abpn(jax.random.PRNGKey(2), ABPNConfig()))
LR = (12, 16, 3)


def rules(findings):
    return [f.rule for f in findings]


def pairs(findings):
    return sorted((f.rule, f.severity) for f in findings)


def as_jax(plan):
    return jplan.SRPlan(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})


def session(**kw):
    kw.setdefault("autotune", "off")
    return engine.SRSession(LAYERS, device="cpu", **kw)


# ----------------------------------------------------------------------
# verify_plan against the JAX package
# ----------------------------------------------------------------------
GRID = [(b, v, p) for b in BACKENDS for v in VERTICAL_POLICIES for p in PRECISIONS]


@pytest.mark.parametrize("backend,policy,precision", GRID)
def test_design_point_grid_matches_the_jax_package(backend, policy, precision):
    """Every plan of ``sweep_plans()``: the same findings (none) as the JAX
    package's ``verify_plan``."""
    plan = SRPlan.from_request(sweep.PLAN_SWEEP_SHAPE, num_layers=7, backend=backend,
                               vertical_policy=policy, precision=precision)
    assert pairs(plan_check.verify_plan(plan)) == pairs(jcheck.verify_plan(as_jax(plan)))


@pytest.mark.parametrize("band_rows", [12, 24, 40, 45, 72, 90, 120, 180, 360])
@pytest.mark.parametrize("backend", ["tilted", "kernel", "reference"])
def test_other_geometries_match_but_for_the_budget_rule(backend, band_rows):
    """Away from the design point every rule but ``on_chip_budget`` agrees
    with the JAX package; that rule is the documented divergence."""
    plan = SRPlan(height=360, width=64, band_rows=band_rows, backend=backend,
                  vertical_policy="halo")
    mine = [p for p in pairs(plan_check.verify_plan(plan)) if p[0] != "on_chip_budget"]
    theirs = [p for p in pairs(jcheck.verify_plan(as_jax(plan))) if p[0] != "on_chip_budget"]
    assert mine == theirs
    # on the port the budget rule is never an error at ABPN's widths
    assert errors(plan_check.verify_plan(plan)) == []


def test_sweep_plans_is_clean():
    assert sweep.sweep_plans() == []


def test_plan_verify_method_clean():
    assert SRPlan(height=360, width=640).verify() == []
    assert SRPlan(height=360, width=640, backend="kernel").verify() == []


def test_band_coverage_violation_is_caught():
    bad = dataclasses.replace(SRPlan(height=360, width=64))
    object.__setattr__(bad, "height", 100)  # 100 % 60 != 0
    assert "band_coverage" in rules(errors(plan_check.verify_plan(bad)))
    jbad = dataclasses.replace(jplan.SRPlan(height=360, width=64))
    object.__setattr__(jbad, "height", 100)
    assert pairs(plan_check.verify_plan(bad)) == pairs(jcheck.verify_plan(jbad))


def test_halo_margin_measured_from_geometry():
    for R, L in ((60, 7), (24, 7), (8, 3)):
        assert plan_check.measured_halo_margin(R, L) == jcheck.measured_halo_margin(R, L) == L
        assert plan_check.required_halo_margin(L) == jcheck.required_halo_margin(L) == L


def test_insufficient_halo_is_caught():
    plan = SRPlan(height=360, width=64, vertical_policy="halo")
    assert plan.verify() == []
    findings = plan.verify(halo_margin=plan.num_layers - 1)
    assert rules(errors(findings)) == ["halo_sufficiency"]
    assert pairs(findings) == pairs(as_jax(plan).verify(halo_margin=plan.num_layers - 1))


def test_degenerate_plan_findings_match():
    with pytest.warns(RuntimeWarning, match="ONE 127-row band"):
        plan = SRPlan.from_request((127, 16, 3), num_layers=7)
    with pytest.warns(RuntimeWarning):
        jp = jplan.SRPlan.from_request((127, 16, 3), num_layers=7)
    # one 127-row band: the fallback, and a working set past Table II's budget
    assert pairs(plan.verify()) == pairs(jp.verify()) == [("degenerate_bands", "warning"),
                                                          ("on_chip_budget", "warning")]


# ----------------------------------------------------------------------
# The on-chip budget: the Hopper kernels' own accounting
# ----------------------------------------------------------------------
def test_budget_past_design_point_warns_on_both_banded_backends():
    """``band_rows=120`` doubles K1's per-CTA working set past Table II's
    budget: a warning on both banded backends.  The JAX package makes it
    an error on the kernel backend (its VMEM scratch); K1 takes its
    device-memory route for a band too tall for its maps, whose shared
    memory is the same at every R, so the port does not."""
    for backend in ("kernel", "tilted"):
        plan = SRPlan(height=360, width=64, band_rows=120, backend=backend)
        findings = plan.verify()
        assert errors(findings) == []
        assert pairs(findings) == [("on_chip_budget", "warning")]
    jkern = jplan.SRPlan(height=360, width=64, band_rows=120, backend="kernel")
    assert rules(errors(jkern.verify())) == ["on_chip_budget"]  # the divergence
    report = plan_check.plan_buffer_report(SRPlan(height=360, width=64, band_rows=120,
                                                  backend="kernel"))
    # two fp32 stages of packed weights (bias + TF32 hi and lo words) and two
    # 320-pixel windows of 128-byte pixels: the same at every R
    assert report["route"] == "device"
    assert report["shared_bytes"] == 2 * 4 * (32 + 9 * 4 * 32 * 16) + 2 * 320 * 128 == 229_632


@pytest.mark.parametrize("channels,over", [
    ([3, 32, 32, 27], False),  # 190,624 B a CTA: fits (one CTA an SM is occupancy only)
    ([3, 64, 64, 27], False),  # the wide Chp 64 instance: 2 x 16,384 + 320 x 256 B a CTA
    ([3, 40, 40, 27], False),  # padded to the Chp 48 instance: 2 x 9,216 + 320 x 208 B
    ([3, 136, 136, 27], True),  # no instance above Chp 128
])
def test_shared_memory_past_the_h100_is_an_error_on_the_kernel_backend(channels, over):
    """Every instance of K1 fits one CTA's shared memory (the source
    asserts it); a stack no instance covers is the error a launch would
    raise."""
    plan = SRPlan(height=360, width=64, num_layers=3, backend="kernel")
    errs = errors(plan.verify(channels=channels))
    report = plan_check.plan_buffer_report(plan, channels)
    if not over:
        assert errs == []
        assert report["shared_bytes"] <= plan_check.SMEM_PER_BLOCK_BYTES
        return
    assert rules(errs) == ["on_chip_budget"]
    msg = errs[0].message
    assert "tilted_fusion" in msg and "136" in msg and report["instance"] is None
    # the tilted backend runs no Hopper kernel: its budget rule stays advisory
    tilted = dataclasses.replace(plan, backend="tilted")
    assert errors(tilted.verify(channels=channels)) == []


@pytest.mark.parametrize("backend", ["kernel", "tilted"])
def test_tile_cols_past_k1s_window_is_an_error_on_the_kernel_backend(backend):
    """K1 streams row blocks through a window of ``WINDOW_PIXELS`` pixels
    and refuses a tile too wide for a 3-row window of it: the kernel
    backend's plan says so before a launch; the tilted backend runs no
    Hopper kernel and takes any width."""
    widest = ttf.MAX_TILE_COLS
    assert ttf.block_rows(widest) >= 1 and ttf.block_rows(widest + 1) == 0
    for C, bad in ((widest, False), (widest + 1, True)):
        plan = SRPlan(height=360, width=2 * C, num_layers=3, tile_cols=C, backend=backend)
        errs = [f for f in errors(plan.verify()) if "tile_cols" in f.message]
        if bad and backend == "kernel":
            assert rules(errs) == ["on_chip_budget"] and str(widest) in errs[0].message
        else:
            assert errs == []


def test_plan_buffer_report_reads_k1():
    """At the design point (60-row bands) K1 keeps the two maps of a tile
    in shared memory beside one weight stage; its device workspace is the
    overlap queue alone."""
    report = plan_check.plan_buffer_report(SRPlan(height=360, width=640, backend="kernel"))
    assert report["route"] == "onchip"
    assert report["shared_bytes"] == 2 * 60 * 10 * 128 + 4 * (32 + 9 * 4 * 32 * 8) + 32 \
        == 190_624
    assert report["window_elements"] == 320 * 32
    assert report["device_slab_elements"] == 0
    assert report["table2_elements"] == (2 * 60 * 10 * 32 + report["workspace_elements"]
                                         + 9 * 32 * 32)
    assert report["ctas"] == 6  # one CTA a band for the accounting's launch
    bf16 = plan_check.plan_buffer_report(SRPlan(height=360, width=640, backend="kernel",
                                                precision="bf16"))
    assert bf16["shared_bytes"] == 2 * 60 * 10 * 64 + 4 * (32 + 9 * 2 * 32 * 8) + 32 \
        == 95_392


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("width,instance", [(8, 16), (24, 32), (48, 48), (128, 128)])
def test_verify_is_clean_where_an_instance_launches(width, instance, precision):
    """A stack of ``width`` channels verifies clean on the kernel backend at
    the default ``tile_cols`` 8: the report names the instance the
    wrapper pads it to, whose shared memory fits one CTA."""
    plan = SRPlan(height=360, width=640, num_layers=3, backend="kernel", precision=precision)
    channels = [3, width, width, width]
    assert plan.tile_cols == 8
    assert errors(plan.verify(channels=channels)) == []
    report = plan_check.plan_buffer_report(plan, channels)
    assert report["instance"] == report["chp"] == instance == ttf.launch_chp(width)
    assert report["packed_chp"] == width
    assert report["shared_bytes"] == ttf.shared_bytes(instance, ttf_dtype(precision),
                                                      band_rows=plan.band_rows)
    assert report["shared_bytes"] <= plan_check.SMEM_PER_BLOCK_BYTES
    assert report["max_tile_cols"] >= plan.tile_cols


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_verify_reports_a_width_no_instance_covers(precision):
    """Chp 136 has no instance: an ``on_chip_budget`` error, where before
    the report's shared memory alone decided."""
    plan = SRPlan(height=360, width=640, num_layers=3, backend="kernel", precision=precision)
    errs = errors(plan.verify(channels=[3, 136, 136, 27]))
    assert rules(errs) == ["on_chip_budget"] and "Chp 136" in errs[0].message
    tilted = dataclasses.replace(plan, backend="tilted")
    assert errors(tilted.verify(channels=[3, 136, 136, 27])) == []


def test_verify_reads_abpn_x4_from_the_plan():
    """Without channels, an ABPN-shaped plan at scale 4 is checked at its
    48 outputs and its 28 hidden channels: the mixed launch, on the Chp 32
    instance's shared memory and workspace."""
    plan = SRPlan(height=360, width=640, backend="kernel", scale=4)
    report = plan_check.plan_buffer_report(plan)
    assert report["chp"] == 48 and errors(plan.verify()) == []
    assert report["hidden_chp"] == 32 and report["shared_bytes"] == 190_624
    assert report["route"] == "onchip" and report["window_elements"] == 320 * 32
    assert report["table2_elements"] == (2 * 60 * 10 * 32 + report["workspace_elements"]
                                         + 9 * 32 * 32)


def ttf_dtype(precision):
    return torch.bfloat16 if precision == "bf16" else torch.float32


@pytest.mark.parametrize("band_rows", [12, 60])
def test_table2_crosscheck_exact_and_bounded(band_rows):
    """The model's values are the JAX package's, bit for bit; K1's logical
    overlap and weight counts equal the model; K1 has no residual ring
    (``None``); its per-CTA working set stays within the tolerance at the
    design point."""
    x = plan_check.table2_crosscheck(band_rows=band_rows)
    j = jcheck.table2_crosscheck(band_rows=band_rows)
    assert set(x) == set(j)
    for k in ("model_overlap_kb", "model_residual_kb", "model_weight_kb", "table2_total_kb",
              "tolerance", "kernel_overlap_kb", "kernel_weight_kb"):
        assert x[k] == j[k], k
    assert x["kernel_overlap_kb"] == pytest.approx(x["model_overlap_kb"])
    assert x["kernel_weight_kb"] == pytest.approx(x["model_weight_kb"])
    assert x["kernel_residual_kb"] is None
    if band_rows == 60:
        assert x["table2_total_kb"] == pytest.approx(102.36)
        assert x["budget_ratio"] <= 1.0 + plan_check.BUDGET_TOLERANCE


def test_kernel_buffers_logical_counts():
    rep = kernel_buffers(channels=core_analysis.ABPN_CHANNELS, band_rows=60, tile_cols=8)
    assert rep["chp"] == round_up_channels(28) == 32 and rep["c0p"] == 8
    assert rep["buffers"]["weights"]["logical_elements"] == sum(
        9 * a * b for a, b in zip(core_analysis.ABPN_CHANNELS, core_analysis.ABPN_CHANNELS[1:]))
    assert rep["buffers"]["bias"]["logical_elements"] == sum(core_analysis.ABPN_CHANNELS[1:])


def test_on_chip_budget_kb_exported():
    cfg = core_analysis.HWConfig()
    assert core_analysis.on_chip_budget_kb(cfg) == pytest.approx(
        core_analysis.buffer_sizes(cfg)["total_kb"])
    assert "dram_reduction" in core_analysis.__all__


# ----------------------------------------------------------------------
# Shards (pure geometry, ready for multi-GPU sharding)
# ----------------------------------------------------------------------
def _shard_errors(findings):
    return [f for f in findings if f.rule.startswith("shard_") and f.severity == "error"]


def small_plan(**kw):
    return SRPlan.from_request((24, 16, 3), num_layers=3, scale=2,
                               **{"band_rows": 12, **kw})


def test_shard_halo_insufficiency_is_error():
    plan = small_plan(vertical_policy="halo")
    need = plan_check.required_halo_margin(plan.num_layers)
    errs = _shard_errors(plan_check.verify_plan(plan, band_shards=2, shard_halo_margin=need - 1))
    assert errs and errs[0].rule == "shard_halo_sufficiency"
    assert "shards=2" in errs[0].where
    assert not _shard_errors(plan_check.verify_plan(plan, band_shards=2))
    j = jcheck.verify_plan(as_jax(plan), band_shards=2, shard_halo_margin=need - 1)
    assert pairs(plan_check.verify_plan(plan, band_shards=2, shard_halo_margin=need - 1)) \
        == pairs(j)


def test_shard_backend_and_alignment():
    ref = SRPlan(height=24, width=16, num_layers=3, backend="reference", band_rows=24)
    errs = _shard_errors(plan_check.verify_plan(ref, band_shards=2))
    assert errs and errs[0].rule == "shard_backend"
    one_band = small_plan(band_rows=24)
    errs = _shard_errors(plan_check.verify_plan(one_band, band_shards=2))
    assert errs and errs[0].rule == "shard_band_alignment"
    for p in (ref, one_band):
        assert pairs(plan_check.verify_plan(p, band_shards=2)) == \
            pairs(jcheck.verify_plan(as_jax(p), band_shards=2))


def test_unsharded_has_no_shard_findings():
    plan = small_plan(vertical_policy="halo")
    assert not [f for f in plan_check.verify_plan(plan) if f.rule.startswith("shard_")]
    assert not [f for f in plan.verify(band_shards=1) if f.rule.startswith("shard_")]


# ----------------------------------------------------------------------
# Degenerate and strict sessions
# ----------------------------------------------------------------------
def test_degenerate_plans_counted_and_warned():
    s = session()
    with pytest.warns(RuntimeWarning, match="ONE 127-row band"):
        plan = s.plan_for((127, 16, 3))
    assert plan.degenerate_bands
    assert s.tuning_stats()["degenerate_plans"] == 1
    findings = plan.verify()
    assert errors(findings) == [] and "degenerate_bands" in rules(findings)
    s.plan_for((120, 16, 3))
    assert s.tuning_stats()["degenerate_plans"] == 1


def test_strict_session_rejects_illegal_plan_before_build():
    """A stack wider than any instance of K1 (hidden width 130 -> Chp 136;
    the widest instance is Chp 128) is refused before anything is prepared
    or built."""
    rng = np.random.default_rng(0)
    wide = layers_from_numpy([
        (rng.normal(size=(3, 3, 5, 130)).astype(np.float32), np.zeros(130, np.float32), True),
        (rng.normal(size=(3, 3, 130, 45)).astype(np.float32), np.zeros(45, np.float32), False),
    ])
    s = engine.SRSession(wide, backend="kernel", strict=True, autotune="off", device="cpu")
    with pytest.raises(PlanVerificationError, match="on_chip_budget"):
        s.plan_for((24, 16, 5))
    assert s.cache_stats()["size"] == 0 and s.cache_stats()["stacks"] == []
    # the same stack on a non-strict session derives the plan (and would
    # fail only at the launch on the card)
    assert engine.SRSession(wide, backend="kernel", autotune="off",
                            device="cpu").plan_for((24, 16, 5)).backend == "kernel"


def test_strict_kernel_session_serves_past_the_paper_budget():
    """The documented divergence end to end: the JAX package's strict
    session refuses a kernel plan at ``band_rows=120``; the port's serves
    it (a warning only) and matches the default banding's tilted run."""
    s = session(backend="kernel", band_rows=120, strict=True)
    frames = torch.from_numpy(np.random.default_rng(3).random((1, 240, 16, 3), np.float32))
    hr = s.upscale(frames)
    assert tuple(hr.shape) == (1, 720, 48, 3)
    plan = s.plan_for((240, 16, 3))
    assert plan.band_rows == 120 and plan.backend == "kernel"
    assert torch.equal(hr, engine.run(plan, LAYERS, frames, device="cpu"))


def test_strict_session_serves_legal_plans():
    s = session(strict=True)
    hr = s.upscale(np.zeros(LR, np.float32))
    assert tuple(hr.shape) == (36, 48, 3)


def test_open_accepts_strict():
    assert engine.SRSession.open("abpn_x3", strict=True, autotune="off", device="cpu").strict


# ----------------------------------------------------------------------
# Program audit: real sessions clean, seeded violations caught
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend,precision", [
    ("tilted", "fp32"), ("tilted", "bf16"), ("tilted", "int8"), ("reference", "fp32"),
    ("kernel", "fp32"), ("kernel", "bf16"), ("kernel", "int8"),
])
def test_audit_clean_on_real_cpu_sessions(backend, precision):
    s = session(backend=backend, precision=precision)
    s.upscale(np.zeros(LR, np.float32))
    assert program_audit.audit_session(s) == []


def test_audit_clean_on_a_halo_session():
    s = session(backend="kernel", vertical_policy="halo")
    s.upscale(np.zeros((24, 16, 3), np.float32))
    assert program_audit.audit_session(s) == []


def test_executor_artifacts_on_the_cpu():
    plan = SRPlan.from_request(LR, num_layers=7)
    arts = executor.executor_artifacts(plan, None, 2, layers=LAYERS)
    assert arts["batch"] == 2 and arts["dtype"] == "float32" and arts["plan"] is plan
    assert arts["kernels"] is None and arts["builds"] is None  # the CPU
    names = {o["op"] for o in arts["ops"]}
    assert "aten.convolution" in names and "aten.round" not in names
    assert not any(o["to_host"] or o["from_host"] for o in arts["ops"])
    with pytest.raises(ValueError, match="PreparedStack or raw layers"):
        executor.executor_artifacts(plan, None, 1)


class _FakeWindow:
    """A ``torch.profiler.profile`` stand-in that hands out the event lists
    it is given, one list per window."""

    def __init__(self, windows):
        self.windows = windows

    def __call__(self, activities=None):
        self.events_of_window = self.windows.pop(0)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_of_window


def _event(name, device_type):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(name=name, device_type=getattr(DeviceType, device_type),
                                 time_range=types.SimpleNamespace(start=0, end=10))


def test_profile_call_retries_a_window_with_no_device_event(monkeypatch):
    """A profiler window that delivers no device event is tried again (the
    call is repeatable); three empty windows are an error."""
    from repro_torch.engine import executor

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mark = _event(executor._CALL_MARK, "CPU")
    calls = []
    fake = _FakeWindow([[mark], [mark, _event("k1_kernel", "CUDA")]])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    out = executor._profile_call(lambda: calls.append(1), torch.device("cpu"))
    assert out["kernels"] == ["k1_kernel"] and len(calls) == 2
    monkeypatch.setattr(torch.profiler, "profile", _FakeWindow([[mark]] * 3))
    with pytest.raises(RuntimeError, match="no device activity for the call in 3 windows"):
        executor._profile_call(lambda: None, torch.device("cpu"))


def test_profile_call_leaves_the_executors_spans_out_of_its_kernels(monkeypatch):
    """The executor's ``sr.*`` spans are drawn on the device timeline too;
    they are no kernels, and a window holding only them holds no device
    activity."""
    from repro_torch.engine import executor

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mark = _event(executor._CALL_MARK, "CPU")
    spans = [_event("sr.k1", "CUDA"), _event("sr.epilogue", "CUDA")]
    fake = _FakeWindow([[mark, *spans], [mark, *spans, _event("k1_kernel", "CUDA")]])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    out = executor._profile_call(lambda: None, torch.device("cpu"))
    assert out["kernels"] == ["k1_kernel"] and out["memcpy"] == []


def test_audit_catches_quant_round_in_the_call(monkeypatch):
    s = session(precision="int8")
    s.upscale(np.zeros(LR, np.float32))
    real = executor.sr_epilogue
    monkeypatch.setattr(executor, "sr_epilogue",
                        lambda plan, x, f, d: real(plan, x, torch.round(f * 64) / 64, d))
    found = errors(program_audit.audit_session(s))
    assert rules(found) == ["quant_in_hot_path"]


def test_audit_catches_item_in_the_call(monkeypatch):
    s = session()
    s.upscale(np.zeros(LR, np.float32))
    real = executor.sr_epilogue

    def peeking(plan, x, feats, in_dtype):
        if feats.abs().max().item() > 1e9:  # a host read of a device value
            raise AssertionError
        return real(plan, x, feats, in_dtype)

    monkeypatch.setattr(executor, "sr_epilogue", peeking)
    found = errors(program_audit.audit_session(s))
    assert rules(found) == ["host_transfer"]
    assert "aten._local_scalar_dense" in found[0].message


def test_audit_catches_bf16_upcast(monkeypatch):
    s = session(precision="bf16")
    s.upscale(np.zeros(LR, np.float32))
    assert program_audit.audit_session(s) == []
    monkeypatch.setattr(executor, "compute_dtype_for", lambda precision: torch.float32)
    found = program_audit.audit_session(s)
    assert pairs(found) == [("fp32_upcast", "warning")]


def test_audit_ops_rules_on_seeded_records():
    op = lambda name, dtypes=("float32",), to_host=False, from_host=False: dict(  # noqa: E731
        op=name, dtypes=list(dtypes), to_host=to_host, from_host=from_host)
    clean = [op("aten.convolution"), op("aten._to_copy", ["bfloat16"]), op("aten.add")]
    assert program_audit.audit_ops(clean, precision="bf16") == []
    assert pairs(program_audit.audit_ops(clean[:1] + [op("aten.add")], precision="bf16")) == \
        [("fp32_upcast", "warning")]
    assert program_audit.audit_ops(clean[:1] + [op("aten.add")], precision="fp32") == []
    assert program_audit.audit_ops(clean[:1] + [op("aten.add")], precision="int8") == []
    assert rules(program_audit.audit_ops([op("aten._to_copy", to_host=True)])) == ["host_transfer"]
    assert rules(program_audit.audit_ops([op("aten._to_copy", from_host=True)])) == \
        ["host_callback"]


# profiler records shaped as the card's (names as torch.profiler gives them
# on an H100)
K1_FP32 = "void (anonymous namespace)::tilted_fusion_kernel<float, 32>((anonymous namespace)::Params)"
K1_BF16 = ("void (anonymous namespace)::tilted_fusion_kernel<__nv_bfloat16, 32>"
           "((anonymous namespace)::Params)")


def test_audit_kernels_rules_on_seeded_records():
    rec = lambda kernels, memcpy=(), syncs=(): dict(  # noqa: E731
        kernels=list(kernels), memcpy=list(memcpy), syncs=list(syncs))
    assert program_audit.audit_kernels(rec([K1_FP32]), precision="fp32") == []
    assert program_audit.audit_kernels(rec([K1_BF16]), precision="bf16") == []
    assert pairs(program_audit.audit_kernels(rec([K1_FP32]), precision="bf16")) == \
        [("fp32_upcast", "warning")]
    assert rules(program_audit.audit_kernels(
        rec([K1_FP32], memcpy=["Memcpy DtoH (Device -> Pageable)"]))) == ["host_transfer"]
    assert program_audit.audit_kernels(
        rec([K1_FP32], memcpy=["Memcpy DtoD (Device -> Device)"])) == []
    assert rules(program_audit.audit_kernels(rec([K1_FP32], syncs=["cudaStreamSynchronize"]))) \
        == ["host_callback"]


def test_audit_catches_a_build_in_the_call(monkeypatch):
    s = session()
    s.upscale(np.zeros(LR, np.float32))
    real = executor.executor_artifacts

    def built(*a, **kw):
        return {**real(*a, **kw), "builds": [("tilted_fusion", True)]}

    monkeypatch.setattr(executor, "executor_artifacts", built)
    found = errors(program_audit.audit_session(s))
    assert rules(found) == ["hot_path_build"]
    assert isinstance(_build.load_log(), list)


def test_audit_reports_ignored_donation():
    """Eager PyTorch has no buffer donation: a session built with
    ``donate_frames=True`` gets the ``donation_ignored`` info and no error
    (the JAX package's ``missing_donation``/``donation_bookkeeping`` have
    no counterpart); one built without it gets no donation finding."""
    s = session(donate_frames=True)
    s.upscale(np.zeros(LR, np.float32))
    findings = program_audit.audit_session(s)
    assert errors(findings) == [] and "donation_ignored" in rules(findings)
    plain = session()
    plain.upscale(np.zeros(LR, np.float32))
    assert not any("donation" in f.rule for f in program_audit.audit_session(plain))


def test_audit_server_sees_a_wait_inside_the_launch(monkeypatch):
    """``audit_server`` counts the synchronizing runtime calls inside each
    ``SRServer._launch`` span.  The CPU records none, so a span of that name
    is seeded in the dispatch's assembly: it is caught, a wait outside the
    launch (the completion's) is not, and the server's launch is restored."""
    from torch.profiler import record_function

    s = session()
    server = s._host_server()
    frame = np.zeros(LR, np.float32)
    assert program_audit.audit_server(server, lambda: s.submit(frame)) == []
    assemble = server._assemble

    def waits(d):
        with record_function("cudaStreamSynchronize"):
            return assemble(d)

    monkeypatch.setattr(server, "_assemble", waits)
    found = program_audit.audit_server(server, lambda: s.submit(frame))
    assert pairs(found) == [("host_callback", "error")]
    assert "cudaStreamSynchronize" in found[0].message
    assert "_launch" not in vars(server)
    monkeypatch.undo()

    class WaitsAfter:
        def __init__(self):
            self.fut = s.submit(frame)

        def result(self):
            out = self.fut.result()
            with record_function("cudaStreamSynchronize"):
                return out

    assert program_audit.audit_server(server, WaitsAfter) == []


def test_recompile_detection():
    s = session(cache_capacity=1)
    plan = s.plan_for(LR)
    s.serve_batch(plan, torch.zeros((1, *LR)))
    s.serve_batch(plan, torch.zeros((2, *LR)))  # evicts bucket 1
    s.serve_batch(plan, torch.zeros((1, *LR)))  # re-miss: rebuild
    assert s.cache_stats()["recompiles"] == 1
    findings = program_audit.audit_session(s)
    assert "recompile" in rules(findings) and errors(findings) == []


def test_halo_slabs_copy_nothing_from_the_host():
    """The repair of the audit's one finding on the port's serving path:
    ``halo_slabs`` built its bounds as a host array and copied it to the
    frames' device — a pageable copy after which torch synchronizes the
    stream, inside every halo dispatch (``host_callback`` on the card).  A
    non-CPU device (``meta``) shows the copy on the CPU too."""
    frames = torch.zeros((2, 60, 8, 3), device="meta")
    ops = executor._record_ops(lambda: halo_slabs(frames, 20, 7))
    assert program_audit.audit_ops(ops) == []
    slabs, bounds = halo_slabs(frames, 20, 7)
    assert bounds.device.type == "meta" and bounds.dtype == torch.int32


# ----------------------------------------------------------------------
# Concurrency lint
# ----------------------------------------------------------------------
def test_serving_sources_are_clean():
    assert concurrency_lint.lint_files() == []


def test_lint_default_targets_exist():
    targets = concurrency_lint.default_lint_targets()
    assert [p.name for p in targets] == [
        "server.py", "scheduler.py", "session.py", "band_diff.py",
        "delta_stream.py", "output_cache.py", "resilience.py"]
    assert all(p.exists() and "repro_torch" in p.parts for p in targets)


BLOCKING_SNIPPET = """
import threading, jax
class S:
    def __init__(self):
        self._lock = threading.Lock()
    def bad(self, hr):
        with self._lock:
            jax.block_until_ready(hr)
"""

AWAIT_SNIPPET = """
import threading
class S:
    def __init__(self):
        self._lock = threading.Lock()
    async def bad(self, fut):
        with self._lock:
            return await fut
"""

ASYNC_BLOCKING_SNIPPET = """
class S:
    async def bad(self, fut):
        return fut.result()
"""

CYCLE_SNIPPET = """
import threading
a_lock = threading.Lock()
b_lock = threading.Lock()
def one():
    with a_lock:
        with b_lock:
            pass
def two():
    with b_lock:
        with a_lock:
            pass
"""

WALL_CLOCK_SNIPPET = """
import time
class S:
    def expire(self, deadline):
        return time.time() >= deadline
"""

SAFE_SNIPPET = """
import threading, time
class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
    def ok(self):
        with self._cv:
            self._cv.wait()
            self._cv.notify_all()
    def also_ok(self, hr):
        import jax
        jax.block_until_ready(hr)  # off-lock: the sanctioned discipline
        with self._lock:
            self.done = True
    def deadline_ok(self, deadline):
        return time.monotonic() >= deadline or time.perf_counter() > 0
"""

REFERENCE_SNIPPETS = {
    "blocking_under_lock": BLOCKING_SNIPPET,
    "await_under_lock": AWAIT_SNIPPET,
    "blocking_in_async": ASYNC_BLOCKING_SNIPPET,
    "lock_order_cycle": CYCLE_SNIPPET,
    "wall_clock": WALL_CLOCK_SNIPPET,
}


@pytest.mark.parametrize("rule", sorted(REFERENCE_SNIPPETS))
def test_lint_catches_seeded_violation_as_the_jax_package(rule):
    snippet = REFERENCE_SNIPPETS[rule]
    findings = concurrency_lint.lint_source(snippet, "snippet.py")
    assert rule in rules(errors(findings))
    assert findings == [Finding(**dataclasses.asdict(f))
                        for f in jlint.lint_source(snippet, "snippet.py")]


def test_lint_safe_patterns_pass():
    assert concurrency_lint.lint_source(SAFE_SNIPPET, "safe.py") == []


def test_lock_order_consistent_is_clean():
    consistent = CYCLE_SNIPPET.replace("with b_lock:\n        with a_lock:",
                                       "with a_lock:\n        with b_lock:")
    assert "lock_order_cycle" not in rules(concurrency_lint.lint_source(consistent, "c.py"))


TORCH_CALLS = {
    "torch.cuda.synchronize()": "synchronize",
    "inf.event.synchronize()": "synchronize",
    "self._stream.synchronize()": "synchronize",
    "hr.sum().item()": "item",
    "hr.tolist()": "tolist",
    "hr.cpu()": "cpu",
    "hr.numpy()": "numpy",
}


@pytest.mark.parametrize("call", sorted(TORCH_CALLS))
def test_lint_flags_torch_blocking_calls_under_a_lock(call):
    snippet = (
        "class S:\n"
        "    def bad(self, hr, inf):\n"
        "        with self._lock:\n"
        f"            {call}\n"
        "    def fine(self, hr, inf):\n"
        f"        {call}\n"
        "        with self._lock:\n"
        "            self.done = True\n"
        "    async def stalls(self, hr, inf):\n"
        f"        {call}\n"
    )
    found = concurrency_lint.lint_source(snippet, "server.py")
    assert [(f.rule, f.where) for f in found] == [
        ("blocking_under_lock", "server.py:4 in bad"),
        ("blocking_in_async", "server.py:10 in stalls"),
    ]
    assert TORCH_CALLS[call] in found[0].message
    assert set(jlint.BLOCKING_CALLS) < set(concurrency_lint.BLOCKING_CALLS)


# ----------------------------------------------------------------------
# Findings plumbing, report and CLI
# ----------------------------------------------------------------------
def test_finding_severity_validated():
    with pytest.raises(ValueError):
        Finding(checker="x", rule="y", severity="fatal", message="z")


def test_count_by_severity():
    fs = [Finding(checker="a", rule="r", severity=s, message="m")
          for s in ("error", "warning", "warning")]
    assert count_by_severity(fs) == {"error": 1, "warning": 2, "info": 0}


def test_analysis_report_shape():
    report = sweep.analysis_report(programs=False)
    assert report["clean"] is True
    for checker in ("concurrency", "plan", "program"):
        assert set(report[checker]) == {"error", "warning", "info"}


def test_program_sweep_on_the_cpu():
    assert sweep.sweep_programs(device="cpu") == []


def test_program_sweep_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.sweep_programs()


def test_cli_lint_and_plans(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--lint", "--plans"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "plan verification" in out


def test_cli_exits_nonzero_on_error_findings(tmp_path, monkeypatch):
    bad = tmp_path / "server.py"
    bad.write_text(BLOCKING_SNIPPET)
    monkeypatch.setattr(concurrency_lint, "default_lint_targets", lambda root=None: [bad])
    from repro_torch.analysis.__main__ import main

    assert main(["--lint"]) == 1
