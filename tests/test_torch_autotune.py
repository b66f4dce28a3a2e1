"""The port's schedule autotuner (``repro_torch.engine.autotune``) against the
JAX package's (``repro.engine.autotune``): twins of ``tests/test_autotune.py``.

* Exact equality with the JAX package: ``TuningKey.encode``,
  ``enumerate_candidates`` and ``predict_cost`` under the same
  ``RooflinePeaks`` (the CPU's peaks are the JAX package's CPU numbers).
* The DB: round trip, atomic write, capacity eviction, stale schema, entries
  stamped for another torch, CUDA, device or topology ignored, nearest-batch
  fallback, and ``PlanTuner``'s numerics-safety vetting.  The port's DB is
  its own file (``REPRO_SR_TORCH_TUNING_DB``), never the JAX package's.
* ``tune`` never returns a schedule that measures worse than the default,
  and its 1.5x roofline prune is judged with a deterministic measurement
  (``measure_schedule`` replaced by a cost derived from the analytic model
  with a fixed perturbation), never with timings taken under load.
* Sessions under ``"cached"`` and ``"full"``; tuned output ``torch.equal``
  to the default, including a ``halo`` session on a tuned ``band_rows``.

Everything runs with ``device="cpu"``.  No tensor tolerance: outputs are
compared with ``torch.equal``, model numbers with ``==``.
"""

import dataclasses
import json
import math
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.engine import autotune as jat
from repro.engine import plan as jplan
from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.engine import autotune as at
from repro_torch.engine.autotune import (
    SCHEMA_VERSION,
    PlanTuner,
    TuningDB,
    TuningEntry,
    TuningKey,
    enumerate_candidates,
    predict_cost,
    tune,
)
from repro_torch.engine.plan import SRPlan, derive_band_rows, legal_band_rows
from repro_torch.engine.server import SRServer
from repro_torch.engine.session import SRSession
from repro_torch.models.abpn import layers_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path`` (tests that need a DB pass ``tuning_db=``)."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


CFG = ABPNConfig()
JLAYERS = init_abpn(jax.random.PRNGKey(0), CFG)
LAYERS = layers_from_numpy(JLAYERS)
SMALL = (24, 16, 3)


def small_plan(**kw) -> SRPlan:
    return SRPlan.from_request(SMALL, num_layers=len(LAYERS), scale=CFG.scale, **kw)


def as_jax(plan):
    return jplan.SRPlan(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})


def entry_for(plan: SRPlan, batch: int, **over) -> TuningEntry:
    base = dict(
        band_rows=plan.band_rows, pipeline_depth=1, bucket=batch,
        bucket_policy="exact", predicted_ms=1.0, measured_ms=1.0,
        default_ms=1.5, speedup=1.5,
        torch_version=torch.__version__, cuda_version=torch.version.cuda,
        device_name="cpu", created=123.0, device_count=1, mesh_shape="1x1",
    )
    base.update(over)
    return TuningEntry(**base)


def session(**kw):
    return SRSession(LAYERS, scale=CFG.scale, device="cpu", **kw)


# ----------------------------------------------------------------------
# Exact equality with the JAX package
# ----------------------------------------------------------------------
PLANS = [
    dict(lr=SMALL),
    dict(lr=SMALL, vertical_policy="halo"),
    dict(lr=SMALL, precision="bf16"),
    dict(lr=(48, 16, 3), vertical_policy="halo"),
    dict(lr=(120, 64, 3), vertical_policy="halo", backend="kernel"),
    dict(lr=(360, 640, 3), vertical_policy="halo", backend="kernel"),
    dict(lr=(360, 640, 3), backend="kernel", precision="bf16"),
    dict(lr=(127, 16, 3), vertical_policy="replicate"),
]
PEAKS = {
    "cpu": at.RooflinePeaks(5e10, 2e10, 1 << 20),
    "h100": at.RooflinePeaks(67.38e12, 2.996e12, 50 << 20),
    "absurd": at.RooflinePeaks(1.0, 1e18, 1e18),
}


def both_plans(spec):
    kw = {k: v for k, v in spec.items() if k != "lr"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the prime-height fallback
        tp = SRPlan.from_request(spec["lr"], num_layers=7, scale=3, **kw)
        jp = jplan.SRPlan.from_request(spec["lr"], num_layers=7, scale=3, **kw)
    return tp, jp


@pytest.mark.parametrize("spec", PLANS, ids=lambda s: "-".join(str(v) for v in s.values()))
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_key_and_candidates_equal_the_jax_package(spec, batch):
    tp, jp = both_plans(spec)
    assert TuningKey.from_plan(tp, batch).encode() == jat.TuningKey.from_plan(jp, batch).encode()
    assert TuningKey.from_plan(tp, batch).config_encode() == \
        jat.TuningKey.from_plan(jp, batch).config_encode()
    fields = lambda c: (c.band_rows, c.bucket, c.pipeline_depth, c.is_default, c.pruned)  # noqa
    for kw in ({}, dict(depths=(1, 2)), dict(depths=(3,), max_band_candidates=2)):
        assert [fields(c) for c in enumerate_candidates(tp, batch, **kw)] == \
            [fields(c) for c in jat.enumerate_candidates(jp, batch, **kw)]
    assert at.band_rows_is_tunable(tp) == jat.band_rows_is_tunable(jp)


@pytest.mark.parametrize("peaks", sorted(PEAKS))
@pytest.mark.parametrize("spec", PLANS, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_predict_cost_equals_the_jax_package(spec, peaks):
    tp, jp = both_plans(spec)
    tpk = PEAKS[peaks]
    jpk = jat.RooflinePeaks(tpk.flops_per_s, tpk.hbm_bytes_per_s, tpk.cache_bytes)
    for bucket, real in ((1, 1), (4, 3), (8, 8)):
        assert predict_cost(tp, LAYERS, bucket, real, tpk) == \
            jat.predict_cost(jp, JLAYERS, bucket, real, jpk)


def test_cpu_peaks_are_the_jax_package_cpu_peaks():
    assert dataclasses.asdict(at.RooflinePeaks.detect()) == \
        dataclasses.asdict(jat.RooflinePeaks.detect())
    assert at.RooflinePeaks.detect("cpu") == at.RooflinePeaks.detect()
    plan = small_plan()
    assert predict_cost(plan, LAYERS, 4, 3) == jat.predict_cost(as_jax(plan), JLAYERS, 4, 3)
    with pytest.raises(ValueError, match="no roofline peaks"):
        at.RooflinePeaks.detect("meta")


def test_constants_equal():
    assert at.DEPTHS == jat.DEPTHS and at.TIE_TOL == jat.TIE_TOL


def test_predict_cost_orders_padding_waste_and_halo_recompute():
    plan = small_plan()
    exact = predict_cost(plan, LAYERS, 3, 3)["ms_per_frame"]
    padded = predict_cost(plan, LAYERS, 4, 3)["ms_per_frame"]
    assert padded == pytest.approx(exact * 4 / 3) and padded > exact
    h = SRPlan.from_request((120, 16, 3), num_layers=7, vertical_policy="halo")
    z = SRPlan.from_request((120, 16, 3), num_layers=7)
    assert predict_cost(h, LAYERS, 1, 1)["flops_per_frame"] > \
        predict_cost(z, LAYERS, 1, 1)["flops_per_frame"]


# ----------------------------------------------------------------------
# The port's own DB file
# ----------------------------------------------------------------------
def test_default_db_is_the_port_own(monkeypatch, tmp_path):
    monkeypatch.delenv(at.DB_ENV_VAR)
    monkeypatch.setenv("REPRO_SR_TUNING_DB", str(tmp_path / "jax.json"))  # the JAX package's
    path = at.default_db_path()
    assert path.endswith(os.path.join(".cache", "repro-sr-torch", "tuning.json"))
    assert path != jat.default_db_path()
    monkeypatch.setenv(at.DB_ENV_VAR, str(tmp_path / "mine.json"))
    assert at.default_db_path() == str(tmp_path / "mine.json")
    assert at.DB_ENV_VAR == "REPRO_SR_TORCH_TUNING_DB" != jat.DB_ENV_VAR


def test_db_round_trip(tmp_path):
    path = str(tmp_path / "db.json")
    plan = small_plan()
    key = TuningKey.from_plan(plan, 3)
    db = TuningDB(path)
    db.put(key, entry_for(plan, 3))
    db.save()
    got = TuningDB(path).get(key)
    assert got is not None and got.bucket == 3 and got.bucket_policy == "exact"
    assert got.speedup == 1.5
    assert TuningDB(path).get(TuningKey.from_plan(plan, 5)) is None
    assert json.load(open(path))["schema"] == SCHEMA_VERSION


def test_db_atomic_write_leaves_no_partial_file(tmp_path):
    path = str(tmp_path / "db.json")
    plan = small_plan()
    db = TuningDB(path)
    db.put(TuningKey.from_plan(plan, 1), entry_for(plan, 1))
    db.save()
    before = open(path).read()
    broken = entry_for(plan, 2)
    broken.band_rows = object()  # json.dump raises mid-write
    db.put(TuningKey.from_plan(plan, 2), broken)
    with pytest.raises(TypeError):
        db.save()
    assert open(path).read() == before
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    assert TuningDB(path).get(TuningKey.from_plan(plan, 1)) is not None


def test_db_stale_schema_rejected(tmp_path):
    path = str(tmp_path / "db.json")
    plan = small_plan()
    key = TuningKey.from_plan(plan, 1)
    db = TuningDB(path)
    db.put(key, entry_for(plan, 1))
    db.save()
    raw = json.load(open(path))
    raw["schema"] = SCHEMA_VERSION + 1
    json.dump(raw, open(path, "w"))
    stale = TuningDB(path)
    assert stale.stale_schema is True and len(stale) == 0 and stale.get(key) is None


@pytest.mark.parametrize("field,value", [
    ("torch_version", "0.0.1"), ("cuda_version", "9.9"),
    ("device_name", "NVIDIA H100 80GB HBM3"), ("device_count", 8), ("mesh_shape", "2x4"),
])
def test_db_foreign_stamp_ignored_never_applied(tmp_path, field, value):
    """An entry tuned under another torch, CUDA, card or topology is kept in
    the file but never applied here."""
    path = str(tmp_path / "db.json")
    plan = small_plan()
    key = TuningKey.from_plan(plan, 1)
    db = TuningDB(path)
    db.put(key, entry_for(plan, 1, **{field: value}))
    db.save()
    db2 = TuningDB(path)
    assert db2.get(key) is None and len(db2) == 1
    assert PlanTuner(db2).lookup(key) == (None, "miss")
    if field == "mesh_shape":
        assert db2.get(key, mesh_shape="2x4") is not None
        entry, kind = PlanTuner(db2, mesh_shape="2x4").lookup(key)
        assert kind == "hit" and entry.mesh_shape == "2x4"
    if field == "device_count":
        assert db2.get(key, device_count=8) is not None


def test_entry_missing_stamp_rejected():
    for field in ("device_count", "mesh_shape", "device_name", "cuda_version"):
        d = entry_for(small_plan(), 1).to_dict()
        del d[field]
        assert TuningEntry.from_dict(d) is None


def test_db_malformed_and_torn_files_start_empty(tmp_path):
    torn = tmp_path / "torn.json"
    torn.write_text('{"schema": 1, "entries": {"k": ')
    db = TuningDB(str(torn))
    assert len(db) == 0 and db.stale_schema is False
    notdict = tmp_path / "list.json"
    notdict.write_text("[1, 2, 3]")
    db2 = TuningDB(str(notdict))
    assert len(db2) == 0 and db2.stale_schema is True
    with pytest.raises(ValueError, match="capacity"):
        TuningDB(str(tmp_path / "x.json"), capacity=0)


def test_db_bounded_capacity_evicts_oldest(tmp_path):
    plan = small_plan()
    db = TuningDB(str(tmp_path / "db.json"), capacity=3)
    for b in (1, 2, 3, 4):
        db.put(TuningKey.from_plan(plan, b), entry_for(plan, b))
    assert len(db) == 3
    assert db.get(TuningKey.from_plan(plan, 1)) is None
    assert db.get(TuningKey.from_plan(plan, 4)) is not None
    assert db.keys()[0] == TuningKey.from_plan(plan, 2).encode()


def test_db_nearest_batch_fallback(tmp_path):
    plan = small_plan()
    db = TuningDB(str(tmp_path / "db.json"))
    db.put(TuningKey.from_plan(plan, 4), entry_for(plan, 4, bucket=4))
    db.put(TuningKey.from_plan(plan, 16), entry_for(plan, 16, bucket=16))
    entry, tuned_batch = db.get_nearest_batch(TuningKey.from_plan(plan, 5))
    assert tuned_batch == 4 and entry.bucket == 4
    other = small_plan(vertical_policy="halo")
    assert db.get_nearest_batch(TuningKey.from_plan(other, 5)) is None


# ----------------------------------------------------------------------
# PlanTuner
# ----------------------------------------------------------------------
def test_tuner_hit_fallback_miss(tmp_path):
    plan = small_plan()
    db = TuningDB(str(tmp_path / "db.json"))
    db.put(TuningKey.from_plan(plan, 3), entry_for(plan, 3))
    tuner = PlanTuner(db)
    assert tuner.lookup(TuningKey.from_plan(plan, 3))[1] == "hit"
    assert tuner.lookup(TuningKey.from_plan(plan, 7))[1] == "fallback"
    assert tuner.lookup(TuningKey.from_plan(small_plan(precision="bf16"), 3))[1] == "miss"


def test_tuner_safe_rejects_numerics_unsafe_and_stale_entries(tmp_path):
    zero_plan = small_plan()  # zero policy, band_rows 24 (the default)
    halo_plan = small_plan(vertical_policy="halo")
    db = TuningDB(str(tmp_path / "db.json"))
    tuner = PlanTuner(db)
    zkey, hkey = TuningKey.from_plan(zero_plan, 1), TuningKey.from_plan(halo_plan, 1)
    assert tuner._safe(zkey, entry_for(zero_plan, 1)) is True
    assert tuner._safe(zkey, entry_for(zero_plan, 1, band_rows=8)) is False  # zero: numerics
    assert tuner._safe(hkey, entry_for(halo_plan, 1, band_rows=8)) is True  # halo: exact
    assert tuner._safe(hkey, entry_for(halo_plan, 1, band_rows=7)) is False  # stale geometry
    db.put(zkey, entry_for(zero_plan, 1, band_rows=8))
    assert tuner.lookup(zkey) == (None, "miss")
    db.put(hkey, entry_for(halo_plan, 1, band_rows=8))
    entry, kind = tuner.lookup(hkey)
    assert kind == "hit" and entry.band_rows == 8


def test_from_request_consults_tuner(tmp_path):
    halo_plan = small_plan(vertical_policy="halo")
    db = TuningDB(str(tmp_path / "db.json"))
    db.put(TuningKey.from_plan(halo_plan, 2), entry_for(halo_plan, 2, band_rows=8))
    tuned = SRPlan.from_request(SMALL, num_layers=7, vertical_policy="halo", scale=3,
                                tuner=PlanTuner(db), bucket=2)
    assert tuned.band_rows == 8 and tuned.degenerate_bands is False
    assert small_plan(vertical_policy="halo").band_rows == 24


def test_tuner_reads_entries_for_its_own_device(tmp_path):
    plan = small_plan()
    db = TuningDB(str(tmp_path / "db.json"))
    db.put(TuningKey.from_plan(plan, 1), entry_for(plan, 1, device_name="NVIDIA H100"))
    assert PlanTuner(db, device="cpu").lookup(TuningKey.from_plan(plan, 1)) == (None, "miss")
    assert at.device_name("cpu") == at.device_name() == "cpu"


# ----------------------------------------------------------------------
# tune(): guarantees, pruning safety (deterministic measurement)
# ----------------------------------------------------------------------
def test_measure_schedule_on_the_cpu():
    calls = []

    def fn(chunk):
        calls.append(chunk.shape[0])
        return chunk * 2

    chunks = [torch.zeros((2, 4, 4, 3)) for _ in range(3)]
    t = at.measure_schedule(fn, chunks, depth=2, reps=2)
    assert t > 0 and calls == [2] * (1 + 2 * 3)  # one warm-up outside the timing


def test_default_candidate_never_pruned():
    plan = small_plan()
    entry = tune(LAYERS, plan, 3, depths=(1,), chunks=2, reps=1, peaks=PEAKS["absurd"])
    assert not any(c.pruned and c.is_default for c in entry.candidates)
    assert any(not c.pruned for c in entry.candidates)
    assert entry.device_name == "cpu" and entry.torch_version == torch.__version__


def test_tuned_never_regresses_below_default():
    plan = small_plan()
    for batch in (1, 3):
        entry = tune(LAYERS, plan, batch, depths=(1, 2), chunks=2, reps=1)
        assert entry.measured_ms <= entry.default_ms and entry.speedup >= 1.0


def _deterministic_measure(layers, perturb):
    """A stand-in for ``measure_schedule``: seconds = the analytic model's
    time for the executor's plan and bucket, times a fixed perturbation of
    (band_rows, bucket, depth) — the same answer every run, under any load."""
    def measure(fn, chunks, depth, reps=2, *, device=None):
        plan = fn.args[0]
        bucket = chunks[0].shape[0]
        ms = predict_cost(plan, layers, bucket, bucket, PEAKS["cpu"])["ms_per_frame"]
        return ms * perturb(plan.band_rows, bucket, depth) * len(chunks) * bucket / 1e3
    return measure


def _mild(band_rows, bucket, depth):
    return 1.0 + 0.2 * ((7 * band_rows + 3 * bucket + depth) % 5) / 4


PRUNE_PLANS = [dict(), dict(vertical_policy="halo"), dict(precision="bf16")]


@pytest.mark.parametrize("kw", PRUNE_PLANS + [dict(lr=(48, 16, 3), vertical_policy="halo")],
                         ids=["zero", "halo", "bf16", "halo48"])
def test_pruning_never_discards_measured_best(monkeypatch, kw):
    """The 1.5x prune keeps the measured-best candidate, with the
    measurement made deterministic: one unpruned sweep finds the best, the
    pruned sweep must keep it and pick the same winner."""
    monkeypatch.setattr(at, "measure_schedule", _deterministic_measure(LAYERS, _mild))
    kw = dict(kw)
    plan = SRPlan.from_request(kw.pop("lr", SMALL), num_layers=7, scale=3, **kw)
    full = tune(LAYERS, plan, 3, depths=(1, 2), chunks=2, reps=2, measure_all=True)
    assert not any(c.pruned for c in full.candidates)
    best_pred = min(c.predicted_ms for c in full.candidates)
    best = min(full.candidates, key=lambda c: c.measured_ms)
    assert best.is_default or best.predicted_ms <= 1.5 * best_pred
    pruned = tune(LAYERS, plan, 3, depths=(1, 2), chunks=2, reps=2)
    kept = {(c.band_rows, c.bucket, c.pipeline_depth) for c in pruned.candidates if not c.pruned}
    assert (best.band_rows, best.bucket, best.pipeline_depth) in kept
    assert (pruned.band_rows, pruned.bucket, pruned.pipeline_depth) == \
        (full.band_rows, full.bucket, full.pipeline_depth)


def test_prune_rule_has_teeth(monkeypatch):
    """The converse, so the test above can fail: a measurement that makes a
    candidate predicted > 1.5x the roofline best the fastest is pruned away,
    and the pruned sweep then misses it."""
    plan = SRPlan.from_request((48, 16, 3), num_layers=7, scale=3, vertical_policy="halo")
    preds = {c.band_rows: predict_cost(dataclasses.replace(plan, band_rows=c.band_rows),
                                       LAYERS, c.bucket, 3, PEAKS["cpu"])["ms_per_frame"]
             for c in enumerate_candidates(plan, 3)}
    worst_band = max(preds, key=preds.get)
    assert preds[worst_band] > 1.5 * min(preds.values())
    monkeypatch.setattr(at, "measure_schedule", _deterministic_measure(
        LAYERS, lambda band, bucket, depth: 0.01 if band == worst_band else 1.0))
    full = tune(LAYERS, plan, 3, depths=(1, 2), chunks=2, measure_all=True)
    assert full.band_rows == worst_band
    pruned = tune(LAYERS, plan, 3, depths=(1, 2), chunks=2)
    assert pruned.band_rows != worst_band


def test_tune_persists_and_reload_hits(tmp_path):
    plan = small_plan()
    db = TuningDB(str(tmp_path / "db.json"))
    entry = tune(LAYERS, plan, 3, db=db, depths=(1,), chunks=2, reps=1)
    got = TuningDB(str(tmp_path / "db.json")).get(TuningKey.from_plan(plan, 3))
    assert got is not None and got.bucket == entry.bucket
    assert got.pipeline_depth == entry.pipeline_depth
    with pytest.raises(ValueError, match="batch"):
        tune(LAYERS, plan, 0)


# ----------------------------------------------------------------------
# Serving integration
# ----------------------------------------------------------------------
def warm_db(path: str, plan: SRPlan, batch: int) -> TuningEntry:
    return tune(LAYERS, plan, batch, db=TuningDB(path), depths=(1, 2), chunks=2, reps=1)


def test_cached_session_builds_only_the_winner(tmp_path):
    path = str(tmp_path / "db.json")
    entry = warm_db(path, small_plan(), 3)
    s = session(autotune="cached", tuning_db=path)
    frames = np.random.default_rng(0).random((3, *SMALL), np.float32)
    assert tuple(s.upscale(frames).shape) == (3, 72, 48, 3)
    ts = s.tuning_stats()
    assert ts["hits"] == 1 and ts["misses"] == 0 and ts["applied"] == 1 and ts["tuned_now"] == 0
    cs = s.cache_stats()
    assert cs["misses"] == 1 and len(cs["entries"]) == 1
    assert cs["entries"][0]["bucket"] == entry.bucket
    assert cs["entries"][0]["band_rows"] == entry.band_rows
    assert s.pipeline_depth == entry.pipeline_depth


def test_cached_mode_never_measures_on_miss(tmp_path):
    path = str(tmp_path / "db.json")
    s = session(autotune="cached", tuning_db=path)
    s.upscale(np.zeros((3, *SMALL), np.float32))
    ts = s.tuning_stats()
    assert ts["misses"] == 1 and ts["tuned_now"] == 0
    assert not os.path.exists(path)
    assert s.cache_stats()["entries"][0]["bucket"] == 4 and s.pipeline_depth == 2


def test_full_mode_tunes_on_miss_and_persists(tmp_path):
    path = str(tmp_path / "db.json")
    s = session(autotune="full", tuning_db=path)
    frames = np.zeros((3, *SMALL), np.float32)
    s.upscale(frames)
    ts = s.tuning_stats()
    assert ts["misses"] == 1 and ts["tuned_now"] == 1 and ts["applied"] == 1
    assert len(TuningDB(path)) == 1
    s2 = session(autotune="cached", tuning_db=path)
    s2.upscale(frames)
    assert s2.tuning_stats()["hits"] == 1 and s2.tuning_stats()["tuned_now"] == 0


def test_off_mode_never_touches_db(tmp_path):
    s = session(autotune="off")
    assert s._tuner is None
    s.upscale(np.zeros((3, *SMALL), np.float32))
    assert s.tuning_stats() == {"mode": "off", "db_path": None, "hits": 0, "misses": 0,
                                "fallbacks": 0, "applied": 0, "tuned_now": 0,
                                "pipeline_depth": 2, "exact_buckets": [],
                                "degenerate_plans": 0}


def test_default_mode_is_cached_on_the_port_db(tmp_path):
    s = session()
    assert s.autotune == "cached"
    assert s.tuning_stats()["db_path"] == str(tmp_path / "tuning.json")


def test_explicit_pipeline_depth_never_overridden(tmp_path):
    path = str(tmp_path / "db.json")
    plan = small_plan()
    db = TuningDB(path)
    db.put(TuningKey.from_plan(plan, 3), entry_for(plan, 3, pipeline_depth=4))
    db.save()
    s = session(autotune="cached", tuning_db=path, pipeline_depth=3)
    s.upscale(np.zeros((3, *SMALL), np.float32))
    assert s.tuning_stats()["applied"] == 1 and s.pipeline_depth == 3
    s2 = session(autotune="cached", tuning_db=path)
    s2.upscale(np.zeros((3, *SMALL), np.float32))
    assert s2.pipeline_depth == 4 and s2.tuning_stats()["exact_buckets"] == [3]
    assert s2.cache_stats()["entries"][0]["bucket"] == 3


def test_invalid_autotune_mode_rejected():
    with pytest.raises(ValueError, match="autotune"):
        session(autotune="always")


def test_server_passes_policy_per_model_and_the_batch(tmp_path):
    srv = SRServer.open("abpn_x3", autotune="off", device="cpu")
    assert srv.session().tuning_stats()["mode"] == "off"
    srv2 = SRServer.open("abpn_x3", autotune={"abpn_x3": "full"}, device="cpu")
    assert srv2.session().tuning_stats()["mode"] == "full"
    # the server keys the lookup by the request's frame count
    path = str(tmp_path / "db.json")
    halo = small_plan(vertical_policy="halo")
    db = TuningDB(path)
    db.put(TuningKey.from_plan(halo, 5), entry_for(halo, 5, band_rows=8, bucket=5))
    db.save()
    srv3 = SRServer(session(autotune="cached", tuning_db=path, vertical_policy="halo"))
    srv3.submit(np.zeros((5, *SMALL), np.float32)).result()
    s = srv3.session()
    assert s.tuning_stats()["hits"] == 1 and s.plan_for(SMALL).band_rows == 8


# ----------------------------------------------------------------------
# Numerics: tuning never changes the output
# ----------------------------------------------------------------------
def test_tuned_output_bit_exact_vs_default(tmp_path):
    path = str(tmp_path / "db.json")
    warm_db(path, small_plan(), 3)
    frames = np.random.default_rng(1).random((3, *SMALL), np.float32)
    tuned = session(autotune="cached", tuning_db=path).upscale(frames)
    default = session(autotune="off").upscale(frames)
    assert torch.equal(tuned, default)


@pytest.mark.parametrize("backend", ["tilted", "kernel"])
def test_halo_band_rows_move_is_bit_exact(backend):
    """Under halo every legal band decomposition gives the same output, so
    a tuned ``band_rows`` cannot change what is served."""
    shape = (48, 16, 3)
    frames = torch.from_numpy(np.random.default_rng(2).random((2, *shape), np.float32))
    outs = []
    for band in legal_band_rows(48):
        plan = SRPlan.from_request(shape, num_layers=7, vertical_policy="halo",
                                   band_rows=band, scale=3, backend=backend)
        outs.append(SRSession.from_plan(plan, LAYERS, autotune="off", device="cpu")
                    .upscale(frames))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_halo_session_on_a_tuned_band_rows_equals_the_default(tmp_path):
    path = str(tmp_path / "db.json")
    halo = SRPlan.from_request((48, 16, 3), num_layers=7, scale=3, vertical_policy="halo")
    assert derive_band_rows(48) == 48
    db = TuningDB(path)
    db.put(TuningKey.from_plan(halo, 2), entry_for(halo, 2, band_rows=12, bucket=2))
    db.save()
    frames = np.random.default_rng(4).random((2, 48, 16, 3), np.float32)
    tuned = session(autotune="cached", tuning_db=path, vertical_policy="halo")
    out = tuned.upscale(frames)
    assert tuned.plan_for((48, 16, 3)).band_rows == 12
    default = session(autotune="off", vertical_policy="halo")
    assert default.plan_for((48, 16, 3)).band_rows == 48
    assert torch.equal(out, default.upscale(frames))


def test_main_requires_sweep_and_runs_quick_on_the_cpu(tmp_path, capsys):
    with pytest.raises(SystemExit):
        at.main([])
    path = str(tmp_path / "db.json")
    assert at.main(["--sweep", "--quick", "--device", "cpu", "--db", path]) == 0
    out = capsys.readouterr().out  # --quick: 24x16, batches 1 and 3
    assert "wrote 2 entries" in out and len(TuningDB(path)) == 2
    assert math.isfinite(TuningDB(path).get(
        TuningKey.from_plan(SRPlan.from_request((24, 16, 3), num_layers=7), 1)).measured_ms)
