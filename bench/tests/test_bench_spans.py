"""The readers of the program's own serving counters (``run.session``, which
``SRSession.stats()`` fills): each gives its number from a synthetic record,
and nothing where the program keeps no such counter, as a program older
than these counters does."""

import json
from pathlib import Path

import pytest

from harness import clients, registry
from harness.cell import RunRecord

BENCH = Path(__file__).resolve().parents[1]

# the counters of a window, as SRSession.stats() reports them
SESSION = {
    "p50_ms": 180.0, "batches": 12,
    "requests": 150, "queue_wait_p50_ms": 210.5,
    "submits": 154, "submit_max_ms": 61.25,
    "pins": 154, "pin_ms": 5544.0, "pin_frames": 27720,
    "join_device_ms": 554.4, "join_frames": 27000,
    "upload_device_ms": 1683.0, "upload_frames": 27500,
    "epilogue_device_ms": 2970.0, "epilogue_frames": 27500,
}
# each new metric: its value from SESSION, and the counters it reads
READINGS = {
    "queue_wait_p50_ms.vod": (210.5, ("requests", "queue_wait_p50_ms")),
    "submit_max_ms.vod": (61.25, ("submits", "submit_max_ms")),
    "pin_ms_per_frame.vod": (5544.0 / 27720, ("pin_ms", "pin_frames")),
    "join_ms_per_frame.vod": (554.4 / 27000, ("join_device_ms", "join_frames")),
    "upload_ms_per_frame.vod": (1683.0 / 27500, ("upload_device_ms", "upload_frames")),
    "epilogue_ms_per_frame.vod": (2970.0 / 27500, ("epilogue_device_ms", "epilogue_frames")),
}
# the count each metric is taken over: none counted, nothing to read
COUNTS = {"queue_wait_p50_ms.vod": "requests", "submit_max_ms.vod": "submits",
          "pin_ms_per_frame.vod": "pin_frames", "join_ms_per_frame.vod": "join_frames",
          "upload_ms_per_frame.vod": "upload_frames",
          "epilogue_ms_per_frame.vod": "epilogue_frames"}


def _record(session):
    cfg = json.loads((BENCH / "configs" / "abpn_x3.json").read_text())
    w = clients.Window(t0=0.0, t1=20.0,
                       requests=[clients.Request(rid=0, n=180, start=0, done=1.0)])
    return RunRecord(cell={"name": "x3_fp32_vod"}, config=cfg, traffic={"kind": "closed"},
                     traced=True, setup_s=12.0, window=w,
                     sched=dict(dispatches=4, frames_dispatched=30, slots_dispatched=40),
                     session=dict(session), k1_launches=4, window_builds=0,
                     family=registry.family(cfg))


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_gives_the_program_counter(name):
    want, _ = READINGS[name]
    assert registry.reader(name)(_record(SESSION)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_finds_nothing_without_its_counters(name):
    read = registry.reader(name)
    _, keys = READINGS[name]
    # the parent's stats: no such counter at all
    parent = {k: v for k, v in SESSION.items() if k not in keys}
    assert read(_record(parent)) is None
    # a window in which nothing was counted
    assert read(_record(dict(SESSION, **{COUNTS[name]: 0}))) is None


def test_registry_reports_each_new_metric_in_both_cells():
    bench = registry.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READINGS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "frames_per_s")
        for cell in ("x3_fp32_vod", "x4_bf16_vod"):
            assert m in registry.metrics_for(bench, cell, True)
            assert m not in registry.metrics_for(bench, cell, False)
    rec = _record(SESSION)
    got = registry.read_metrics([entries[n] for n in READINGS], rec)
    assert set(got) == set(READINGS)
    assert registry.read_metrics([entries[n] for n in READINGS], _record({})) == {}
