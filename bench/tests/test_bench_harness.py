"""The harness's own arithmetic and rules, on the CPU: the traffic
generator, the statistics and metric readers, the trace reduction, the
registry and the names, and the imports of everything under ``bench/``."""

import ast
import hashlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from harness import clients, registry, stats, traffic
from harness.cell import RunRecord
from harness.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
VOD = {"kind": "closed", "clients": 3, "frames_per_request": 4, "pool_frames": 16,
       "sample_requests": 2, "sample_frames": 3, "warm_max_bucket": 4}


# ----------------------------------------------------------------------
# Traffic
# ----------------------------------------------------------------------
def test_closed_starts_are_seeded_and_in_the_pool():
    a = traffic.closed_starts(VOD, 9, 1, 16)
    b = traffic.closed_starts(VOD, 9, 1, 16)
    xs = [next(a) for _ in range(50)]
    assert xs == [next(b) for _ in range(50)]
    assert all(0 <= x <= 16 - 4 for x in xs)


def test_warm_up_draws_other_frames():
    a = traffic.closed_starts(dict(VOD, pool_frames=400), 3, 0, 400)
    b = traffic.closed_starts(dict(VOD, pool_frames=400), 3, 0, 400, warm=True)
    assert [next(a) for _ in range(20)] != [next(b) for _ in range(20)]


def test_traffic_check_refuses_a_bad_file():
    traffic.check(dict(VOD))
    with pytest.raises(ValueError):
        traffic.check(dict(VOD, kind="open"))
    with pytest.raises(ValueError):
        traffic.check(dict(VOD, clients=0))
    with pytest.raises(ValueError):
        traffic.check(dict(VOD, frames_per_request=17))
    with pytest.raises(ValueError):
        traffic.check({k: v for k, v in VOD.items() if k != "sample_frames"})


def test_the_committed_mix_is_a_segment_of_its_source():
    """One request a 6 s HLS segment of 30 fps video, longer than the
    configurations' largest dispatch, so that requests span dispatches."""
    tr = registry.traffic("vod")
    traffic.check(tr)
    assert tr["frames_per_request"] == 6 * 30
    assert "hls-authoring-specification" in tr["source"]
    bench = registry.load_benchmark()
    for wl in bench["workloads"]:
        cfg = registry.config(bench, wl["config"])
        assert tr["frames_per_request"] > cfg["serving"]["max_bucket"] == tr["warm_max_bucket"]


# ----------------------------------------------------------------------
# Statistics and metric readers
# ----------------------------------------------------------------------
def test_spread_is_the_interquartile_distance_over_the_median():
    assert stats.spread([10.0, 10.0, 10.0, 10.0]) == 0.0
    vals = [9.0, 10.0, 10.0, 11.0, 12.0, 8.0]
    q1, med, q3 = __import__("statistics").quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def _record(kind, requests, t0=0.0, t1=1.5, **kw):
    cfg = json.loads((BENCH / "configs" / "abpn_x3.json").read_text())
    w = clients.Window(t0=t0, t1=t1, requests=requests)
    base = dict(cell={"name": "c"}, config=cfg, traffic={"kind": kind}, traced=False,
                setup_s=7.0, window=w, sched=dict(dispatches=4, frames_dispatched=30,
                                                  slots_dispatched=40),
                session={"p50_ms": 3.5, "batches": 4}, k1_launches=4, window_builds=0,
                family=registry.family(cfg))
    base.update(kw)
    return RunRecord(**base)


def _read(name, rec):
    return registry.reader(name)(rec)


def test_frames_per_s_takes_all_the_work_over_all_the_window():
    reqs = [clients.Request(rid=i, n=10, start=0, done=0.5 + 0.1 * i)
            for i in range(5)]
    reqs[2].failed = "boom"
    rec = _record("closed", reqs, t0=0.0, t1=1.5)
    assert _read("frames_per_s", rec) == pytest.approx(40 / 1.5)
    reqs[3].done = math.nan  # never finished: not a frame done
    assert _read("frames_per_s", rec) == pytest.approx(30 / 1.5)


def test_counter_readers():
    rec = _record("closed", [clients.Request(rid=0, n=30, start=0, done=1.0)])
    assert _read("sched_fill.vod", rec) == 0.75
    assert _read("dispatch_p50_ms.vod", rec) == 3.5
    assert _read("setup_s", rec) == 7.0
    # 30 frames of 19.74 GFLOP over 1.5 s at 165 TFLOP/s
    assert _read("mfu.vod", rec) == pytest.approx(100 * 30 * 19.7406e9 / 1.5 / 165e12, rel=1e-3)
    # no trace, no buckets: the trace's readers find nothing
    for name in ("glue_ms_per_frame.vod", "k1_roofline.vod", "idle_pct.vod",
                 "k1_work_ratio.vod"):
        assert _read(name, rec) is None


def test_trace_readers_and_roofline_arithmetic():
    k1 = "void tilted_fusion_kernel_onchip<float, 32, false>(Params)"
    dev = [("Memcpy HtoD (Pinned -> Device)", 0, 100), (k1, 100, 1_000_100),
           ("pack_weights_kernel<float, 32>", 1_000_100, 1_000_200),
           ("elementwise_kernel", 1_000_300, 1_000_400)]
    tr = Trace(t0_ns=0, t1_ns=2_000_000, device=dev,
               host=[("bench.result", 0, 2_000_000), ("aten::cat", 1_500_000, 1_900_000)],
               all_threads=True)
    rec = _record("closed", [clients.Request(rid=0, n=30, start=0, done=1.0)],
                  trace=tr, buckets=[32, 8], k1_executed_flops={32: 10 ** 12, 8: 3 * 10 ** 11})
    assert _read("glue_ms_per_frame.vod", rec) == pytest.approx(200e-6 / 30)
    assert _read("idle_pct.vod", rec) == pytest.approx(100 * (1 - 1_000_300 / 2_000_000))
    least = 19.7406e9 / 165e12 * 40
    assert _read("k1_roofline.vod", rec) == pytest.approx(100 * least / 1.0001e-3, rel=1e-3)
    assert _read("k1_work_ratio.vod", rec) == pytest.approx(1.3e12 / (19.7406e9 * 30), rel=1e-3)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == [k1, pytest.approx(1e-3)]
    # the long gap at the end is named by the most specific host event there
    assert bd["idle_gaps"][0][0] == "aten::cat"
    assert tr.count(lambda n: "tilted_fusion" in n) == 1


def test_trace_union_merges_overlaps_and_clips_to_the_window():
    tr = Trace(t0_ns=100, t1_ns=1000, device=[("a", 0, 300), ("b", 200, 400), ("c", 900, 1200)],
               host=[], all_threads=False)
    assert tr.busy() == [(100, 400), (900, 1000)]
    assert tr.gaps() == [(400, 900)]
    assert tr.busy_s() == pytest.approx(400e-9)


def test_sampler_keeps_the_least_keys_whatever_the_order():
    reqs = [clients.Request(rid=i, n=6, start=0) for i in range(40)]
    a, b = clients.Sampler(5, 77, 2), clients.Sampler(5, 77, 2)
    hr = {r.rid: torch.full((6, 3, 2, 1), float(r.rid)) + torch.arange(6.0).view(6, 1, 1, 1)
          for r in reqs}
    for r in reqs:
        a.offer(r, hr[r.rid])
    for r in reversed(reqs):
        b.offer(r, hr[r.rid])
    kept = a.items()
    assert [(r.rid, p) for r, p, _ in kept] == [(r.rid, p) for r, p, _ in b.items()]
    assert len(kept) == 5
    for r, pos, got in kept:
        # the frames at the seeded positions, copied out of the output
        assert len(pos) == 2 and pos == clients.positions(77, r.rid, 6, 2)
        assert torch.equal(got, hr[r.rid][pos])
        assert got.untyped_storage().nbytes() == got.numel() * 4
    assert a.nbytes() == 5 * 2 * 6 * 4
    assert clients.Sampler(5, 78, 2).items() == []


def test_sampled_positions_are_seeded_and_cover_short_requests():
    assert clients.positions(9, 3, 4, 24) == [0, 1, 2, 3]
    pos = clients.positions(9, 3, 180, 24)
    assert pos == clients.positions(9, 3, 180, 24) != clients.positions(9, 4, 180, 24)
    assert len(set(pos)) == 24 and all(0 <= i < 180 for i in pos) and pos == sorted(pos)


def test_an_output_of_the_wrong_length_is_kept_as_a_failure():
    s = clients.Sampler(1, 5, 2)
    s.offer(clients.Request(rid=0, n=6, start=0), torch.zeros(5, 3, 2, 1))
    assert s.items()[0][2] is None and s.nbytes() == 0


# ----------------------------------------------------------------------
# The registry, and adding a part without editing a file
# ----------------------------------------------------------------------
def test_registry_finds_every_part_by_name():
    bench = registry.load_benchmark()
    for wl in bench["workloads"]:
        cfg = registry.config(bench, wl["config"])
        traffic.check(registry.traffic(wl["traffic"]))
        assert cfg["name"] == wl["config"]
        for trace in (False, True):
            for m in registry.metrics_for(bench, wl["name"], trace):
                assert callable(registry.reader(m["name"]))
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert callable(registry.reader(m["name"]))


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_part_of_each_kind_is_added_as_new_files_and_entries(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "bench")
    new = tmp_path / "bench"
    cfg = json.loads((new / "configs" / "abpn_x3.json").read_text())
    cfg["serving"]["precision"] = "bf16"
    (new / "configs" / "abpn_x3_bf16.json").write_text(json.dumps(cfg))
    (new / "traffic" / "vod_small.json").write_text(json.dumps(dict(VOD)))
    (new / "metrics" / "frames_per_request.py").write_text(
        "def read(run):\n    return run.sched['frames_dispatched'] / 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="abpn_x3_bf16",
                                 file="bench/configs/abpn_x3_bf16.json"))
    bench["workloads"].append(dict(name="x3_bf16_vod_small", config="abpn_x3_bf16",
                                   traffic="vod_small", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(name="frames_per_request.vod", unit="frames",
                                   better="higher", source="program_counter",
                                   layer="server and scheduler", moves="frames_per_s",
                                   workloads=["x3_bf16_vod_small"]))
    fps = next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")
    fps["workloads"].append("x3_bf16_vod_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before

    b = registry.load_benchmark(tmp_path)
    wl = registry.workload(b, "x3_bf16_vod_small")
    assert registry.config(b, wl["config"], tmp_path)["serving"]["precision"] == "bf16"
    assert registry.traffic(wl["traffic"], new)["clients"] == 3
    names = [m["name"] for m in registry.metrics_for(b, wl["name"], True)]
    assert names == ["frames_per_request.vod"]
    assert [m["name"] for m in registry.metrics_for(b, wl["name"], False)] == [
        "frames_per_s", "setup_s"]
    rec = _record("closed", [])
    assert registry.read_metrics(registry.metrics_for(b, wl["name"], True), rec, new) == {
        "frames_per_request.vod": {"value": 15.0, "unit": "frames"}}


# ----------------------------------------------------------------------
# Names, units and the benchmark's shape
# ----------------------------------------------------------------------
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_names_and_units_use_only_the_allowed_characters():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[part]:
            assert NAME.fullmatch(e["name"]), e["name"]
    for w in b["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith("bench/") and (REPO / c["file"]).is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    layers = {m["layer"] for m in b["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    for p in b["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts and f.is_file():
            assert PATH.fullmatch(str(f.relative_to(REPO))), f


# ----------------------------------------------------------------------
# What bench/ imports and reads
# ----------------------------------------------------------------------
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    for p in files:
        # top-level names compared whole: repro_torch is not repro
        assert not (_imports(p) & FORBIDDEN), p
    for p in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(p) and "harness" not in _imports(p), p


def test_top_level_names_are_compared_whole():
    import run

    assert "repro" in run.FORBIDDEN
    assert {"repro_torch.engine".split(".")[0]} & set(run.FORBIDDEN) == set()


def test_nothing_under_bench_reads_the_jax_benchmarks():
    for p in BENCH.rglob("*.py"):
        if "__pycache__" in p.parts or p.name == Path(__file__).name:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, p


def test_spans_drawn_on_the_device_timeline_are_not_device_work():
    from harness.trace import annotation

    class Ev:
        def __init__(self, name, user=False):
            self._n, self._u = name, user

        def name(self):
            return self._n

        def is_user_annotation(self):
            return self._u

    assert annotation(Ev("bench.result", user=True))
    assert annotation(Ev("a span of the program", user=True))
    assert annotation(Ev("bench.submit"))  # where the flag is missing
    assert not annotation(Ev("void tilted_fusion_kernel_onchip<float, 32, false>"))
    assert not annotation(Ev("Memcpy HtoD (Pinned -> Device)"))
