"""Find the benchmark's parts by name: cells, configurations, model
families, traffic mixes and metric readers.

``BENCHMARK.json`` at the root of the checkout names every part; each part
lives in a file of its own under ``bench/``:

* a configuration: the file its entry names (``bench/configs/<name>.json``);
* a model family: ``bench/families/<family>.py``, where ``<family>`` is the
  configuration's ``family`` key (``abpn``).  The module defines
  ``make_weights(cfg, seed, device)`` (the benchmark's weights from the
  seed, in whatever structure the family needs: the harness never looks
  inside them), ``open_server(cfg, weights, device, backend=None)`` (the
  port's ``SRServer`` on them), ``reference(lr, weights, cfg,
  precision="fp32")`` and ``exact()`` (the HR frames from the family's plain
  reference, ``bench/reference/<family>.py``, in fp32 or in the precision
  the correctness control computes in, and the context that keeps fp32
  exact), ``flops_per_frame(cfg)`` (the model's own work on one LR frame)
  and, optionally, ``executed_flops(session, cfg, buckets, device)`` (the
  program's count for one dispatch of each bucket; a traced run reads it
  only where the family defines it);
* a traffic mix: ``bench/traffic/<name>.json``, read by the one general
  generator in :mod:`harness.traffic`;
* a metric: ``bench/metrics/<name>.py`` if that file exists, else
  ``bench/metrics/<stem>.py`` where ``<stem>`` is the name up to its first
  dot (``k1_roofline.vod`` -> ``k1_roofline.py``).  The module defines
  ``read(run)``, which returns a number or ``None`` where the run holds
  nothing to read.

Adding a part is adding its file and its entry; no file here changes.  A
new model family is its configuration file (with ``family``), its
``families/<family>.py`` and ``reference/<family>.py``, the configuration's
entry and its cells in ``BENCHMARK.json``, and per-layer entries that reuse
a reader by its stem (``mfu.<cell>``) or bring a reader of their own.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parents[1]  # bench/
REPO = BENCH.parent


def load_benchmark(repo: Path = REPO) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json "
                   f"(have {sorted(e['name'] for e in entries)})")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, repo: Path = REPO) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(Path(repo) / entry["file"]) as f:
        cfg = json.load(f)
    cfg.setdefault("name", name)
    return cfg


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{name}.json") as f:
        tr = json.load(f)
    tr.setdefault("name", name)
    return tr


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists, else (a per-layer metric) every cell that reports the end-to-end
    metric it ``moves``, else (an end-to-end metric) every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return reports(_named(bench["end_to_end"], metric["moves"], "end-to-end metric"),
                       cell, bench)
    return True


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics, or with
    ``trace`` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"] if reports(m, cell, bench)]


def _load(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(cfg: dict, bench_dir: Path = BENCH) -> ModuleType:
    """The module of the configuration's model family."""
    path = Path(bench_dir) / "families" / f"{cfg['family']}.py"
    if not path.exists():
        raise KeyError(f"no model family {cfg['family']!r}: {path} does not exist")
    return _load(path, "bench_family")


def reader(name: str, bench_dir: Path = BENCH) -> Callable:
    """The ``read(run)`` function of metric ``name``."""
    metrics = Path(bench_dir) / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise KeyError(f"no reader for metric {name!r} under {metrics}")
    return _load(path, "bench_metric").read


def read_metrics(entries: List[dict], run, bench_dir: Path = BENCH) -> dict:
    """``{name: {"value", "unit"}}`` for every entry whose reader finds a
    number; a reader that returns ``None`` leaves its metric out."""
    out = {}
    for m in entries:
        value: Optional[float] = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
