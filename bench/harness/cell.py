"""One run of one cell: set-up, the measured window, the check, the record
the metric readers read.

Set-up makes the configuration's model family (``registry.family``) draw
its weights from the seed and open the port's ``SRServer`` on them, builds
and warms an executor for every bucket the traffic can form (powers of two
up to the traffic's ``warm_max_bucket``), and runs the same traffic, on
other frames, for ``warm_seconds``: that fills the host allocator's pinned
blocks as the window will use them.  Then the window runs; with ``trace`` the
profiler records it, the benchmark's calls into the server carry spans and
a poller reads the scheduler's log of formed dispatches.  After the window
the peak device memory is read (less the copies of HR frames the sample
keeps for the check), the program's state is freed, and the sampled HR
frames are compared with the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from harness import check, clients, inputs, peaks, registry
from harness import traffic as traffic_mod
from harness.trace import Profiler, Trace

SCHED_KEYS = ("dispatches", "coalesced_dispatches", "frames_dispatched", "slots_dispatched",
              "submitted_requests", "submitted_frames", "rejected", "expired", "shed")


@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader (``bench/metrics/*.py``) may read."""

    cell: dict
    config: dict
    traffic: dict
    traced: bool
    setup_s: float
    window: clients.Window
    sched: Dict[str, int]  # scheduler counters moved over the window
    session: dict  # the session's serving stats, reset at the window's start
    k1_launches: int  # tilted_fusion_call.launches moved over the window
    window_builds: int  # executors built inside the window (0 when warm-up covered it)
    family: ModuleType  # the configuration's model family (registry.family)
    trace: Optional[Trace] = None
    buckets: Optional[List[int]] = None  # every dispatch's bucket (traced runs)
    k1_executed_flops: Optional[Dict[int, int]] = None  # per bucket, the program's count
    sampled: Optional[List[Tuple[clients.Request, List[int]]]] = None  # compared frames
    setup_stages: Optional[Dict[str, float]] = None  # seconds from the process's start

    @property
    def precision(self) -> str:
        return self.config["serving"]["precision"]

    @property
    def flops_per_frame(self) -> int:
        return self.family.flops_per_frame(self.config)

    @property
    def peak_flops(self) -> float:
        return peaks.flops(self.precision)

    @property
    def frames_done(self) -> int:
        return sum(r.n for r in self.window.requests if r.ok)


class DispatchLog:
    """Polls the scheduler's bounded log of formed dispatches and keeps the
    bucket of each one formed since :meth:`start`; ``buckets`` is ``None``
    where more were formed between two polls than the log holds."""

    def __init__(self, server, every_s: float = 0.1):
        self._server, self._every = server, every_s
        self._stop = threading.Event()
        self.buckets: Optional[List[int]] = []
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _poll(self) -> None:
        st = self._server.scheduler_stats()
        new = st["dispatches"] - self._seen
        if new > len(st["recent_dispatches"]) and new > 0:
            self.buckets = None
        elif new > 0 and self.buckets is not None:
            self.buckets += [d["bucket"] for d in st["recent_dispatches"][-new:]]
        self._seen = st["dispatches"]

    def _run(self) -> None:
        while not self._stop.wait(self._every):
            self._poll()

    def start(self) -> None:
        self._seen = self._server.scheduler_stats()["dispatches"]
        self._thread.start()

    def stop(self) -> Optional[List[int]]:
        self._stop.set()
        self._thread.join()
        self._poll()
        return self.buckets


def warm(server, cfg: dict, tr: dict, pool, seed: int, mark=None) -> None:
    session = server.session()
    plan = session.plan_for(inputs.lr_shape(cfg))
    bucket = 1
    while bucket <= int(tr["warm_max_bucket"]):
        session.executor_for(plan, bucket, torch.float32)
        bucket *= 2
    if mark is not None:
        mark("executors")
    if float(tr.get("warm_seconds", 0)) > 0:
        clients.drive(server, pool, tr, seed, float(tr["warm_seconds"]),
                     clients.Sampler(0, seed), warm=True)
    server.flush()


def _sched(server) -> Dict[str, int]:
    st = server.scheduler_stats()
    return {k: int(st[k]) for k in SCHED_KEYS}


def run(cell: dict, cfg: dict, tr: dict, seed: int, seconds: float, traced: bool,
        device, t_start: float, backend: Optional[str] = None,
        bench_dir: Path = registry.BENCH) -> Tuple[RunRecord, dict, int]:
    """One run; returns the record, the check and the peak device bytes.
    ``t_start`` is when the process started (``time.time()`` seconds);
    ``backend`` overrides the configuration's (a CPU test's ``tilted``);
    ``bench_dir`` is where the model family's file is found."""
    from repro_torch.kernels.tilted_fusion import tilted_fusion_call

    stages: Dict[str, float] = {}

    def mark(stage: str) -> None:
        stages[stage] = time.time() - t_start

    mark("imports_and_cuda")
    traffic_mod.check(tr)
    device = torch.device(device)
    family = registry.family(cfg, bench_dir)
    pool = inputs.make_pool(cfg, int(tr["pool_frames"]), seed)
    weights = family.make_weights(cfg, seed, device)
    mark("inputs")
    server = family.open_server(cfg, weights, device, backend)
    del weights
    session = server.session()
    mark("server_open")
    warm(server, cfg, tr, pool, seed, mark)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mark("warm_traffic")

    sampler = clients.Sampler(int(tr["sample_requests"]), seed, int(tr["sample_frames"]))
    peak_warm = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prof = log = None
    span = None
    if traced:
        from torch.profiler import record_function

        prof, log, span = Profiler(), DispatchLog(server), record_function
        prof.start()
    session.reset_stats()
    before, launches = _sched(server), tilted_fusion_call.launches
    misses = session.cache_stats()["misses"]
    setup_s = time.time() - t_start
    if log is not None:
        log.start()
    window = clients.drive(server, pool, tr, seed, seconds, sampler, span=span)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    buckets = log.stop() if log is not None else None
    trace = prof.stop(window.t0, window.t1) if prof is not None else None
    after = _sched(server)
    record = RunRecord(
        cell=cell, config=cfg, traffic=tr, traced=traced, setup_s=setup_s, window=window,
        sched={k: after[k] - before[k] for k in SCHED_KEYS}, session=dict(session.stats()),
        k1_launches=tilted_fusion_call.launches - launches,
        window_builds=session.cache_stats()["misses"] - misses, family=family, trace=trace,
        buckets=buckets, setup_stages=stages)
    # the peak of serving: the sample's kept frames are the check's, not the
    # server's, and are held from the window's first requests to its end
    peak = 0
    if device.type == "cuda":
        peak = max(peak_warm, torch.cuda.max_memory_allocated(device) - sampler.nbytes())
    if traced and buckets and hasattr(family, "executed_flops"):
        record.k1_executed_flops = family.executed_flops(session, cfg, set(buckets), device)

    # the program's state goes before the reference runs; the sample stays
    server.close()
    del server, session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = sampler.items()
    record.sampled = [(req, pos) for req, pos, _ in sample]
    result = check.compare(sample, cfg, family, int(tr["pool_frames"]), seed, device)
    failed = sum(1 for r in window.requests if not r.ok)
    sampler.clear()
    del sample
    return record, check.checks(result, failed, float(cfg["limits"]["max_abs_err"])), peak
