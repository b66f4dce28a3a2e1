"""Roofline-guided plan autotuner — sweep the legal schedule space, keep
the winners.

The port of the JAX package's ``engine/autotune.py``.  The schedule knobs,
the candidate space, the analytic model and the DB layout are the same;
what is measured is the port's executor on its own device:

1. **Enumerate** the legal candidate space for a (backend, lr_shape,
   precision, request batch) configuration:

   * ``band_rows`` — the nearest legal divisors of the height
     (:func:`~repro_torch.engine.plan.legal_band_rows`), but ONLY for the
     ``halo`` vertical policy, where band decomposition is bit-exact
     invariant (each band recomputes its true receptive field).  Under
     ``zero``/``replicate`` the band boundary is an approximation, so
     ``band_rows`` is part of the numerics and keeps its default.
   * ``pipeline_depth`` in ``{1..4}`` — dispatches in flight per request.
   * bucket rounding — round the batch up to a power of two vs build the
     exact batch.  Both are numerics-safe: padded frames are computed
     independently and trimmed.

2. **Score analytically first.**  :func:`predict_cost` is a pure-math
   roofline (FLOPs and bytes per frame from the plan's geometry, the halo
   recompute factor ``(R+2L)/R``, whether a band's working set fits the
   cache, the bucket's padding) against :class:`RooflinePeaks` — on the
   card, peaks calibrated on the device (:meth:`RooflinePeaks.detect`).
   Candidates predicted slower than ``prune_ratio`` (1.5x) of the best are
   pruned before they are built.  The default schedule always survives.

3. **Measure the survivors.**  Each surviving (band_rows, bucket) builds
   ONE executor over a shared :class:`~repro_torch.engine.executor.PreparedStack`
   — never touching a session's ``PlanCache`` — and each depth runs the
   bounded in-flight dispatch loop the server runs
   (:func:`measure_schedule`; on the card, each dispatch uploads pinned
   host frames asynchronously, as a served request's does, and records one
   CUDA event).
   The measurement picks the winner; ties within ``tie_tol`` go to the
   shallower pipeline and the default schedule.

4. **Persist.**  Winners land in the port's own JSON :class:`TuningDB`
   (``~/.cache/repro-sr-torch/tuning.json``; ``REPRO_SR_TORCH_TUNING_DB``
   overrides), keyed like the ``PlanCache`` plus the batch, and stamped
   with the schema version, ``torch.__version__``, ``torch.version.cuda``
   and the device's name, so an entry from another card, torch or CUDA is
   ignored, never applied.  It never reads or writes the JAX package's
   DB.  Writes are atomic (temp file + ``os.replace``) and the DB is
   bounded.

Serving consults the DB through :class:`PlanTuner`:
``SRPlan.from_request(..., tuner=)`` asks it for a measured ``band_rows``;
``SRSession.open(model, autotune="off"|"cached"|"full")`` sets the
cold-start policy; ``session.tuning_stats()`` reports hits/misses.

Pre-warm the DB offline (on the card; ``--device cpu`` for the CPU)::

    PYTHONPATH=src python -m repro_torch.engine.autotune --sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import tempfile
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.engine.plan import SRPlan, derive_band_rows, legal_band_rows

__all__ = [
    "SCHEMA_VERSION",
    "DB_ENV_VAR",
    "DEPTHS",
    "TIE_TOL",
    "default_db_path",
    "device_name",
    "TuningKey",
    "TuningEntry",
    "TuningDB",
    "RooflinePeaks",
    "predict_cost",
    "Candidate",
    "band_rows_is_tunable",
    "enumerate_candidates",
    "measure_schedule",
    "tune",
    "PlanTuner",
    "sweep",
    "main",
]

# Bump when the entry layout or the meaning of a tuned knob changes —
# loaders ignore any DB written under a different schema.
SCHEMA_VERSION = 1

DB_ENV_VAR = "REPRO_SR_TORCH_TUNING_DB"

# Tunable pipeline depths: 1 = blocking, 2 = the paper's ping-pong double
# buffering, 3-4 = deeper latency hiding (more live slabs).
DEPTHS = (1, 2, 3, 4)

# A candidate within this fraction of the measured best is a TIE — the
# simpler schedule (shallower pipeline, default band/bucket) wins it.
TIE_TOL = 0.03


def default_db_path() -> str:
    """``$REPRO_SR_TORCH_TUNING_DB`` if set, else
    ``~/.cache/repro-sr-torch/tuning.json``."""
    env = os.environ.get(DB_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-sr-torch", "tuning.json")


def device_name(device=None) -> str:
    """The name an entry is stamped with: ``torch.cuda.get_device_name`` of
    a CUDA ``device``, ``"cpu"`` for the CPU."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _device_count(device) -> int:
    device = torch.device("cpu" if device is None else device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


# ----------------------------------------------------------------------
# Keys + entries + the persistent DB
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TuningKey:
    """What a tuning decision is FOR: every plan field that is not a
    tunable knob, plus the request batch the bucket policy was tuned at."""

    backend: str
    precision: str
    vertical_policy: str
    height: int
    width: int
    channels: int
    num_layers: int
    tile_cols: int
    scale: int
    clip: bool
    batch: int  # the request batch size the sweep was run for

    @classmethod
    def from_plan(cls, plan: SRPlan, batch: int) -> "TuningKey":
        return cls(
            backend=plan.backend,
            precision=plan.precision,
            vertical_policy=plan.vertical_policy,
            height=plan.height,
            width=plan.width,
            channels=plan.in_channels,
            num_layers=plan.num_layers,
            tile_cols=plan.tile_cols,
            scale=plan.scale,
            clip=plan.clip,
            batch=int(batch),
        )

    def encode(self) -> str:
        return (
            f"{self.backend}|{self.precision}|{self.vertical_policy}"
            f"|{self.height}x{self.width}x{self.channels}"
            f"|L{self.num_layers}|T{self.tile_cols}|s{self.scale}"
            f"|clip{int(self.clip)}|b{self.batch}"
        )

    def config_encode(self) -> str:
        """The key minus the batch — the fallback grouping (a nearby
        batch's tuned schedule beats the untuned default)."""
        return self.encode().rsplit("|b", 1)[0]


@dataclasses.dataclass
class TuningEntry:
    """One tuned schedule: the winning knobs, the evidence and the validity
    stamp (torch, CUDA, the device and the topology it was measured on)."""

    band_rows: int
    pipeline_depth: int
    bucket: int
    bucket_policy: str  # "pow2" | "exact"
    predicted_ms: float  # analytic roofline ms per real frame (winner)
    measured_ms: float  # measured ms per real frame (winner)
    default_ms: float  # measured ms per real frame (default schedule)
    speedup: float  # default_ms / measured_ms (>= 1 by construction)
    torch_version: str
    cuda_version: Optional[str]  # torch.version.cuda (None on a CPU build)
    device_name: str  # torch.cuda.get_device_name, or "cpu"
    created: float  # unix seconds
    # topology: "RxS" (replicas x band shards); unsharded sessions are "1x1"
    device_count: int = 1
    mesh_shape: str = "1x1"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> Optional["TuningEntry"]:
        try:
            return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})
        except (KeyError, TypeError):
            return None  # malformed entry — treat as absent


class TuningDB:
    """The persistent winner store: one JSON file, atomic writes, bounded
    size, validity filtering on read.

    Layout::

        {"schema": 1, "entries": {"<key.encode()>": {<TuningEntry>}, ...}}

    A file written under a different ``SCHEMA_VERSION`` is ignored
    wholesale (``stale_schema`` records that it happened); an entry
    stamped with another torch version, CUDA version, device name, device
    count or mesh shape is ignored per lookup.  ``put`` keeps insertion
    order and evicts the oldest entries past ``capacity``; ``save`` writes
    a temp file in the target directory and ``os.replace``\\ s it.
    """

    def __init__(self, path: Optional[str] = None, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.path = path or default_db_path()
        self.capacity = capacity
        self.stale_schema = False
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError):
            return  # missing or torn file — start empty
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            self.stale_schema = True
            return  # another layout — never misapply its schedules
        entries = raw.get("entries")
        if isinstance(entries, dict):
            for k, v in entries.items():
                if isinstance(v, dict):
                    self._entries[k] = v

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> List[str]:
        return list(self._entries)

    def get(
        self,
        key: TuningKey,
        *,
        device=None,
        device_count: Optional[int] = None,
        mesh_shape: str = "1x1",
    ) -> Optional[TuningEntry]:
        """The valid entry for ``key`` on ``device`` (default: the CPU), or
        None: an entry stamped for another torch, CUDA, device or topology,
        or a malformed one, is invalid, not an error.  ``device_count``
        defaults to the device's (``torch.cuda.device_count()`` on a card,
        1 on the CPU)."""
        raw = self._entries.get(key.encode())
        if raw is None:
            return None
        entry = TuningEntry.from_dict(raw)
        if entry is None:
            return None
        if (entry.torch_version != torch.__version__
                or entry.cuda_version != torch.version.cuda
                or entry.device_name != device_name(device)):
            return None
        if device_count is None:
            device_count = _device_count(device)
        if entry.device_count != int(device_count) or entry.mesh_shape != mesh_shape:
            return None
        return entry

    def get_nearest_batch(
        self,
        key: TuningKey,
        *,
        device=None,
        device_count: Optional[int] = None,
        mesh_shape: str = "1x1",
    ) -> Optional[Tuple[TuningEntry, int]]:
        """The valid entry matching ``key``'s configuration at the NEAREST
        tuned batch; returns ``(entry, tuned_batch)`` or None."""
        prefix = key.config_encode() + "|b"
        best: Optional[Tuple[int, int, str]] = None
        for k in self._entries:
            if not k.startswith(prefix):
                continue
            try:
                b = int(k[len(prefix):])
            except ValueError:
                continue
            rank = (abs(b - key.batch), b)
            if best is None or rank < best[:2]:
                best = (*rank, k)
        if best is None:
            return None
        entry = self.get(
            dataclasses.replace(key, batch=best[1]),
            device=device, device_count=device_count, mesh_shape=mesh_shape,
        )
        return (entry, best[1]) if entry is not None else None

    def put(self, key: TuningKey, entry: TuningEntry) -> None:
        enc = key.encode()
        self._entries.pop(enc, None)
        self._entries[enc] = entry.to_dict()
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def save(self) -> None:
        """Atomic write: temp file next to the target + ``os.replace``."""
        payload = {"schema": SCHEMA_VERSION, "entries": dict(self._entries)}
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


# ----------------------------------------------------------------------
# The analytic roofline (scoring WITHOUT building)
# ----------------------------------------------------------------------
# Bytes of the device-to-device copy that calibrates the card's bandwidth:
# well past the 50 MB L2, so the copy streams from and to device memory.
CALIBRATION_BYTES = 256 << 20


@functools.lru_cache(maxsize=None)
def _calibrate(index: int) -> Tuple[float, float, float]:
    """``(fp32 FLOP/s, bytes/s, L2 bytes)`` of CUDA device ``index``,
    measured once per process."""
    device = torch.device("cuda", index)
    props = torch.cuda.get_device_properties(device)
    l2 = int(getattr(props, "L2_cache_size", 0) or 0)
    if l2 <= 0:
        raise RuntimeError(f"{props.name}: torch reports no L2 cache size; cannot calibrate")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        src = torch.empty(CALIBRATION_BYTES, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        dst.copy_(src)  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        copies = 10
        start.record(stream)
        for _ in range(copies):
            dst.copy_(src)
        end.record(stream)
        end.synchronize()
        copy_s = start.elapsed_time(end) / 1e3
        # the SM clock under load: torch.cuda._sleep spins for a count of
        # SM clock cycles, so cycles over its time is the clock
        cycles = 20_000_000
        torch.cuda._sleep(cycles)  # warm the clock
        start.record(stream)
        torch.cuda._sleep(cycles)
        end.record(stream)
        end.synchronize()
        sleep_s = start.elapsed_time(end) / 1e3
        del src, dst
    if copy_s <= 0 or sleep_s <= 0:
        raise RuntimeError(f"{props.name}: calibration timed {copy_s} s and {sleep_s} s")
    bytes_per_s = 2 * CALIBRATION_BYTES * copies / copy_s  # each copy reads and writes
    # fp32 on the CUDA cores: 128 FMA lanes per SM, 2 FLOP per FMA
    flops_per_s = props.multi_processor_count * 128 * 2 * (cycles / sleep_s)
    return flops_per_s, bytes_per_s, float(l2)


@dataclasses.dataclass(frozen=True)
class RooflinePeaks:
    """Peak compute/bandwidth + cache budget the predictor ranks against.

    Absolute values barely matter (candidates are compared to EACH OTHER
    and the measured pass arbitrates); the ratios set where the model
    places the compute/memory knee and when a band's working set spills.
    """

    flops_per_s: float
    hbm_bytes_per_s: float
    cache_bytes: float

    @classmethod
    def detect(cls, device=None) -> "RooflinePeaks":
        """The peaks of ``device`` (default: the CPU).

        The CPU: the JAX package's CPU figures (a few-core SIMD CPU: tens
        of GFLOP/s, tens of GB/s, ~1 MiB effective per-core L2), so
        :func:`predict_cost` ranks CPU candidates as that package does.

        A CUDA device: measured on it, once per process — the bandwidth of
        a timed 256 MiB device-to-device copy, the fp32 CUDA-core rate from
        the SM count x 128 lanes x 2 x the SM clock (timed over a spin of
        known cycles), and ``cache_bytes`` from the L2 size the device
        reports.  A card that cannot be calibrated raises.
        """
        device = torch.device("cpu" if device is None else device)
        if device.type == "cpu":
            return cls(5e10, 2e10, 1 << 20)
        if device.type != "cuda":
            raise ValueError(f"no roofline peaks for device {device}")
        index = device.index if device.index is not None else torch.cuda.current_device()
        return cls(*_calibrate(index))


def _layer_channels(layers: Sequence) -> List[Tuple[int, int]]:
    chans = []
    for l in layers:
        ci = getattr(l, "ci", None)
        co = getattr(l, "co", None)
        if ci is None or co is None:  # duck-typed stacks: fall back to w
            ci, co = int(l.w.shape[2]), int(l.w.shape[3])
        chans.append((int(ci), int(co)))
    return chans


def predict_cost(
    plan: SRPlan,
    layers: Sequence,
    bucket: int,
    real_frames: int,
    peaks: Optional[RooflinePeaks] = None,
) -> dict:
    """Analytic roofline prediction for serving ``real_frames`` frames in
    one ``bucket``-sized dispatch of ``plan`` — pure geometry, nothing is
    built (this is what prunes the candidate space).  The JAX package's
    model, unchanged.

    Per band, every fused layer computes ``rows_c`` rows (``R`` for
    zero/replicate, ``R + 2L`` for halo).  FLOPs are the 3x3 MACs over
    those rows.  Bytes charge the frame in/out and the weights always, and
    the inter-layer feature maps only when the band working set exceeds
    the cache budget.  Padded bucket slots compute like real frames, so
    the per-real-frame time scales by ``bucket/real_frames``.  ``peaks``
    defaults to the CPU's (:meth:`RooflinePeaks.detect`).
    """
    if peaks is None:
        peaks = RooflinePeaks.detect()
    chans = _layer_channels(layers)
    H, W = plan.height, plan.width
    R, L, B = plan.band_rows, plan.num_layers, plan.num_bands
    rows_c = R + 2 * L if plan.vertical_policy == "halo" else R
    dsize = 2 if plan.precision == "bf16" else 4
    max_ch = max(max(ci, co) for ci, co in chans)

    flops = B * sum(2 * 9 * rows_c * W * ci * co for ci, co in chans)
    # epilogue: anchor add + pixel shuffle over the HR frame
    flops += 4 * H * W * plan.in_channels * plan.scale ** 2

    weight_bytes = sum(9 * ci * co * dsize for ci, co in chans)
    io_bytes = (H * W * plan.in_channels * 4
                + H * W * plan.in_channels * plan.scale ** 2 * 4)
    hbm = io_bytes + weight_bytes
    working_set = rows_c * W * max_ch * dsize
    if working_set > peaks.cache_bytes:
        # the band no longer fits on chip: every fused layer's feature map
        # round-trips memory
        hbm += B * sum(2 * rows_c * W * co * dsize for _, co in chans)

    frame_s = max(flops / peaks.flops_per_s, hbm / peaks.hbm_bytes_per_s)
    ms_per_frame = frame_s * 1e3 * bucket / max(real_frames, 1)
    return {
        "flops_per_frame": int(flops),
        "hbm_bytes_per_frame": int(hbm),
        "working_set_bytes": int(working_set),
        "ms_per_frame": float(ms_per_frame),
    }


# ----------------------------------------------------------------------
# Candidate space + measurement
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Candidate:
    """One point of the schedule space, carrying its scores through the
    sweep."""

    band_rows: int
    bucket: int
    pipeline_depth: int
    is_default: bool = False
    predicted_ms: float = math.nan
    measured_ms: float = math.nan
    pruned: bool = False


def band_rows_is_tunable(plan: SRPlan) -> bool:
    """Whether ``band_rows`` may differ from the default WITHOUT changing
    numerics: only the ``halo`` policy recomputes each band's true
    receptive field (bit-exact for any legal decomposition); zero/replicate
    band boundaries are approximations, so their band height is part of
    the numerics, not the schedule."""
    return plan.vertical_policy == "halo"


def _pow2_bucket(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def enumerate_candidates(
    plan: SRPlan,
    batch: int,
    *,
    depths: Sequence[int] = DEPTHS,
    max_band_candidates: int = 4,
) -> List[Candidate]:
    """The legal candidate grid for one configuration.

    ``band_rows`` spans the nearest ``max_band_candidates`` legal
    decompositions (halo plans only — see :func:`band_rows_is_tunable`);
    the bucket axis is the two rounding policies (power-of-two vs exact);
    depth spans ``depths``.  Exactly one candidate ``is_default`` — the
    schedule the untuned constants run (default band, pow2 bucket, depth
    2) — and it is never pruned.
    """
    default_band = derive_band_rows(plan.height)
    if band_rows_is_tunable(plan):
        bands = legal_band_rows(plan.height)[:max_band_candidates]
        if default_band not in bands:
            bands.append(default_band)
    else:
        bands = [plan.band_rows]  # pinned: numerics, not schedule
    pow2 = _pow2_bucket(batch)
    buckets = sorted({pow2, int(batch)})
    default_depth = 2  # SRSession's constructor default
    depths = sorted(set(int(d) for d in depths))
    if default_depth not in depths:
        depths.append(default_depth)
    out = []
    for band in bands:
        for bucket in buckets:
            for depth in depths:
                out.append(Candidate(
                    band_rows=band,
                    bucket=bucket,
                    pipeline_depth=depth,
                    is_default=(band == (default_band
                                         if band_rows_is_tunable(plan)
                                         else plan.band_rows)
                                and bucket == pow2
                                and depth == default_depth),
                ))
    return out


def measure_schedule(fn, chunks: Sequence[torch.Tensor], depth: int, reps: int = 2,
                     *, device=None) -> float:
    """Wall-clock seconds to serve ``chunks`` through executor ``fn`` with
    at most ``depth`` dispatches in flight — the bounded dispatch loop the
    server's drain runs, minus the locking.  Minimum over ``reps``.

    ``chunks`` are host frames, as a client sends them.  With ``device`` a
    CUDA device each dispatch uploads its chunk as the server's launch does
    (asynchronously, so pass pinned chunks), runs ``fn`` and records an
    event on the current stream (the one the session launches on); the
    loop waits on the oldest event once ``depth`` are in flight, and there
    is no device-wide synchronize.  The warm-up call — with the kernel's
    first build, if it has not happened — runs before the timed window."""
    on_card = device is not None and torch.device(device).type == "cuda"

    def dispatch(chunk):
        if not on_card:
            return fn(chunk)  # the CPU computes eagerly: the result is ready
        fn(chunk.to(device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return event

    def wait(marker):
        if on_card:
            marker.synchronize()

    wait(dispatch(chunks[0]))  # warm (builds outside the timing)
    best = math.inf
    for _ in range(max(int(reps), 1)):
        inflight = deque()
        t0 = time.perf_counter()
        for chunk in chunks:
            if len(inflight) >= depth:
                wait(inflight.popleft())
            inflight.append(dispatch(chunk))
        while inflight:
            wait(inflight.popleft())
        best = min(best, time.perf_counter() - t0)
    return best


def _host_frames(arr: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    frames = torch.from_numpy(arr).to(dtype)
    return frames.pin_memory() if device.type == "cuda" else frames


def _preference(c: Candidate, plan: SRPlan, batch: int) -> tuple:
    """Tie-break rank among measured near-equals: shallower pipeline,
    then the default band, then the pow2 bucket."""
    return (
        c.pipeline_depth,
        0 if c.band_rows == derive_band_rows(plan.height) else 1,
        0 if c.bucket == _pow2_bucket(batch) else 1,
    )


def tune(
    layers: Sequence,
    plan: SRPlan,
    batch: int,
    dtype=torch.float32,
    *,
    db: Optional[TuningDB] = None,
    depths: Sequence[int] = DEPTHS,
    max_band_candidates: int = 4,
    prune_ratio: float = 1.5,
    chunks: int = 3,
    reps: int = 2,
    peaks: Optional[RooflinePeaks] = None,
    measure_all: bool = False,
    tie_tol: float = TIE_TOL,
    seed: int = 0,
) -> TuningEntry:
    """Sweep the legal schedule space for ``(plan, batch)`` on the device
    ``layers`` live on; return — and persist, when ``db`` is given — the
    measured-best schedule.

    ``plan`` is the DEFAULT-derived plan for the configuration.  The sweep
    enumerates candidates, prunes on the analytic roofline at
    ``prune_ratio`` (the default candidate is exempt), builds each
    surviving (band_rows, bucket) ONCE over a shared prepared stack,
    measures every surviving depth with :func:`measure_schedule` on a
    ``chunks``-dispatch synthetic clip (seeded numpy frames), and picks the
    minimum (ties within ``tie_tol`` go to the simpler schedule; the
    winner never measures worse than the default).  ``peaks`` defaults to
    :meth:`RooflinePeaks.detect` of the device.  ``measure_all=True`` skips
    pruning.  The returned entry carries the sweep as ``.candidates``.
    """
    from repro_torch.engine.executor import build_stack_executor, prepare_stack

    batch = int(batch)
    if batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    device = layers[0].w.device
    if peaks is None:
        peaks = RooflinePeaks.detect(device)
    cands = enumerate_candidates(
        plan, batch, depths=depths, max_band_candidates=max_band_candidates
    )

    # --- analytic pass: score every candidate, prune the hopeless -------
    pred_cache: Dict[Tuple[int, int], float] = {}
    for c in cands:
        pk = (c.band_rows, c.bucket)
        if pk not in pred_cache:
            p = dataclasses.replace(plan, band_rows=c.band_rows)
            pred_cache[pk] = predict_cost(p, layers, c.bucket, batch, peaks)["ms_per_frame"]
        c.predicted_ms = pred_cache[pk]
    best_pred = min(c.predicted_ms for c in cands)
    if not measure_all:
        for c in cands:
            if not c.is_default and c.predicted_ms > prune_ratio * best_pred:
                c.pruned = True
    survivors = [c for c in cands if not c.pruned]

    # --- measured pass: one executor per (band, bucket), one stack total -
    stack = prepare_stack(plan, layers)  # numerics/packing: band-invariant
    rng = np.random.default_rng(seed)
    frames_cache: Dict[int, list] = {}
    fn_cache: Dict[Tuple[int, int], object] = {}
    for c in survivors:
        fk = (c.band_rows, c.bucket)
        if fk not in fn_cache:
            p = dataclasses.replace(plan, band_rows=c.band_rows)
            # own executor, never entered into any PlanCache
            fn_cache[fk] = build_stack_executor(p, stack)
        if c.bucket not in frames_cache:
            # host frames, pinned on the card as the server pins a request
            frames_cache[c.bucket] = [
                _host_frames(rng.random((c.bucket, *plan.lr_shape), np.float32), dtype, device)
                for _ in range(max(int(chunks), 1))
            ]
        t = measure_schedule(fn_cache[fk], frames_cache[c.bucket], c.pipeline_depth, reps=reps,
                             device=device)
        c.measured_ms = t * 1e3 / (len(frames_cache[c.bucket]) * batch)

    best_ms = min(c.measured_ms for c in survivors)
    default = next(c for c in survivors if c.is_default)
    # ties within tie_tol of the best go to the simpler schedule — but a
    # tie-broken winner must never measure WORSE than the default
    contenders = [c for c in survivors
                  if c.measured_ms <= best_ms * (1 + tie_tol)
                  and c.measured_ms <= default.measured_ms] or [default]
    winner = min(contenders, key=lambda c: _preference(c, plan, batch))

    entry = TuningEntry(
        band_rows=winner.band_rows,
        pipeline_depth=winner.pipeline_depth,
        bucket=winner.bucket,
        bucket_policy="exact" if winner.bucket == batch != _pow2_bucket(batch) else "pow2",
        predicted_ms=round(winner.predicted_ms, 6),
        measured_ms=round(winner.measured_ms, 6),
        default_ms=round(default.measured_ms, 6),
        speedup=round(default.measured_ms / max(winner.measured_ms, 1e-12), 4),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        device_name=device_name(device),
        created=time.time(),
        # tune() measures the single-device executor
        device_count=_device_count(device),
        mesh_shape="1x1",
    )
    if db is not None:
        db.put(TuningKey.from_plan(plan, batch), entry)
        db.save()
    entry.candidates = cands  # type: ignore[attr-defined]
    return entry


# ----------------------------------------------------------------------
# The serving-side consumer
# ----------------------------------------------------------------------
class PlanTuner:
    """The serving stack's view of the tuning DB.

    ``SRPlan.from_request(..., tuner=)`` and ``SRSession`` consult it; it
    answers from the DB only (never measures — measurement is :func:`tune`,
    run by ``autotune="full"`` sessions or the offline ``--sweep``).  Every
    answer is vetted: an entry must be stamped for ``device`` (the
    consumer's; default the CPU) and topology, and a ``band_rows`` override
    must divide the height and may only move on a ``halo`` plan.
    """

    def __init__(self, db: Optional[TuningDB] = None,
                 path: Optional[str] = None, *,
                 device=None,
                 device_count: Optional[int] = None,
                 mesh_shape: str = "1x1"):
        self.db = db if db is not None else TuningDB(path)
        self.device = device
        self.device_count = device_count
        self.mesh_shape = mesh_shape

    def lookup(self, key: TuningKey) -> Tuple[Optional[TuningEntry], str]:
        """``(entry, kind)`` where kind is ``"hit"`` (exact batch),
        ``"fallback"`` (same config, nearest tuned batch) or ``"miss"``."""
        stamp = {"device": self.device, "device_count": self.device_count,
                 "mesh_shape": self.mesh_shape}
        entry = self.db.get(key, **stamp)
        if entry is not None and self._safe(key, entry):
            return entry, "hit"
        near = self.db.get_nearest_batch(key, **stamp)
        if near is not None and self._safe(key, near[0]):
            return near[0], "fallback"
        return None, "miss"

    def _safe(self, key: TuningKey, entry: TuningEntry) -> bool:
        if key.height % entry.band_rows != 0:
            return False  # stale geometry
        if entry.band_rows != derive_band_rows(key.height):
            # moving band_rows off the default is only numerics-safe
            # under halo (see band_rows_is_tunable)
            return key.vertical_policy == "halo"
        return True

    def band_rows_for(
        self,
        *,
        lr_shape: Tuple[int, int, int],
        num_layers: int,
        tile_cols: int = 8,
        vertical_policy: str = "zero",
        backend: str = "tilted",
        precision: str = "fp32",
        scale: int = 3,
        clip: bool = True,
        bucket: Optional[int] = None,
    ) -> Optional[int]:
        """The measured-best ``band_rows`` for a request configuration, or
        None (fall back to the default derivation).  This is the hook
        ``SRPlan.from_request(..., tuner=)`` calls."""
        H, W, C = (int(x) for x in lr_shape)
        key = TuningKey(
            backend=backend, precision=precision,
            vertical_policy=vertical_policy, height=H, width=W, channels=C,
            num_layers=int(num_layers), tile_cols=int(tile_cols),
            scale=int(scale), clip=bool(clip),
            batch=int(bucket) if bucket else 1,
        )
        entry, _ = self.lookup(key)
        return entry.band_rows if entry is not None else None


# ----------------------------------------------------------------------
# Offline pre-warm CLI
# ----------------------------------------------------------------------
def sweep(
    *,
    db: TuningDB,
    model: str = "abpn_x3",
    backends: Sequence[str] = ("tilted",),
    precisions: Sequence[str] = ("fp32",),
    policies: Sequence[str] = ("zero",),
    heights: Sequence[int] = (120,),
    widths: Sequence[int] = (64,),
    batches: Sequence[int] = (1, 3, 4, 8),
    seed: int = 0,
    device=None,
    **tune_kwargs,
) -> List[Tuple[TuningKey, TuningEntry]]:
    """Tune every configuration in the cross product on ``device`` (default:
    the CUDA card; raises without one unless ``device="cpu"``) and persist
    the winners — the offline DB pre-warm behind ``--sweep``."""
    from repro_torch.engine.executor import default_device
    from repro_torch.models.registry import get_sr_model

    dev = default_device(device)
    spec = get_sr_model(model)
    layers = [l.to(device=dev) for l in spec.init(torch.Generator().manual_seed(int(seed)))]
    out = []
    for backend in backends:
        for precision in precisions:
            for policy in policies:
                for h in heights:
                    for w in widths:
                        plan = SRPlan.from_request(
                            (h, w, spec.config.in_channels),
                            num_layers=len(layers),
                            vertical_policy=policy,
                            backend=backend,
                            precision=precision,
                            scale=spec.config.scale,
                        )
                        for b in batches:
                            entry = tune(layers, plan, b, db=db, **tune_kwargs)
                            out.append((TuningKey.from_plan(plan, b), entry))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Pre-warm the port's plan tuning DB offline "
                    "(python -m repro_torch.engine.autotune --sweep)"
    )
    ap.add_argument("--sweep", action="store_true",
                    help="run the tuning sweep and persist winners")
    ap.add_argument("--db", default=None,
                    help=f"tuning DB path (default: ${DB_ENV_VAR} or "
                         "~/.cache/repro-sr-torch/tuning.json)")
    ap.add_argument("--device", default=None,
                    help="device to tune on (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--model", default="abpn_x3")
    ap.add_argument("--backends", nargs="+", default=["tilted"],
                    choices=["reference", "tilted", "kernel"])
    ap.add_argument("--precisions", nargs="+", default=["fp32"],
                    choices=["fp32", "bf16", "int8"])
    ap.add_argument("--policies", nargs="+", default=["zero"],
                    choices=["zero", "halo", "replicate"])
    ap.add_argument("--heights", type=int, nargs="+", default=[120])
    ap.add_argument("--widths", type=int, nargs="+", default=[64])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 3, 4, 8])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes + shallow grid (CI smoke)")
    args = ap.parse_args(argv)

    if not args.sweep:
        ap.error("nothing to do: pass --sweep to run the tuning sweep")
    db = TuningDB(args.db)
    kw = dict(backends=args.backends, precisions=args.precisions,
              policies=args.policies, heights=args.heights,
              widths=args.widths, batches=args.batches,
              reps=args.reps, chunks=args.chunks)
    if args.quick:
        kw.update(heights=[24], widths=[16], batches=[1, 3], reps=1, chunks=2)
    t0 = time.perf_counter()
    results = sweep(db=db, model=args.model, device=args.device, **kw)
    for key, e in results:
        print(f"{key.encode()}: band_rows={e.band_rows} "
              f"depth={e.pipeline_depth} bucket={e.bucket} "
              f"({e.bucket_policy}) measured {e.measured_ms:.2f} ms/frame "
              f"(default {e.default_ms:.2f}, x{e.speedup:.3f}) on {e.device_name}")
    print(f"wrote {len(results)} entries -> {db.path} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
