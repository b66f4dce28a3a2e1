"""SRSession — shape/batch/model-agnostic serving over an executor cache.

* ``SRSession.open("abpn_x3", backend=..., precision=...)`` resolves the
  model's config + weights through ``repro_torch.models.registry``.  A
  staged model (``core.stages.StagedModel``: ``"rlfn_x4"``) serves through
  the same entry points and plans; the delta path, mesh serving and the
  tuning DB take a ``ConvLayer`` chain only.
* ``session.upscale(frames)`` accepts ``(H, W, C)``, ``(T, H, W, C)`` or
  ``(B, T, H, W, C)`` input.  Per new resolution it derives the
  :class:`~repro_torch.engine.plan.SRPlan` (including a legal
  ``band_rows`` — ``SRPlan.from_request``), buckets the flattened batch up
  to a power of two, and builds one executor per ``(plan, bucket, dtype)``
  on demand, warmed on a zero dummy (the first launch also builds the CUDA
  kernel) — the warm-up time is the entry's ``compile_s``.
* Executors live in an LRU :class:`PlanCache`; weights are prepared ONCE
  per ``(precision, backend)`` into a device-resident
  :class:`~repro_torch.engine.executor.PreparedStack`, refcounted across
  cache entries.
* ``submit``/``upscale`` route through an :class:`SRServer` (the hosting
  one, or an embedded single-model server), which pipelines up to
  ``pipeline_depth`` dispatches per session.
* Temporal delta serving (``engine.temporal``) dispatches band subsets
  through :meth:`SRSession.band_executor_for` and keeps the HR bands it
  can splice again in the session's :meth:`SRSession.output_cache`.
* Schedules come from the tuning DB (``engine.autotune``):
  ``autotune="cached"`` (the default) applies a measured winner for the
  request's (shape, batch) and never measures; ``"full"`` tunes on a miss;
  ``"off"`` never reads the DB (:meth:`SRSession.tuning_stats`).
  ``strict=True`` verifies every derived plan (``analysis.plan_check``)
  before anything is built.
* ``mesh=(R, S)`` (or a ``launch.mesh.SRMesh``) serves band-sharded over
  ``R`` replicas of ``S`` mesh positions (``engine.sharding``): plans are
  re-banded until their bands split over ``S``, and each dispatch is
  routed to a replica (``route="least_loaded"`` or ``"round_robin"``;
  :meth:`SRSession.sharding_stats`).

The session runs on ``device`` — the CUDA card unless the caller passes
``device="cpu"``; with no ``device`` and no CUDA, construction raises.  A
mesh session's device is its replica 0's first position.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.stages import StagedModel
from repro_torch.engine.executor import (
    PreparedStack,
    build_band_executor,
    build_stack_executor,
    default_device,
    output_spec,
    prepare_stack,
)
from repro_torch.engine.plan import (
    PREFERRED_BAND_ROWS,
    SRPlan,
    check_layer_channels,
)
from repro_torch.engine.spans import StageClock

__all__ = [
    "SRSession",
    "PlanCache",
    "StreamStats",
    "bucket_batch",
    "latency_stats",
    "AUTOTUNE_MODES",
]

# Cold-start schedule policy (SRSession.open(..., autotune=...)):
#   "off"    — hard-coded defaults only; the tuning DB is never read.
#   "cached" — consult the DB per new (shape, batch); a hit applies the
#              measured-best schedule, a miss falls back to the defaults.
#              NEVER measures in the serving path (the default).
#   "full"   — like "cached", but a miss runs a small tuning sweep NOW
#              (blocking, on the submitting thread) and persists the winner.
AUTOTUNE_MODES = ("off", "cached", "full")

# numpy/torch dtypes a request may carry, canonicalised the way the JAX
# package serves them (no 64-bit types)
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.complex128: torch.complex64,
}


# the device stages whose milliseconds and frames SRSession.stats() reports
# (esa: a staged model's whole-frame stages, RLFN's)
STAGES = ("upload", "marshal", "k1", "esa", "epilogue", "join")


class StreamStats(dict):
    """Latency/throughput summary: frames, batches, fps, dispatch/complete
    p50/p95/p99/mean ms."""


def latency_stats(
    lat_ms: Sequence[float],
    frames: int,
    *,
    dispatch_ms: Optional[Sequence[float]] = None,
    total_s: Optional[float] = None,
    **extra,
) -> StreamStats:
    """Summarise recorded per-call latencies (warm-up never included).

    ``lat_ms`` are COMPLETE latencies (dispatch -> result ready);
    ``dispatch_ms`` are enqueue times; ``total_s`` is the serving wall-clock
    span, so with pipelining fps is frames over the SPAN.
    """
    lat = np.asarray(lat_ms, dtype=np.float64)
    disp = lat if dispatch_ms is None else np.asarray(dispatch_ms, np.float64)
    if lat.size == 0:
        return StreamStats(
            frames=0, batches=0, fps=0.0,
            p50_ms=0.0, p95_ms=0.0, p99_ms=0.0, mean_ms=0.0,
            dispatch_p50_ms=0.0, dispatch_p99_ms=0.0, dispatch_mean_ms=0.0,
            **extra,
        )
    total = lat.sum() / 1e3 if total_s is None else float(total_s)
    if disp.size == 0:
        d50 = d99 = dmean = 0.0
    else:
        d50 = float(np.percentile(disp, 50))
        d99 = float(np.percentile(disp, 99))
        dmean = float(disp.mean())
    return StreamStats(
        frames=frames,
        batches=int(lat.size),
        fps=frames / total if total > 0 else 0.0,
        p50_ms=float(np.percentile(lat, 50)),
        p95_ms=float(np.percentile(lat, 95)),
        p99_ms=float(np.percentile(lat, 99)),
        mean_ms=float(lat.mean()),
        dispatch_p50_ms=d50,
        dispatch_p99_ms=d99,
        dispatch_mean_ms=dmean,
        **extra,
    )


def bucket_batch(n: int) -> int:
    """Round a batch size up to the next power of two (at most
    ``log2(max batch)`` executors per plan, at most 2x padding)."""
    if n < 1:
        raise ValueError(f"batch size {n} must be >= 1")
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _CacheEntry:
    """A warmed executor plus the key facts ``cache_stats`` reports."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    plan: SRPlan
    bucket: int
    dtype: str
    compile_s: float
    stack_key: tuple = ()
    donates: bool = False
    # replica index when a ReplicaRouter built the entry (mesh serving)
    replica: Optional[int] = None


class PlanCache:
    """LRU cache of warmed executors keyed by ``(plan, bucket, dtype)``.

    ``get`` counts a hit (and refreshes recency) or a miss; ``put`` evicts
    the least-recently-used entry past ``capacity``.  ``on_evict(key,
    entry)`` fires for every evicted entry (including :meth:`clear`).
    """

    def __init__(self, capacity: int = 8, on_evict: Optional[Callable] = None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self.on_evict = on_evict
        self._entries: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Optional[_CacheEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def _evict_oldest(self) -> None:
        k, e = self._entries.popitem(last=False)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(k, e)

    def put(self, key, entry: _CacheEntry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._evict_oldest()

    def clear(self) -> None:
        """Evict every entry (counted, ``on_evict`` fired per entry)."""
        while self._entries:
            self._evict_oldest()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:  # does not touch the counters
        return key in self._entries

    def keys(self) -> List[tuple]:
        """Keys in LRU -> MRU order (eviction order)."""
        return list(self._entries)

    def entries(self) -> List[_CacheEntry]:
        """Entries in LRU -> MRU order."""
        return list(self._entries.values())

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self._entries),
            "capacity": self.capacity,
            "hit_rate": self.hits / total if total else 0.0,
        }


@dataclasses.dataclass
class _StackRecord:
    """A refcounted device-resident PreparedStack shared by cache entries."""

    stack: PreparedStack
    refs: int
    prepare_s: float


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SRSession:
    """One serving endpoint: fixed weights + policy, any request shape.

    Construct from a layer stack (the port's ``ConvLayer``\\ s — see
    ``models.abpn.layers_from_numpy`` — or a ``core.stages.StagedModel``),
    via :meth:`open` (model name -> weights through the registry), or via
    :meth:`from_plan` (pin a plan).
    """

    def __init__(
        self,
        layers,
        *,
        backend: str = "tilted",
        precision: str = "fp32",
        vertical_policy: str = "zero",
        tile_cols: int = 8,
        band_rows: Optional[int] = None,
        preferred_band_rows: int = PREFERRED_BAND_ROWS,
        scale: int = 3,
        clip: bool = True,
        cache_capacity: int = 8,
        max_bucket: Optional[int] = None,
        model: Optional[str] = None,
        pipeline_depth: Optional[int] = None,
        donate_frames: Optional[bool] = None,
        autotune: str = "cached",
        tuner=None,
        tuning_db: Optional[str] = None,
        strict: bool = False,
        mesh=None,
        route: str = "least_loaded",
        device=None,
    ):
        staged = layers if isinstance(layers, StagedModel) else None
        if staged is not None:
            if mesh is not None:
                raise ValueError("a staged model serves on one device, not on a mesh")
            layers = staged.conv_layers
        layers = tuple(layers)
        if not layers:
            raise ValueError("layer stack is empty")
        if max_bucket is not None and max_bucket < 1:
            raise ValueError(f"max_bucket={max_bucket} must be >= 1")
        if pipeline_depth is not None and pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth={pipeline_depth} must be >= 1 "
                "(1 = blocking, 2 = double-buffered dispatch)"
            )
        if autotune not in AUTOTUNE_MODES:
            raise ValueError(f"autotune {autotune!r} not in {AUTOTUNE_MODES}")
        if cache_capacity < 1:
            raise ValueError(
                f"cache_capacity={cache_capacity} must be >= 1 "
                "(the session needs at least one live executor)"
            )
        # mesh serving: resolve the topology FIRST — it gates autotune
        # modes, places the session and stamps the tuner with the topology
        self.mesh_spec = None
        self._router = None
        if mesh is not None:
            spec = self._resolve_mesh(mesh, device)
            if spec is not None:
                if autotune == "full":
                    raise ValueError(
                        'autotune="full" measures single-device schedules '
                        "and cannot run on a sharded session; tune offline "
                        'per topology and use "cached" or "off"'
                    )
                self.mesh_spec = spec
                # the session's own device (weights, partial-band
                # executors, results): replica 0's first position
                device = spec.mesh.devices[0]
        self.device = default_device(device)
        # a staged model's stages on the device, and its conv layers in order
        # (for the channel checks); None for a ConvLayer chain
        self.staged = None if staged is None else staged.to(device=self.device)
        self.layers = (self.staged.conv_layers if self.staged is not None
                       else tuple(l.to(device=self.device) for l in layers))
        self.model = model
        self.backend = backend
        self.precision = precision
        self.vertical_policy = vertical_policy
        self.tile_cols = tile_cols
        self.band_rows = band_rows
        self.preferred_band_rows = preferred_band_rows
        self.scale = scale
        self.clip = clip
        self.max_bucket = max_bucket
        # pipeline_depth bounds in-flight dispatches per session: 1 =
        # blocking, 2 = double buffering (the paper's ping-pong buffers).
        # None = the tunable default (2), which a measured DB entry may
        # override; an EXPLICIT depth is the caller's and never overridden.
        self._depth_explicit = pipeline_depth is not None
        self.pipeline_depth = 2 if pipeline_depth is None else pipeline_depth
        # schedule autotuning: the mode and the DB-backed PlanTuner ("off"
        # keeps no tuner, so the DB file is never opened)
        self.autotune = autotune
        self._tuner = None
        if autotune != "off":
            from repro_torch.engine.autotune import PlanTuner  # lazy: no cycle

            self._tuner = (tuner if tuner is not None
                           else PlanTuner(path=tuning_db, device=self.device,
                                          mesh_shape=(self.mesh_spec.descriptor
                                                      if self.mesh_spec else "1x1")))
        self._tuning_counts = {"hits": 0, "misses": 0, "fallbacks": 0,
                               "applied": 0, "tuned_now": 0}
        # request batch sizes whose measured-best bucket policy is "exact"
        self._exact_buckets: set = set()
        # strict=True verifies every derived plan (analysis.plan_check) and
        # refuses error-level findings before anything is built
        self.strict = bool(strict)
        # accepted for interface parity; eager PyTorch has no donation
        self.donate_frames = donate_frames
        self._degenerate_plans = 0
        self._compile_counts: Dict[tuple, int] = {}
        self._cache = PlanCache(cache_capacity, on_evict=self._on_evict)
        self._stacks: Dict[tuple, _StackRecord] = {}
        self._memo_cap = 8 * cache_capacity
        self._plans: Dict[Tuple[int, int, int], SRPlan] = {}
        self._pinned: Optional[SRPlan] = None
        self._pinned_bucket: Optional[int] = None
        self._dispatch_ms: List[float] = []
        self._complete_ms: List[float] = []
        self._span_s = 0.0
        self._frames = 0
        self._peak_inflight = 0
        # the server's counters of its own stages (reported by stats(), see
        # _serving_stats): per finished request (queue wait, latency) ms;
        # per submit call its ms; per pin (ms, bytes, frames); per lock kind
        # [total, max] ms waited; per device stage its ms and the frames it
        # covered, and the joins whose events are not read yet.  Lists are
        # appended off the server lock (one append is atomic); the sums are
        # kept under it, the joins under their own.
        self._request_ms: List[Tuple[float, float]] = []
        self._submit_ms: List[float] = []
        self._pins: List[Tuple[float, int, int]] = []
        self._lock_wait_ms: Dict[str, List[float]] = {"submit": [0.0, 0.0],
                                                      "drain": [0.0, 0.0]}
        self._stage_ms: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        self._stage_frames: Dict[str, int] = dict.fromkeys(STAGES, 0)
        self._epilogue_kernel_frames = 0
        self._esa_launches = 0  # the ESA kernels' launches (kernels.esa)
        # K1 launches (segments) and the dispatches whose clocks counted them
        self._k1_segments = [0, 0]
        self._joins: deque = deque()
        self._joins_lock = threading.Lock()
        # temporal delta serving: partial-band dispatch counters (bumped by
        # the server at completion), the per-frame reuse accounting
        # DeltaSession keeps, and the output cache (made on first use)
        self._band_rows_served = 0
        self._band_dispatches = 0
        self._temporal_counts: Dict[str, int] = {
            "frames": 0,
            "bands_total": 0,
            "bands_skipped": 0,
            "band_rows_total": 0,
            "band_rows_served": 0,
            "hbm_bytes_full": 0,
            "hbm_bytes_served": 0,
            "cover_violations": 0,
        }
        self._output_cache = None
        # the SRServer submit()/upscale() serve through (set by the first
        # server that hosts this session, else created on first submit)
        self._server = None
        # mesh serving: the router owns per-replica executor caches and
        # band-sharded executors over the session's mesh
        if self.mesh_spec is not None:
            from repro_torch.engine.sharding import ReplicaRouter  # lazy: no cycle

            self._router = ReplicaRouter(self, self.mesh_spec, policy=route,
                                         cache_capacity=cache_capacity)

    @staticmethod
    def _resolve_mesh(mesh, device):
        """The session's :class:`~repro_torch.engine.sharding.MeshSpec` for
        ``mesh=`` (None for a one-position mesh), with its SRMesh built: a
        ``(replicas, band_shards)`` pair or a spec becomes
        ``make_sr_mesh`` on ``device``'s type (the card unless the caller
        asks for the CPU); an ``SRMesh`` is served as given."""
        from repro_torch.engine.sharding import MeshSpec  # lazy: no cycle
        from repro_torch.launch.mesh import make_sr_mesh

        spec = MeshSpec.coerce(mesh)
        if spec.is_trivial:
            return None
        if spec.mesh is None:
            built = make_sr_mesh(spec.replicas, spec.band_shards,
                                 device=default_device(device))
            spec = dataclasses.replace(spec, mesh=built)
        elif device is not None and torch.device(device).type != spec.mesh.devices[0].type:
            raise ValueError(
                f"device={device!r} does not match the mesh's devices "
                f"({spec.mesh.devices[0].type})"
            )
        return spec

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def open(
        cls,
        model: str = "abpn_x3",
        *,
        seed: int = 0,
        layers=None,
        scale: Optional[int] = None,
        clip: Optional[bool] = None,
        **kwargs,
    ) -> "SRSession":
        """Open a session on a registered SR model.

        Weights come from the spec's initialiser, seeded through a
        ``torch.Generator`` from ``seed``, unless an explicit ``layers``
        stack is passed.  ``scale``/``clip`` default to the model config's;
        everything else (backend, precision, device, ...) passes through to
        :class:`SRSession`.
        """
        from repro_torch.models.registry import get_sr_model

        spec = get_sr_model(model)
        cfg = spec.config
        if layers is None:
            layers = spec.init(torch.Generator().manual_seed(int(seed)))
        return cls(
            layers,
            scale=cfg.scale if scale is None else scale,
            clip=cfg.clip if clip is None else clip,
            model=spec.name,
            **kwargs,
        )

    @classmethod
    def from_plan(
        cls,
        plan: SRPlan,
        layers,
        *,
        bucket: Optional[int] = None,
        cache_capacity: int = 8,
        **kwargs,
    ) -> "SRSession":
        """A session pinned to one plan (and optionally one batch bucket):
        requests for any other LR shape are rejected."""
        session = cls(
            layers,
            backend=plan.backend,
            precision=plan.precision,
            vertical_policy=plan.vertical_policy,
            tile_cols=plan.tile_cols,
            band_rows=plan.band_rows,
            scale=plan.scale,
            clip=plan.clip,
            cache_capacity=cache_capacity,
            **kwargs,
        )
        check_layer_channels(session.layers, plan.in_channels, plan.scale)
        session._pinned = plan
        session._pinned_bucket = bucket
        session._plans[plan.lr_shape] = plan
        return session

    # ------------------------------------------------------------------
    # Plan + executor resolution
    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        """The conv chain's depth; a staged model's deepest segment's."""
        return self.staged.max_depth if self.staged is not None else len(self.layers)

    def plan_for(
        self,
        lr_shape: Tuple[int, int, int],
        batch_hint: Optional[int] = None,
    ) -> SRPlan:
        """The session's plan for one LR frame shape (derived once,
        memoised).

        ``batch_hint`` (the request's flattened frame count, passed by the
        server's submit path) keys the tuning-DB lookup: a warm entry for
        this (shape, batch) applies the measured-best schedule — band
        decomposition via ``SRPlan.from_request(tuner=...)``, pipeline depth
        and bucket rounding via :meth:`_apply_tuning` — before anything is
        built.  With ``autotune="off"`` (or an explicit ``band_rows``) the
        derivation is the untuned default.  ``strict=True`` verifies the
        plan here and raises on an error-level finding.
        """
        lr_shape = tuple(int(x) for x in lr_shape)
        plan = self._plans.get(lr_shape)
        if plan is not None:
            return plan
        if self._pinned is not None:
            raise ValueError(
                f"session is pinned to LR shape {self._pinned.lr_shape}, "
                f"got {lr_shape}"
            )
        check_layer_channels(self.layers, lr_shape[2], self.scale)
        # a tuning DB's schedules are a ConvLayer chain's
        tuner = self._tuner if self.band_rows is None and self.staged is None else None
        if tuner is not None:
            self._consult_tuning(lr_shape, batch_hint)
        plan = SRPlan.from_request(
            lr_shape,
            num_layers=self.num_layers,
            band_rows=self.band_rows,
            tile_cols=self.tile_cols,
            vertical_policy=self.vertical_policy,
            backend=self.backend,
            precision=self.precision,
            scale=self.scale,
            clip=self.clip,
            preferred_band_rows=self.preferred_band_rows,
            tuner=tuner,
            bucket=batch_hint,
        )
        if self.mesh_spec is not None:
            plan = self._shardable_plan(plan)
        if plan.degenerate_bands:
            self._degenerate_plans += 1
        if self.strict:
            self._verify_plan(plan)
        self._memo_put(self._plans, lr_shape, plan)
        return plan

    def _shardable_plan(self, plan: SRPlan) -> SRPlan:
        """Make a derived plan legal for the session's mesh: re-band when
        the default decomposition does not split across the band shards;
        an EXPLICIT ``band_rows`` is the caller's decision and is rejected
        (never silently re-banded) when it cannot shard."""
        from repro_torch.engine.sharding import check_shardable, ensure_shardable

        if self.band_rows is not None:
            err = check_shardable(plan, self.mesh_spec.band_shards)
            if err is not None:
                raise ValueError(
                    f"explicit band_rows={self.band_rows} cannot serve on "
                    f"mesh {self.mesh_spec.descriptor}: {err}"
                )
            return plan
        return ensure_shardable(plan, self.mesh_spec, self.preferred_band_rows)

    def _verify_plan(self, plan: SRPlan) -> None:
        """Strict-mode gate: statically verify the derived plan and raise
        :class:`~repro_torch.analysis.findings.PlanVerificationError` on any
        error-level finding — before weight prep or a build.  The shared
        memory rule reads the session's own layer widths."""
        from repro_torch.analysis import findings as _findings  # lazy: no cycle
        from repro_torch.analysis import plan_check  # lazy: no cycle

        kwargs = {"channels": [self.layers[0].ci] + [layer.co for layer in self.layers]}
        if self.mesh_spec is not None:
            kwargs["band_shards"] = self.mesh_spec.band_shards
        errs = _findings.errors(plan_check.verify_plan(plan, **kwargs))
        if errs:
            raise _findings.PlanVerificationError(errs)

    # ------------------------------------------------------------------
    # Schedule autotuning (engine.autotune)
    # ------------------------------------------------------------------
    def _tuning_key(self, lr_shape: tuple, batch: Optional[int]):
        from repro_torch.engine.autotune import TuningKey

        H, W, C = lr_shape
        return TuningKey(
            backend=self.backend, precision=self.precision,
            vertical_policy=self.vertical_policy,
            height=H, width=W, channels=C,
            num_layers=self.num_layers, tile_cols=self.tile_cols,
            scale=self.scale, clip=self.clip,
            batch=int(batch) if batch else 1,
        )

    def _consult_tuning(self, lr_shape: tuple, batch: Optional[int]) -> None:
        """DB lookup for a new shape: count the outcome, apply a hit's
        depth/bucket policy, and — ``autotune="full"`` only — tune NOW on
        a miss (blocking; the winner persists for every later cold start)."""
        key = self._tuning_key(lr_shape, batch)
        entry, kind = self._tuner.lookup(key)
        self._tuning_counts[
            {"hit": "hits", "fallback": "fallbacks", "miss": "misses"}[kind]
        ] += 1
        if entry is None and self.autotune == "full":
            entry = self._tune_now(lr_shape, batch)
        if entry is not None:
            self._apply_tuning(entry)

    def _apply_tuning(self, entry) -> None:
        """Adopt a measured-best schedule's session-level knobs.  Band
        decomposition is applied where plans are built (``from_request``'s
        tuner hook); depth applies unless the caller pinned one; an
        "exact" bucket policy registers the tuned batch so ``_bucket_for``
        stops rounding it up."""
        self._tuning_counts["applied"] += 1
        if not self._depth_explicit:
            self.pipeline_depth = int(entry.pipeline_depth)
        if entry.bucket_policy == "exact":
            self._exact_buckets.add(int(entry.bucket))

    def _tune_now(self, lr_shape: tuple, batch: Optional[int]):
        """The ``autotune="full"`` miss path: a small measured sweep for this
        (shape, batch), persisted (shallow depth grid, few reps — paid once
        per DB).  On a hosted CUDA session it launches on the stream the
        server gives the session."""
        from repro_torch.engine.autotune import tune

        default_plan = SRPlan.from_request(
            lr_shape,
            num_layers=self.num_layers,
            tile_cols=self.tile_cols,
            vertical_policy=self.vertical_policy,
            backend=self.backend,
            precision=self.precision,
            scale=self.scale,
            clip=self.clip,
            preferred_band_rows=self.preferred_band_rows,
        )
        stream = (self._server.device_stream(self) if self._server is not None
                  else contextlib.nullcontext())
        with stream:
            entry = tune(
                self.layers, default_plan, batch or 1,
                db=self._tuner.db, depths=(1, 2), chunks=2, reps=1,
            )
        self._tuning_counts["tuned_now"] += 1
        return entry

    def tuning_stats(self) -> dict:
        """Autotune outcome counters: ``hits`` (exact DB entry),
        ``fallbacks`` (nearest tuned batch), ``misses``, ``applied``
        (schedules adopted), ``tuned_now`` (blocking sweeps run by
        ``autotune="full"``), plus the mode, DB path and the live
        session-level knobs the tuner controls."""
        return {
            "mode": self.autotune,
            "db_path": self._tuner.db.path if self._tuner else None,
            **self._tuning_counts,
            "degenerate_plans": self._degenerate_plans,
            "pipeline_depth": self.pipeline_depth,
            "exact_buckets": sorted(self._exact_buckets),
        }

    def _memo_put(self, memo: dict, key, value) -> None:
        """Insert into a memo dict, evicting oldest entries past the cap."""
        memo[key] = value
        while len(memo) > self._memo_cap:
            try:
                memo.pop(next(iter(memo)))
            except (KeyError, StopIteration, RuntimeError):
                # concurrent submits resolve plans outside the server lock;
                # losing the race for the oldest key is fine — re-check
                continue

    @staticmethod
    def serving_dtype(dtype) -> torch.dtype:
        """The torch dtype a request serves in, from a numpy or torch dtype:
        64-bit types serve in 32 bits, as in the JAX package, so one
        executor serves both spellings."""
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
        return _CANONICAL.get(dtype, dtype)

    @classmethod
    def dtype_name(cls, dtype) -> str:
        return str(cls.serving_dtype(dtype)).replace("torch.", "")

    @classmethod
    def cache_key(cls, plan: SRPlan, bucket: int, dtype) -> tuple:
        return (plan, int(bucket), cls.dtype_name(dtype))

    def _acquire_stack(self, plan: SRPlan) -> Tuple[PreparedStack, tuple]:
        """The session's PreparedStack for this plan's numerics/backend,
        prepared on first use and refcounted per cache entry."""
        skey = plan.stack_key
        rec = self._stacks.get(skey)
        if rec is None:
            t0 = time.perf_counter()
            stack = prepare_stack(plan, self.staged if self.staged is not None else self.layers)
            _synchronize(self.device)
            rec = _StackRecord(stack=stack, refs=0, prepare_s=time.perf_counter() - t0)
            self._stacks[skey] = rec
        rec.refs += 1
        return rec.stack, skey

    def _release_stack(self, skey: tuple) -> None:
        rec = self._stacks.get(skey)
        if rec is None:
            return
        rec.refs -= 1
        if rec.refs <= 0:
            del self._stacks[skey]

    def _on_evict(self, key, entry: _CacheEntry) -> None:
        self._release_stack(entry.stack_key)

    def clear_cache(self) -> None:
        """Evict every executor AND release the prepared weights they
        pinned (the next request re-prepares and re-warms)."""
        self._cache.clear()
        if self._router is not None:
            self._router.clear()

    def executor_for(self, plan: SRPlan, bucket: int, dtype) -> Tuple[_CacheEntry, bool]:
        """The executor for ``(plan, bucket, dtype)``, and whether it was
        built now.

        A cache miss prepares the weight stack (once per numerics, shared
        and refcounted) and runs the executor once on a zero dummy in the
        dtype that will be served, then synchronises the device; that first
        launch also builds the CUDA kernel on first use.  Its time is the
        entry's ``compile_s``, so no later call on this key pays it.

        On a mesh session the call routes to a replica's band-sharded
        executor instead (``entry.replica`` records which one).
        """
        if self._router is not None:
            return self._router.executor_for(plan, bucket, dtype)
        dtype = self.serving_dtype(dtype)
        key = self.cache_key(plan, bucket, dtype)
        entry = self._cache.get(key)
        if entry is not None:
            return entry, False
        stack, skey = self._acquire_stack(plan)
        try:
            fn = build_stack_executor(plan, stack, donate_frames=bool(self.donate_frames))
            dummy = torch.zeros((bucket, *plan.lr_shape), dtype=dtype, device=self.device)
            t0 = time.perf_counter()
            fn(dummy)
            _synchronize(self.device)
            compile_s = time.perf_counter() - t0
        except BaseException:
            # a failed build/launch must not strand the stack refcount
            self._release_stack(skey)
            raise
        entry = _CacheEntry(
            fn=fn,
            plan=plan,
            bucket=int(bucket),
            dtype=self.dtype_name(dtype),
            compile_s=compile_s,
            stack_key=skey,
            donates=bool(self.donate_frames),
        )
        self._compile_counts[key] = self._compile_counts.get(key, 0) + 1
        self._cache.put(key, entry)
        return entry, True

    def band_executor_for(self, plan: SRPlan, bucket: int, dtype) -> Tuple[_CacheEntry, bool]:
        """The partial-band executor for ``(plan, bucket, dtype)`` — the
        temporal delta path's ``(bucket, rows, W, C) slabs + (bucket, 2)
        bounds -> HR bands`` — and whether it was built now.

        Lives in the same :class:`PlanCache` under a ``"bands"``-suffixed
        key with the same refcounted weight-stack sharing, warmed on zero
        slabs and zero bounds (every row phantom) like the frame path.  On a
        mesh session it is built locally, unsharded, on the session's device
        (replica 0's first position): a partial-band dispatch is below the
        granularity band sharding pays off at, and sharded and single-device
        full-frame outputs are bit-exact, so the splice guarantee holds.
        """
        if plan.backend == "reference":
            raise ValueError(
                "partial-band serving needs a banded backend (tilted or "
                "kernel); the reference backend computes whole frames"
            )
        if self.staged is not None:
            raise ValueError("partial-band serving takes a ConvLayer chain; a staged model's "
                             "whole-frame stages tie every band to the frame")
        from repro_torch.engine.temporal.band_diff import band_input_rows

        dtype = self.serving_dtype(dtype)
        key = (*self.cache_key(plan, bucket, dtype), "bands")
        entry = self._cache.get(key)
        if entry is not None:
            return entry, False
        stack, skey = self._acquire_stack(plan)
        try:
            fn = build_band_executor(plan, stack)
            rows = band_input_rows(plan.band_rows, plan.num_layers, plan.vertical_policy)
            dummy = torch.zeros((bucket, rows, plan.width, plan.in_channels), dtype=dtype,
                                device=self.device)
            dbounds = torch.zeros((bucket, 2), dtype=torch.int32, device=self.device)
            t0 = time.perf_counter()
            fn(dummy, dbounds)
            _synchronize(self.device)
            compile_s = time.perf_counter() - t0
        except BaseException:
            self._release_stack(skey)
            raise
        entry = _CacheEntry(
            fn=fn,
            plan=plan,
            bucket=int(bucket),
            dtype=self.dtype_name(dtype),
            compile_s=compile_s,
            stack_key=skey,
        )
        self._compile_counts[key] = self._compile_counts.get(key, 0) + 1
        self._cache.put(key, entry)
        return entry, True

    def output_dtype(self, plan: SRPlan, dtype) -> torch.dtype:
        """The dtype the executor emits for ``dtype`` input."""
        return output_spec(plan, self.layers, 1, self.serving_dtype(dtype)).dtype

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        if self._pinned_bucket is not None:
            return self._pinned_bucket
        if n in self._exact_buckets and (self.max_bucket is None or n <= self.max_bucket):
            # the tuner measured this batch faster built exactly than
            # rounded up (padding waste beats the extra executor)
            return n
        bucket = bucket_batch(n)
        if self.max_bucket is not None:
            # clamp DOWN to the largest power of two within the cap
            cap = 1 << (self.max_bucket.bit_length() - 1)
            bucket = min(bucket, cap)
        return bucket

    def flatten_request(self, frames) -> Tuple[torch.Tensor, int, Optional[tuple]]:
        """Validate a request and flatten it to ``(N, H, W, C)``.

        Returns ``(flat, ndim, lead)``: the flat frame batch as a tensor in
        the serving dtype (host input stays on the host — a numpy array is
        wrapped without a copy — and device tensors stay on their device),
        the caller's original rank, and the ``(B, T)`` leading shape for
        rank-5 input.  Malformed input fails HERE with a ``ValueError``
        naming the expected ``(..., H, W, C)`` layout.
        """
        if isinstance(frames, torch.Tensor):
            arr = frames
        else:
            try:
                arr = np.asarray(frames)
            except Exception as e:
                raise ValueError(
                    "expected an array of frames with shape (..., H, W, C); "
                    f"got {type(frames).__name__}"
                ) from e
            if arr.dtype.kind not in "fiub":
                raise ValueError(
                    "expected numeric frames with shape (..., H, W, C); "
                    f"got dtype {arr.dtype} (from {type(frames).__name__})"
                )
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if arr.dtype.is_complex:
            raise ValueError(
                "expected numeric frames with shape (..., H, W, C); "
                f"got dtype {arr.dtype} (from {type(frames).__name__})"
            )
        arr = arr.to(self.serving_dtype(arr.dtype))
        lead: Optional[tuple] = None
        if arr.ndim == 3:
            flat = arr[None]
        elif arr.ndim == 4:
            flat = arr
        elif arr.ndim == 5:
            lead = tuple(arr.shape[:2])
            flat = arr.reshape(arr.shape[0] * arr.shape[1], *arr.shape[2:])
        else:
            raise ValueError(
                "expected (H, W, C), (T, H, W, C) or (B, T, H, W, C) frames, "
                f"got shape {tuple(arr.shape)}"
            )
        ci = self.layers[0].ci
        if flat.shape[-1] != ci:
            raise ValueError(
                f"frames have {flat.shape[-1]} channels in the trailing "
                f"(..., H, W, C) axis; this session's layer stack expects "
                f"C={ci}"
            )
        return flat, arr.ndim, lead

    def submit(self, frames, *, priority: int = 0, deadline=None, timeout=None):
        """Queue a request on the session's server; returns an
        :class:`~repro_torch.engine.server.SRFuture` immediately."""
        return self._host_server().submit_for(
            self, frames, priority=priority, deadline=deadline, timeout=timeout)

    def _host_server(self):
        """The hosting :class:`SRServer`, else an embedded single-model
        server created on first use."""
        if self._server is None:
            from repro_torch.engine.server import SRServer  # lazy: avoids a cycle

            self._server = SRServer({self.model or "session": self})
        return self._server

    def upscale(self, frames) -> torch.Tensor:
        """Super-resolve frames of any supported rank (blocking):
        ``submit(frames).result()``.  The result is on the session's
        device."""
        return self.submit(frames).result()

    def serve_batch(
        self, plan: SRPlan, frames: torch.Tensor, real_frames: Optional[int] = None
    ) -> torch.Tensor:
        """Run ONE pre-bucketed batch through the plan's executor
        synchronously, recording its latency (a cache miss warms first,
        outside the timed region).  ``real_frames`` counts only that many
        leading frames in :meth:`stats`."""
        n_real = frames.shape[0] if real_frames is None else real_frames
        entry, _ = self.executor_for(plan, frames.shape[0], frames.dtype)
        t0 = time.perf_counter()
        hr = entry.fn(frames.to(self.device))
        _synchronize(self.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._dispatch_ms.append(dt_ms)
        self._complete_ms.append(dt_ms)
        self._span_s += dt_ms / 1e3
        self._frames += n_real
        self._peak_inflight = max(self._peak_inflight, 1)
        return hr

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def cache_stats(self) -> dict:
        """Executor-cache counters plus per-entry warm-up metadata and the
        device-resident prepared weight stacks."""
        stats = self._cache.stats()
        stats["recompiles"] = sum(c - 1 for c in self._compile_counts.values() if c > 1)
        stats["entries"] = [
            {
                "lr_shape": list(e.plan.lr_shape),
                "backend": e.plan.backend,
                "precision": e.plan.precision,
                "band_rows": e.plan.band_rows,
                "bucket": e.bucket,
                "dtype": e.dtype,
                "compile_s": e.compile_s,
            }
            for e in self._cache.entries()
        ]
        stats["stacks"] = [
            {
                "precision": k[0],
                "backend": k[1],
                "refs": rec.refs,
                "prepare_s": rec.prepare_s,
                "resident_bytes": rec.stack.nbytes(),
            }
            for k, rec in self._stacks.items()
        ]
        return stats

    def stats(self, **extra) -> StreamStats:
        """Steady-state serving stats (warm-up and weight prep excluded),
        with the server's own counters (:meth:`_serving_stats`) and a
        ``temporal`` section once delta frames were served."""
        if self._temporal_counts["frames"] and "temporal" not in extra:
            extra["temporal"] = self.temporal_stats()
        return latency_stats(
            self._complete_ms,
            self._frames,
            dispatch_ms=self._dispatch_ms,
            total_s=self._span_s,
            peak_inflight=self._peak_inflight,
            **self._serving_stats(),
            **extra,
        )

    # ------------------------------------------------------------------
    # The server's counters of its own stages
    # ------------------------------------------------------------------
    def _note_lock_wait(self, kind: str, ms: float) -> None:
        """Fold one wait for the server lock (``"submit"``: admission,
        ``"drain"``: a drain turn); called holding that lock."""
        total = self._lock_wait_ms[kind]
        total[0] += ms
        total[1] = max(total[1], ms)

    def _note_stages(self, clock: StageClock, frames: int) -> None:
        """Fold a completed dispatch's device ms by stage; called holding
        the server lock."""
        for stage, ms in clock.stage_ms().items():
            self._stage_ms[stage] += ms
            self._stage_frames[stage] += frames
        if "epilogue" in clock.kernels:
            self._epilogue_kernel_frames += frames
        self._esa_launches += clock.launches.get("esa", 0)
        self._k1_segments[0] += clock.count("k1")
        self._k1_segments[1] += 1

    def _note_join(self, clock: StageClock, frames: int) -> None:
        """Queue a request's join, read once its events have completed (at
        a later completion or at :meth:`stats`)."""
        with self._joins_lock:
            self._joins.append((clock, frames))

    def _read_joins(self) -> None:
        """Fold the queued joins that have completed (never waits)."""
        with self._joins_lock:
            while self._joins and self._joins[0][0].done():
                clock, frames = self._joins.popleft()
                self._stage_ms["join"] += clock.stage_ms()["join"]
                self._stage_frames["join"] += frames

    def _serving_stats(self) -> dict:
        """The server's counters of its own stages, since the last
        :meth:`reset_stats`:

        * ``requests`` finished, and over them ``queue_wait_{p50,p90,max}_ms``
          (submit to the launch of its first frames) and
          ``latency_{p50,p90,mean}_ms`` (submit to its result ready);
        * ``submits`` (``SRServer.submit``/``submit_bands`` calls) and
          ``submit_max_ms``, the longest;
        * ``pins`` (host frames copied into pinned memory), ``pin_ms``,
          ``pin_max_ms``, ``pin_bytes``, ``pin_frames``;
        * ``lock_wait_{submit,drain}_ms`` and ``..._max_ms``: waits for the
          server lock at admission and in drain turns (a turn that launched
          or completed nothing charges the server's default session);
        * ``{upload,marshal,k1,epilogue,join}_device_ms`` and
          ``..._frames``: device time of each stage of the single-device
          frame path and the real frames it covered.  Upload is what a
          dispatch runs before its features (copies to the card, ``cat``,
          zero pad, the cast to the compute dtype); marshal, on the kernel
          backend, K1's input streams (``ops.band_streams``, a ``halo``
          crop); K1 the launch (a plain backend's whole ``sr_features``);
          the epilogue ``sr_epilogue``; join the ``cat`` of a request's
          pieces.  On the CPU, host time.
        * ``epilogue_kernel_frames``: of ``epilogue_frames``, those whose
          epilogue ran as the hand-written kernel (``kernels.epilogue``;
          on the card, all of them).
        * ``k1_segments``: K1 launches a dispatch, over the dispatches timed
          (1 for a conv chain, a staged model's segments: RLFN x4's 9); 0
          before any.  ``esa_*`` above is a staged model's whole-frame
          stages.
        * ``esa_launches``: the ESA kernels' launches (``kernels.esa``,
          ``ESA_PASSES`` a stage: RLFN x4's six blocks launch 24 a dispatch
          on the card; 0 on the CPU, where the plain chain runs).
        """
        self._read_joins()
        req = np.asarray(self._request_ms, np.float64).reshape(-1, 2)
        wait, lat = req[:, 0], req[:, 1]
        submits = list(self._submit_ms)
        pins = np.asarray(self._pins, np.float64).reshape(-1, 3)
        some = req.size > 0
        out = {
            "requests": int(req.shape[0]),
            "queue_wait_p50_ms": float(np.percentile(wait, 50)) if some else 0.0,
            "queue_wait_p90_ms": float(np.percentile(wait, 90)) if some else 0.0,
            "queue_wait_max_ms": float(wait.max()) if some else 0.0,
            "latency_p50_ms": float(np.percentile(lat, 50)) if some else 0.0,
            "latency_p90_ms": float(np.percentile(lat, 90)) if some else 0.0,
            "latency_mean_ms": float(lat.mean()) if some else 0.0,
            "submits": len(submits),
            "submit_max_ms": max(submits, default=0.0),
            "pins": int(pins.shape[0]),
            "pin_ms": float(pins[:, 0].sum()),
            "pin_max_ms": float(pins[:, 0].max()) if pins.size else 0.0,
            "pin_bytes": int(pins[:, 1].sum()),
            "pin_frames": int(pins[:, 2].sum()),
        }
        for kind, (total, longest) in self._lock_wait_ms.items():
            out[f"lock_wait_{kind}_ms"] = total
            out[f"lock_wait_{kind}_max_ms"] = longest
        for stage in STAGES:
            out[f"{stage}_device_ms"] = self._stage_ms[stage]
            out[f"{stage}_frames"] = self._stage_frames[stage]
        out["epilogue_kernel_frames"] = self._epilogue_kernel_frames
        out["esa_launches"] = self._esa_launches
        launches, dispatches = self._k1_segments
        out["k1_segments"] = launches / dispatches if dispatches else 0.0
        return out

    def sharding_stats(self) -> Optional[dict]:
        """Mesh routing stats (replica dispatch balance, per-replica
        caches, halo bytes per frame); ``None`` on an unsharded session."""
        if self._router is None:
            return None
        return self._router.stats()

    def output_cache(self, max_bytes: Optional[int] = None):
        """The session's HR output-band cache (temporal delta serving),
        created on first use.  ``max_bytes`` only applies at creation —
        later callers share whatever bound the first one set."""
        if self._output_cache is None:
            from repro_torch.engine.temporal.output_cache import (
                DEFAULT_CACHE_BYTES,
                OutputBandCache,
            )

            self._output_cache = OutputBandCache(
                max_bytes=DEFAULT_CACHE_BYTES if max_bytes is None else max_bytes
            )
        return self._output_cache

    def temporal_stats(self) -> dict:
        """Delta-serving counters (the ``temporal`` section of :meth:`stats`).

        ``reuse_ratio`` is spliced-from-cache bands over all bands of
        delta-served frames; ``band_rows_*`` count LR rows of conv-stack
        compute.  ``effective_hbm_bytes_per_frame`` models the paper's
        DRAM-traffic metric for the delta path: the LR slab bytes
        dispatched plus the HR band bytes written, per frame, weights
        excluded — next to ``full_hbm_bytes_per_frame``, the same model for
        a full re-upscale.
        """
        t = self._temporal_counts
        frames = t["frames"]
        total = t["bands_total"]
        out = {
            "frames": frames,
            "bands_total": total,
            "bands_skipped": t["bands_skipped"],
            "reuse_ratio": t["bands_skipped"] / total if total else 0.0,
            "band_rows_total": t["band_rows_total"],
            "band_rows_served": t["band_rows_served"],
            "band_dispatches": self._band_dispatches,
            # the server's count across ALL partial dispatches (any
            # submit_bands caller), beside the delta accounting above
            "band_rows_dispatched": self._band_rows_served,
            "effective_hbm_bytes_per_frame": t["hbm_bytes_served"] / frames if frames else 0.0,
            "full_hbm_bytes_per_frame": t["hbm_bytes_full"] / frames if frames else 0.0,
            "cover_violations": t["cover_violations"],
        }
        if self._output_cache is not None:
            out["cache"] = self._output_cache.stats()
        return out

    def reset_stats(self) -> None:
        self._dispatch_ms.clear()
        self._complete_ms.clear()
        self._span_s = 0.0
        self._frames = 0
        self._peak_inflight = 0
        self._band_rows_served = 0
        self._band_dispatches = 0
        for k in self._temporal_counts:
            self._temporal_counts[k] = 0
        self._request_ms.clear()
        self._submit_ms.clear()
        self._pins.clear()
        for total in self._lock_wait_ms.values():
            total[:] = [0.0, 0.0]
        for stage in STAGES:
            self._stage_ms[stage] = 0.0
            self._stage_frames[stage] = 0
        self._epilogue_kernel_frames = 0
        self._esa_launches = 0
        self._k1_segments[:] = [0, 0]
        with self._joins_lock:
            self._joins.clear()
