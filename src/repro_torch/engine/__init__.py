"""Batched SR execution engine (the serving subsystem), in PyTorch.

``SRServer`` (server.py) is the serving front door:
``SRServer.open(models...)`` hosts one or more named sessions and
``server.submit(frames, model=..., priority=...)`` returns an
:class:`SRFuture`, and ``server.stream(...)`` is an async generator for
frame-at-a-time live video.  A micro-batching scheduler (scheduler.py)
coalesces concurrent requests that share a ``(model, plan, dtype)`` key
into single bucket-sized dispatches and enforces a bounded queue
(``max_inflight_frames``, block, reject or shed admission), per-request
deadlines and cancellation; a :class:`DegradePolicy` steps down a
documented ladder under sustained overload.

``SRSession`` (session.py) is the per-model layer underneath: it derives
the :class:`SRPlan` per resolution, buckets batches to powers of two, and
keeps one warmed executor per ``(plan, bucket, dtype)`` in an LRU
:class:`PlanCache`, over device-resident :class:`PreparedStack` weights.

Serving is DELTA-AWARE for video (temporal/): ``server.stream(...,
delta=True)`` (or a :class:`DeltaSession` directly) band-diffs each frame
against the previous one, dispatches only the dirty bands as partial-band
dispatches, and splices clean bands from a bounded refcounted
:class:`OutputBandCache` on the device — bit-exact with a full re-upscale
(``session.stats()['temporal']``).

Schedules are TUNED: the autotuner (autotune.py) sweeps the legal
schedule space (halo band heights, pipeline depth, bucket rounding),
prunes on an analytic roofline, measures the survivors on the device and
persists winners in a JSON :class:`TuningDB`; sessions consult it on cold
start (``SRSession.open(..., autotune="off"|"cached"|"full")``, default
``"cached"``).

Serving SHARDS over a mesh (sharding/): ``SRSession(..., mesh=(R, S))``
runs each dispatch band-sharded over one of ``R`` replicas of ``S``
mesh positions (each with its own CUDA stream), routed round-robin or
least-loaded (``session.sharding_stats()``).

Underneath: ``SRPlan`` (plan.py) describes one execution — geometry,
numerics, boundary policy, backend — and ``run`` (executor.py) runs it
over a batch of LR frames.  The ``kernel`` backend launches the
hand-written CUDA kernel on the card.  Every entry point runs on CUDA
unless the caller passes ``device="cpu"``.  ``VideoStream`` (stream.py)
is a deprecated fixed-batch shim over a pinned session.
"""

from repro_torch.engine.autotune import (
    PlanTuner,
    TuningDB,
    TuningEntry,
    TuningKey,
    tune,
)
from repro_torch.engine.executor import (
    OutputSpec,
    PreparedStack,
    build_executor,
    build_stack_executor,
    compute_dtype_for,
    default_device,
    executor_artifacts,
    output_spec,
    plan_cost,
    plan_cost_terms,
    prepare_layers,
    prepare_stack,
    run,
    sr_epilogue,
    sr_features,
)
from repro_torch.engine.plan import (
    BACKENDS,
    PRECISIONS,
    VERTICAL_POLICIES,
    SRPlan,
    check_layer_channels,
    derive_band_rows,
    legal_band_rows,
    make_plan,
    shardable_band_rows,
)
from repro_torch.engine.scheduler import (
    DeadlineExceededError,
    MicroBatchScheduler,
    QueueFullError,
    RequestShedError,
)
from repro_torch.engine.server import (
    DEGRADE_LADDER,
    DegradePolicy,
    RequestCancelledError,
    SRFuture,
    SRServer,
)
from repro_torch.engine.session import (
    AUTOTUNE_MODES,
    PlanCache,
    SRSession,
    StreamStats,
    bucket_batch,
)
from repro_torch.engine.sharding import (
    ROUTE_POLICIES,
    MeshSpec,
    ReplicaRouter,
    ShardedPlan,
    build_sharded_executor,
)
from repro_torch.engine.stream import VideoStream
from repro_torch.engine.temporal import DeltaSession, OutputBandCache

__all__ = [
    "SRServer",
    "SRFuture",
    "MicroBatchScheduler",
    "QueueFullError",
    "DeadlineExceededError",
    "RequestShedError",
    "RequestCancelledError",
    "DegradePolicy",
    "DEGRADE_LADDER",
    "DeltaSession",
    "OutputBandCache",
    "VideoStream",
    "SRSession",
    "PlanCache",
    "bucket_batch",
    "SRPlan",
    "make_plan",
    "check_layer_channels",
    "derive_band_rows",
    "legal_band_rows",
    "shardable_band_rows",
    "AUTOTUNE_MODES",
    "PlanTuner",
    "TuningDB",
    "TuningEntry",
    "TuningKey",
    "tune",
    "BACKENDS",
    "PRECISIONS",
    "VERTICAL_POLICIES",
    "OutputSpec",
    "build_executor",
    "build_stack_executor",
    "compute_dtype_for",
    "default_device",
    "executor_artifacts",
    "output_spec",
    "plan_cost",
    "plan_cost_terms",
    "prepare_layers",
    "prepare_stack",
    "PreparedStack",
    "run",
    "sr_epilogue",
    "sr_features",
    "StreamStats",
    "MeshSpec",
    "ShardedPlan",
    "ReplicaRouter",
    "ROUTE_POLICIES",
    "build_sharded_executor",
]
