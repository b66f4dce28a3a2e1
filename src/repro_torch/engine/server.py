"""SRServer — the request/future serving front door over SRSessions.

* ``SRServer.open("abpn_x3", ...)`` hosts one or more named
  :class:`~repro_torch.engine.session.SRSession`\\ s.
* ``server.submit(frames, model=..., priority=...)`` validates and queues
  a request and returns an :class:`SRFuture` immediately; requests that
  share a ``(model, plan, dtype)`` key are COALESCED by the
  :class:`~repro_torch.engine.scheduler.MicroBatchScheduler` into
  bucket-sized dispatches.
* ``async for hr in server.stream(frames)`` serves frame-at-a-time live
  video: a small lookahead keeps the coalescer fed and HR frames are
  yielded in order.  ``stream(..., delta=True)`` serves the clip through a
  :class:`~repro_torch.engine.temporal.DeltaSession`: only the bands that
  changed dispatch (``submit_bands``), the rest splice from the session's
  output cache.
* ``max_inflight_frames`` bounds the queue (pending + dispatched frames);
  at the bound, ``admission="block"`` drains the queue to make space,
  ``admission="reject"`` raises :class:`QueueFullError`, and
  ``admission="shed"`` evicts the lowest-priority, latest-deadline queued
  work (never the newcomer) — victims fail with :class:`RequestShedError`.
* ``submit(frames, deadline=..., timeout=...)``: a request still fully
  queued when its deadline passes fails with
  :class:`DeadlineExceededError` before it ever dispatches; its coalesced
  neighbours are untouched.  ``cancel(future)`` drops a request's queued
  remainder (:class:`RequestCancelledError`).
* :class:`DegradePolicy` watches a rolling p99 of end-to-end request
  latency and, on sustained SLO breach, steps down a ladder — bf16
  dispatch dtype, halved ``stream()`` lookahead, halved buckets — and
  back up on recovery.
* A ``runtime.resilience.FailureInjector`` passed as ``injector=`` is
  called before every launch; an injected fault fails exactly the
  dispatch it targets.

Execution is a pipelined drain loop: each dispatch is assembled (host
frames and band slabs are copied into pinned memory once, on the
submitting thread, so a dispatch uploads them asynchronously and the launch
never waits for the card; the pieces are concatenated and zero padded on
the device), launched, and completed in order, with up to
``session.pipeline_depth`` dispatches in flight per session.  Every launch
of a CUDA session runs on ONE stream the server names when it takes the
session (the constructing thread's current stream), whichever thread
drives the drain, and a ``torch.cuda.Event`` recorded on that stream
after the launch is what a completion waits on — with the server lock
released, so other threads' submits are admitted (and coalesce)
meanwhile.  ``SRFuture.result()`` drives the drain; no background thread
exists.

Under ``torch.profiler`` each stage runs in a span of its own
(:func:`~repro_torch.engine.spans.span`): ``sr.submit`` (holding
``sr.pin`` and the admission's ``sr.lock_wait``), ``sr.dispatch``
(``sr.assemble``, then ``sr.execute`` with the executor's ``sr.k1`` and
``sr.epilogue``), ``sr.wait``, ``sr.finalize`` (``sr.join``), and the
drain's own ``sr.lock_wait``.  Whether or not a profiler records, the
session counts what these stages took (``SRSession.stats()``): each
request's queue wait and latency, the submit path's pins and lock waits,
and the device time of each dispatch's upload, K1's input marshalling, K1
and epilogue and of each request's join, timed by CUDA events the server
reads only after it has waited for the dispatch (or, for a join, once its
events have completed).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.engine.scheduler import (
    DeadlineExceededError,
    Dispatch,
    MicroBatchScheduler,
    QueueFullError,
    RequestShedError,
    SchedRequest,
)
from repro_torch.engine.session import SRSession
from repro_torch.engine.spans import StageClock, span
from repro_torch.runtime.resilience import EMAMeanVar

__all__ = [
    "SRServer",
    "SRFuture",
    "QueueFullError",
    "DeadlineExceededError",
    "RequestShedError",
    "RequestCancelledError",
    "DegradePolicy",
    "DEGRADE_LADDER",
]

ADMISSION_POLICIES = ("block", "reject", "shed")


class RequestCancelledError(RuntimeError):
    """The submitter cancelled the request (e.g. an abandoned stream)."""


# The degradation ladder, mildest first; level k applies steps 1..k.
DEGRADE_LADDER = ("full", "bf16", "half_lookahead", "half_buckets")


class DegradePolicy:
    """Degrade-under-pressure controller for :class:`SRServer`.

    Watches a rolling p99 estimate of END-TO-END request latency
    (admission to future resolution, milliseconds): an
    :class:`~repro_torch.runtime.resilience.EMAMeanVar` approximates p99 as
    ``mean + 2.326 sigma`` — O(1) per observation and monotone in both load
    and jitter.

    The ladder (:data:`DEGRADE_LADDER`), mildest first; level k applies
    every step up to k:

    1. ``bf16`` — fp32 frame requests dispatch in bf16 (band requests of
       the delta path never do: their contract is bit-exactness);
    2. ``half_lookahead`` — ``stream()`` halves its lookahead window;
    3. ``half_buckets`` — freshly derived dispatch buckets are halved
       (carry-pinned buckets are never resized mid-clip).

    Hysteresis: stepping DOWN takes ``breach_steps`` consecutive
    observations with the p99 estimate over ``slo_p99_ms``; stepping UP
    takes ``recover_steps`` consecutive observations at or under
    ``recover_fraction * slo_p99_ms``.  Every transition is recorded
    (``transitions``, surfaced by ``SRServer.stats()``).

    The server calls :meth:`observe` and reads the level under its own
    lock; the policy keeps no lock.
    """

    #: z for the normal-approximation p99 (Phi(2.326) ~ 0.99)
    P99_Z = 2.326

    def __init__(self, slo_p99_ms: float, *, alpha: float = 0.1,
                 breach_steps: int = 3, recover_steps: int = 8,
                 recover_fraction: float = 0.5):
        if slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms={slo_p99_ms} must be > 0")
        if breach_steps < 1 or recover_steps < 1:
            raise ValueError("breach_steps and recover_steps must be >= 1")
        if not 0 < recover_fraction <= 1:
            raise ValueError(f"recover_fraction={recover_fraction} must be in (0, 1]")
        self.slo_p99_ms = float(slo_p99_ms)
        self.breach_steps = int(breach_steps)
        self.recover_steps = int(recover_steps)
        self.recover_fraction = float(recover_fraction)
        self._ema = EMAMeanVar(alpha)
        self.level = 0
        self.observations = 0
        self.degraded_requests = 0  # requests admitted at level > 0
        self.transitions: list = []
        self._breach = 0
        self._recover = 0

    @property
    def p99_ms(self) -> float:
        """The rolling p99 estimate (0.0 until the first observation)."""
        return self._ema.upper(self.P99_Z)

    def observe(self, latency_ms: float) -> Optional[dict]:
        """Fold one completed request's end-to-end latency; returns the
        transition record if this observation moved the ladder."""
        self.observations += 1
        self._ema.fold(latency_ms)
        p99 = self.p99_ms
        if p99 > self.slo_p99_ms:
            self._breach += 1
            self._recover = 0
            if self._breach >= self.breach_steps and self.level < len(DEGRADE_LADDER) - 1:
                return self._transition(self.level + 1, p99, "slo_breach")
        elif p99 <= self.recover_fraction * self.slo_p99_ms:
            self._recover += 1
            self._breach = 0
            if self._recover >= self.recover_steps and self.level > 0:
                return self._transition(self.level - 1, p99, "recovered")
        else:
            # between the recovery band and the SLO: neither direction is
            # earning a transition
            self._breach = 0
            self._recover = 0
        return None

    def _transition(self, to: int, p99: float, reason: str) -> dict:
        t = {
            "from": self.level,
            "to": to,
            "from_step": DEGRADE_LADDER[self.level],
            "to_step": DEGRADE_LADDER[to],
            "p99_ms": round(p99, 3),
            "slo_p99_ms": self.slo_p99_ms,
            "reason": reason,
            "observation": self.observations,
        }
        self.level = to
        self._breach = 0
        self._recover = 0
        self.transitions.append(t)
        return t

    # --- the knobs the server consults, one per ladder step -----------
    def serve_dtype(self, dtype) -> torch.dtype:
        """Dispatch dtype (torch) at the current level for a numpy or torch
        dtype (level >= 1: fp32 -> bf16)."""
        dtype = SRSession.serving_dtype(dtype)
        if self.level >= 1 and dtype == torch.float32:
            return torch.bfloat16
        return dtype

    def lookahead(self, base: int) -> int:
        """Stream lookahead at the current level (level >= 2: halved)."""
        return max(1, base // 2) if self.level >= 2 else base

    def bucket_cap(self, bucket: int) -> int:
        """Dispatch bucket at the current level (level >= 3: halved)."""
        return max(1, bucket // 2) if self.level >= 3 else bucket

    def stats(self) -> dict:
        return {
            "level": self.level,
            "step": DEGRADE_LADDER[self.level],
            "ladder": list(DEGRADE_LADDER),
            "slo_p99_ms": self.slo_p99_ms,
            "p99_ms": round(self.p99_ms, 3),
            "observations": self.observations,
            "degraded_requests": self.degraded_requests,
            "transitions": list(self.transitions),
        }


class SRFuture:
    """The result handle ``SRServer.submit`` returns.

    ``result()`` drives the server's drain loop until this request's frames
    are served, then returns the HR tensor in the request's original rank —
    or re-raises the error that failed the dispatch.  Thread-safe.
    """

    def __init__(self, server: "SRServer"):
        self._server = server
        self._cond = threading.Condition()
        self._done = False
        self._result = None
        self._exc: Optional[BaseException] = None
        self._callbacks = []
        # the admitted SchedRequest — what SRServer.cancel drops
        self._request = None

    def done(self) -> bool:
        return self._done

    def _wait_done(self, timeout: Optional[float]) -> None:
        """Drive the drain, then wait for completion — both bounded by one
        monotonic deadline (a spurious wakeup neither shortens nor
        lengthens the wait)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._done:
            self._server._drain_until(self, deadline=deadline)
        with self._cond:
            while not self._done:
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("request not complete within timeout")
                self._cond.wait(remaining)

    def result(self, timeout: Optional[float] = None):
        """The request's HR output (blocking; drives the server's drain),
        or re-raises the error that failed the request."""
        self._wait_done(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        """The error that failed this request, or ``None`` (blocking; a
        stored failure is RETURNED — even a ``TimeoutError`` raised by the
        dispatch — while an unfinished wait raises ``TimeoutError``)."""
        self._wait_done(timeout)
        return self._exc

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the future resolves (immediately if it
        already has); callbacks run outside the server lock."""
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    def _finish(self, result=None, exc: Optional[BaseException] = None) -> None:
        """Set the outcome and wake waiters (callbacks run later, off-lock)."""
        with self._cond:
            self._result = result
            self._exc = exc
            self._done = True
            # the request refers back to this future: drop it here, so the
            # pair is freed by its last reference and not by the cycle
            # collector.  It holds the pinned host frames, and a batch held
            # that long makes the next request pin fresh memory: a new
            # page-locked allocation, far slower than the copy itself.
            self._request = None
            self._cond.notify_all()

    def _run_callbacks(self) -> None:
        with self._cond:
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


class _Inflight:
    """One launched dispatch: the HR tensor, the event recorded after its
    launch (None on the CPU, where the call returns when done), its
    timing and the clock of its device stages (None where none is kept)."""

    __slots__ = ("dispatch", "hr", "event", "t0", "clock")

    def __init__(self, dispatch: Dispatch, hr, event, t0: float,
                 clock: Optional[StageClock]):
        self.dispatch = dispatch
        self.hr = hr
        self.event = event
        self.t0 = t0
        self.clock = clock


class SRServer:
    """One serving endpoint hosting named sessions behind a micro-batcher.

    ``sessions`` maps model names to :class:`SRSession`\\ s (a bare session
    is hosted under its model name).  ``max_inflight_frames`` bounds pending
    + dispatched frames; ``admission`` is ``"block"`` (drain to make space),
    ``"reject"`` (raise :class:`QueueFullError`) or ``"shed"`` (evict
    less urgent queued work, or reject the newcomer when it is itself the
    least urgent).  ``degrade`` installs a :class:`DegradePolicy`;
    ``injector`` a :class:`~repro_torch.runtime.resilience.FailureInjector`
    consulted before every launch.
    """

    def __init__(
        self,
        sessions: Union[SRSession, Mapping[str, SRSession]],
        *,
        default_model: Optional[str] = None,
        max_inflight_frames: Optional[int] = None,
        admission: str = "block",
        degrade: Optional[DegradePolicy] = None,
        injector=None,
    ):
        if isinstance(sessions, SRSession):
            sessions = {sessions.model or "default": sessions}
        sessions = dict(sessions)
        if not sessions:
            raise ValueError("SRServer needs at least one session")
        for name, s in sessions.items():
            if not isinstance(name, str):
                raise ValueError(f"model name {name!r} must be a string")
            if not isinstance(s, SRSession):
                raise ValueError(
                    f"model {name!r} must map to an SRSession, got {type(s).__name__}"
                )
        if max_inflight_frames is not None and max_inflight_frames < 1:
            raise ValueError(
                f"max_inflight_frames={max_inflight_frames} must be >= 1 "
                "(or None for an unbounded queue)"
            )
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission {admission!r} not in {ADMISSION_POLICIES}")
        if admission == "shed" and max_inflight_frames is None:
            raise ValueError(
                'admission="shed" needs a max_inflight_frames bound — '
                "an unbounded queue never sheds"
            )
        if degrade is not None and not isinstance(degrade, DegradePolicy):
            raise ValueError(f"degrade must be a DegradePolicy, got {type(degrade).__name__}")
        if injector is not None and not hasattr(injector, "on_dispatch"):
            raise ValueError(
                "injector must expose on_dispatch(model=, replica=) — "
                "see repro_torch.runtime.resilience.FailureInjector"
            )
        if default_model is None:
            default_model = next(iter(sessions))
        if default_model not in sessions:
            raise ValueError(
                f"default_model {default_model!r} not among hosted models "
                f"{sorted(sessions)}"
            )
        self._sessions = sessions
        self._default = default_model
        self.max_inflight_frames = max_inflight_frames
        self.admission = admission
        self._degrade = degrade
        self._injector = injector
        # hosted sessions route their own submit()/upscale() through THIS
        # server: one lock + one scheduler govern all traffic into a session
        for s in sessions.values():
            if s._server is None:
                s._server = self
            elif s._server is not self:
                raise ValueError(
                    "session is already served by another SRServer; host each "
                    "session in exactly one server"
                )
        # the one CUDA stream every launch of a session runs on, whichever
        # thread drives the drain (a thread's current stream is its own);
        # a mesh session's replica whose first position is on another GPU
        # gets a home stream there, keyed by that device
        self._streams: Dict[object, torch.cuda.Stream] = {
            id(s): torch.cuda.current_stream(s.device)
            for s in sessions.values() if s.device.type == "cuda"
        }
        for s in sessions.values():
            if s._router is None or s.device.type != "cuda":
                continue
            for r in range(s.mesh_spec.replicas):
                home = s._router.home_device(r)
                if home != s.device and home not in self._streams:
                    self._streams[home] = torch.cuda.current_stream(home)
        self._sched = MicroBatchScheduler()
        # one lock guards scheduler + inflight state; the condition lets a
        # thread RELEASE it while waiting on the device
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._completing = 0  # dispatches being waited on off-lock
        self._inflight: Deque[_Inflight] = deque()
        self._inflight_frames = 0  # dispatched, not yet complete (real)
        self._session_inflight: Dict[int, int] = {}
        self._window_start: Dict[int, float] = {}
        self._just_finished: list = []
        self._closed = False

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def open(
        cls,
        *models: str,
        default_model: Optional[str] = None,
        max_inflight_frames: Optional[int] = None,
        admission: str = "block",
        degrade: Optional[DegradePolicy] = None,
        injector=None,
        seed: int = 0,
        autotune: Union[str, Mapping[str, str], None] = None,
        **session_kwargs,
    ) -> "SRServer":
        """Open a server hosting registered SR models by name (default: the
        paper's ``abpn_x3``).  ``session_kwargs`` (backend, precision,
        device, layers, pipeline_depth, max_bucket, ...) apply to every
        hosted session."""
        names = models or ("abpn_x3",)

        def _kwargs_for(name: str) -> dict:
            kw = dict(session_kwargs)
            if isinstance(autotune, Mapping):
                if name in autotune:
                    kw["autotune"] = autotune[name]
            elif autotune is not None:
                kw["autotune"] = autotune
            return kw

        sessions = {
            name: SRSession.open(name, seed=seed, **_kwargs_for(name))
            for name in names
        }
        return cls(
            sessions,
            default_model=default_model,
            max_inflight_frames=max_inflight_frames,
            admission=admission,
            degrade=degrade,
            injector=injector,
        )

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(self._sessions)

    def session(self, model: Optional[str] = None) -> SRSession:
        """The hosted session serving ``model`` (default model if None)."""
        return self._sessions[self._resolve_model(model)]

    def device_stream(self, session: SRSession):
        """A context that makes the server's stream for ``session`` the
        current one (nothing on the CPU): device work on a session's
        results — the delta path's splice — runs where its launches ran."""
        stream = self._streams.get(id(session))
        return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)

    def scheduler_stats(self) -> dict:
        """The micro-batcher's coalescing/queue counters plus the server's
        in-flight state."""
        with self._lock:
            stats = self._sched.stats()
            stats["inflight_dispatches"] = len(self._inflight)
            stats["inflight_frames"] = self._inflight_frames
            stats["recent_dispatches"] = list(self._sched.recent_dispatches)
        return stats

    def stats(self) -> dict:
        """Scheduler counters, each hosted session's serving stats, and —
        with a :class:`DegradePolicy` — its level, rolling p99 estimate and
        transition log."""
        out = {
            "scheduler": self.scheduler_stats(),
            "models": {name: dict(s.stats()) for name, s in self._sessions.items()},
        }
        if self._degrade is not None:
            with self._lock:
                out["degrade"] = self._degrade.stats()
        return out

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def _resolve_model(self, model: Optional[str]) -> str:
        name = self._default if model is None else model
        if name not in self._sessions:
            raise ValueError(
                f"unknown model {name!r}; this server hosts {sorted(self._sessions)}"
            )
        return name

    def _name_for(self, session: SRSession) -> str:
        for name, s in self._sessions.items():
            if s is session:
                return name
        raise ValueError("session is not hosted by this server")

    def submit_for(self, session: SRSession, frames, *, priority: int = 0,
                   deadline: Optional[float] = None,
                   timeout: Optional[float] = None) -> SRFuture:
        """Submit addressed by hosted session identity rather than name."""
        return self.submit(frames, model=self._name_for(session),
                           priority=priority, deadline=deadline, timeout=timeout)

    def _counted(self, body, *args, model: Optional[str], **kwargs) -> SRFuture:
        """Run a submit path, ``body(t_submit, *args, model=model,
        **kwargs)``, in the ``sr.submit`` span, and count the call's time in
        its session's ``submit_max_ms`` (a call that raises queues no
        request)."""
        t0 = time.perf_counter()
        with span("sr.submit"):
            fut = body(t0, *args, model=model, **kwargs)
        self.session(model)._submit_ms.append((time.perf_counter() - t0) * 1e3)
        return fut

    def submit(self, frames, *, model: Optional[str] = None,
               priority: int = 0, deadline: Optional[float] = None,
               timeout: Optional[float] = None) -> SRFuture:
        """Queue a request; returns its :class:`SRFuture` immediately.

        ``frames`` is any rank ``upscale`` accepts (numpy array or tensor);
        validation happens HERE, synchronously.  Higher ``priority`` keys
        dispatch first.  The dispatch runs when the drain loop next turns
        over (``result()``/``flush()``), coalescing whatever compatible
        requests are queued by then.

        ``deadline`` (absolute ``time.monotonic()`` seconds) or ``timeout``
        (seconds from now; the two are exclusive) bounds how long the
        request may sit QUEUED: when it passes before the first frame
        dispatches, the future fails with :class:`DeadlineExceededError` —
        checked at every admission and drain turn, so an expired request
        never dispatches.  Once frames are in flight the request runs to
        completion.
        """
        return self._counted(self._submit_frames, frames, model=model,
                             priority=priority, deadline=deadline, timeout=timeout)

    def _submit_frames(self, t_submit: float, frames, *, model: Optional[str],
                       priority: int, deadline: Optional[float],
                       timeout: Optional[float]) -> SRFuture:
        if self._closed:
            raise RuntimeError("server is closed")
        if deadline is not None and timeout is not None:
            raise ValueError("pass deadline= or timeout=, not both")
        if timeout is not None:
            deadline = time.monotonic() + float(timeout)
        name = self._resolve_model(model)
        session = self._sessions[name]
        flat, ndim, lead = session.flatten_request(frames)
        degraded = False
        if self._degrade is not None:
            # the ladder's dispatch dtype applies BEFORE key derivation, so
            # a degraded request coalesces with (and builds as) bf16 traffic
            wanted = self._degrade.serve_dtype(flat.dtype)
            if wanted != flat.dtype:
                flat = flat.to(wanted)
                degraded = True
        shape = tuple(int(x) for x in flat.shape[1:])
        n = int(flat.shape[0])
        fut = SRFuture(self)
        if deadline is not None and time.monotonic() >= deadline:
            # dead on arrival: fail before plan derivation, let alone a build
            with self._lock:
                self._sched.expired += 1
            fut._finish(exc=DeadlineExceededError(
                "deadline exceeded on submit: the request's budget elapsed "
                "before admission"
            ))
            fut._run_callbacks()
            return fut
        plan = session.plan_for(shape, batch_hint=n or None)
        dtype = session.serving_dtype(flat.dtype)
        flat = self._pinned_for(session, flat)
        if n == 0:
            out = torch.zeros((0, *plan.hr_shape), dtype=session.output_dtype(plan, dtype),
                              device=session.device)
            if ndim == 5:
                out = out.reshape(*lead, *plan.hr_shape)
            with self._lock:
                self._sched.note_empty_request()
            fut._finish(result=out)
            return fut
        req = SchedRequest(
            seq=0,  # assigned under the lock in _admit
            key=(name, plan, session.dtype_name(dtype)),
            session=session,
            plan=plan,
            flat=flat,
            n=n,
            priority=int(priority),
            future=fut,
            ndim=ndim,
            lead=lead,
            deadline=deadline,
            submitted_at=t_submit,
        )
        fut._request = req
        self._admit(req)
        if degraded:
            with self._lock:
                self._degrade.degraded_requests += 1
        return fut

    def submit_bands(self, slabs, bands, *, plan, model: Optional[str] = None,
                     priority: int = 0) -> SRFuture:
        """Queue a partial-band request (the temporal delta path).

        ``slabs`` is a ``(k, rows, W, C)`` array or tensor of per-band input
        slabs in the plan's band-input geometry (``rows = R + 2L`` under
        ``halo``, the ``core.fusion.halo_slabs`` layout; ``R`` otherwise)
        and ``bands`` the matching strictly increasing band indices.  The
        future resolves to the ``(k, R*s, W*s, C)`` HR band stack on the
        session's device.  Band requests ride the same scheduler as frames
        under a ``"bands"``-suffixed key (queue units are bands, so
        backpressure and shedding apply unchanged, but a band slab never
        shares a dispatch with a frame).  The degrade policy's dtype ladder
        is deliberately NOT applied: the delta path's contract is
        bit-exactness with a full re-upscale, and a mid-clip downcast would
        poison the output cache.
        """
        return self._counted(self._submit_bands, slabs, bands, plan=plan, model=model,
                             priority=priority)

    def _submit_bands(self, t_submit: float, slabs, bands, *, plan, model: Optional[str],
                      priority: int) -> SRFuture:
        if self._closed:
            raise RuntimeError("server is closed")
        from repro_torch.engine.temporal.band_diff import band_input_rows

        name = self._resolve_model(model)
        session = self._sessions[name]
        bands = tuple(int(b) for b in bands)
        if not bands:
            raise ValueError("submit_bands needs at least one band")
        if any(b2 <= b1 for b1, b2 in zip(bands, bands[1:])):
            raise ValueError(f"bands must be strictly increasing: {bands}")
        if bands[0] < 0 or bands[-1] >= plan.num_bands:
            raise ValueError(f"bands {bands} out of range [0, {plan.num_bands})")
        flat = slabs if isinstance(slabs, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(slabs))
        flat = flat.to(session.serving_dtype(flat.dtype))
        rows = band_input_rows(plan.band_rows, plan.num_layers, plan.vertical_policy)
        want = (len(bands), rows, plan.width, plan.in_channels)
        if tuple(flat.shape) != want:
            raise ValueError(
                f"band slabs shape {tuple(flat.shape)} != expected {want} for "
                f"{len(bands)} band(s) of plan {plan.height}x{plan.width} "
                f"({plan.vertical_policy})"
            )
        flat = self._pinned_for(session, flat)
        fut = SRFuture(self)
        req = SchedRequest(
            seq=0,  # assigned under the lock in _admit
            key=(name, plan, session.dtype_name(flat.dtype), "bands"),
            session=session,
            plan=plan,
            flat=flat,
            n=len(bands),
            priority=int(priority),
            future=fut,
            ndim=4,  # identity assembly: the future gets the raw stack
            lead=None,
            bands=bands,
            submitted_at=t_submit,
        )
        fut._request = req
        self._admit(req)
        return fut

    @staticmethod
    def _pinned_for(session: SRSession, flat: torch.Tensor) -> torch.Tensor:
        """Host input for a CUDA session, copied once into pinned memory on
        the submitting thread (outside the server lock): its dispatches then
        upload it asynchronously.  From pageable memory torch would
        synchronize the stream after the copy, inside the launch, under the
        lock, so each dispatch would wait for the one before it.  Each copy
        is counted in the session's ``pin_*`` stats."""
        with span("sr.pin"):
            if session.device.type == "cuda" and flat.device.type == "cpu" and not flat.is_pinned():
                t0 = time.perf_counter()
                flat = flat.pin_memory()
                session._pins.append(((time.perf_counter() - t0) * 1e3, flat.nbytes,
                                      int(flat.shape[0])))
        return flat

    def cancel(self, fut: SRFuture) -> bool:
        """Best-effort cancel of a submitted request (the stream-abandon
        path).  The queued remainder is dropped — releasing any
        carry-pinned bucket — and the future fails with
        :class:`RequestCancelledError`; frames already inside an in-flight
        dispatch complete on the device and are discarded.  Returns False
        if the future is already resolved or was never admitted."""
        req = fut._request
        if req is None:
            return False
        with self._lock:
            if fut.done():
                return False
            req.failed = True
            self._sched.drop(req)
            fut._finish(exc=RequestCancelledError("request cancelled by its submitter"))
            self._just_finished.append(fut)
            finished = self._take_finished()
        self._run_finished(finished)
        return True

    def _expire_locked(self, now: float) -> None:
        """Cancel queued past-deadline requests (call holding the lock):
        each fails with :class:`DeadlineExceededError` before dispatching."""
        for r in self._sched.expire_due(now):
            r.failed = True
            r.future._finish(exc=DeadlineExceededError(
                f"deadline exceeded: {r.n} frames still queued when the "
                "request's deadline passed (never dispatched)"
            ))
            self._just_finished.append(r.future)

    def _admit(self, req: SchedRequest) -> None:
        bound = self.max_inflight_frames
        if bound is not None and req.n > bound:
            raise ValueError(
                f"request of {req.n} frames can never fit "
                f"max_inflight_frames={bound}"
            )
        while True:
            err: Optional[BaseException] = None
            admitted = done = False
            waited = self._acquire()
            try:
                req.session._note_lock_wait("submit", waited)
                # expire due work first: a stale queue must not block or
                # shed live traffic a deadline already freed
                self._expire_locked(time.monotonic())
                queued = self._sched.pending_frames + self._inflight_frames
                if req.deadline is not None and time.monotonic() >= req.deadline:
                    # the budget elapsed while blocked at admission
                    self._sched.expired += 1
                    req.failed = True
                    req.future._finish(exc=DeadlineExceededError(
                        "deadline exceeded during admission: the queue stayed "
                        "full past the request's budget"
                    ))
                    self._just_finished.append(req.future)
                    done = True
                elif bound is None or queued + req.n <= bound:
                    self._enqueue(req)
                    admitted = True
                elif self.admission == "reject":
                    self._sched.note_rejected()
                    err = QueueFullError(
                        f"queue full: {queued} frames in flight + {req.n} "
                        f"requested > max_inflight_frames={bound}"
                    )
                elif self.admission == "shed":
                    victims = self._sched.shed_victims(
                        queued + req.n - bound, priority=req.priority, deadline=req.deadline)
                    if victims is None:
                        # nothing queued ranks below the newcomer: IT takes
                        # the rejection
                        self._sched.note_rejected()
                        err = QueueFullError(
                            f"queue full: {queued} frames in flight + {req.n} "
                            f"requested > max_inflight_frames={bound}, and no "
                            "queued work ranks below the new request"
                        )
                    else:
                        for v in victims:
                            v.failed = True
                            v.future._finish(exc=RequestShedError(
                                f"shed: {v.n} queued frames (priority {v.priority}) "
                                f"evicted for a priority-{req.priority} request at "
                                "a full queue"
                            ))
                            self._just_finished.append(v.future)
                        self._enqueue(req)
                        admitted = True
                elif not (self._sched.has_pending() or self._inflight or self._completing):
                    raise RuntimeError(
                        "queue full but no work to drain — inconsistent scheduler state"
                    )
                finished = self._take_finished()
            finally:
                self._lock.release()
            self._run_finished(finished)
            if err is not None:
                raise err
            if admitted or done:
                return
            # block policy: make space by draining (outside the lock)
            self._step()

    def _acquire(self) -> float:
        """Take the server lock (in an ``sr.lock_wait`` span); returns the
        milliseconds waited for it.  The caller releases it."""
        t0 = time.perf_counter()
        with span("sr.lock_wait"):
            self._lock.acquire()
        return (time.perf_counter() - t0) * 1e3

    def _enqueue(self, req: SchedRequest) -> None:
        req.seq = self._sched.next_seq()
        req.admitted_at = time.monotonic()
        self._sched.add(req)

    # ------------------------------------------------------------------
    # The drain loop
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Dispatch all pending frames and complete all in-flight
        dispatches (their futures resolve)."""
        while self._step():
            pass

    def _drain_until(self, fut: SRFuture, deadline: Optional[float] = None) -> None:
        """Drive the drain until ``fut`` resolves, or until ``deadline``
        (absolute monotonic) passes."""
        while not fut.done():
            if deadline is not None and time.monotonic() >= deadline:
                return
            if not self._step():
                if fut.done():
                    return
                raise RuntimeError(
                    "future is not done but the server has no pending "
                    "work — was it issued by this server?"
                )

    def _session_ready(self, session: SRSession) -> bool:
        return self._session_inflight.get(id(session), 0) < session.pipeline_depth

    def _step(self) -> bool:
        """One drain turn: launch the next dispatch if a session has
        pipeline-depth slack, else complete the oldest in-flight one (its
        device wait runs with the lock RELEASED).  Returns False when there
        is nothing left to do."""
        inf = None
        progress = True
        waited = self._acquire()
        try:
            # the turn's wait is charged to the session it serves
            charged = self._sessions[self._default]
            # expired work never reaches a build, nor inflates the bucket
            self._expire_locked(time.monotonic())
            bucket_fn = self._degrade.bucket_cap if self._degrade is not None else None
            d = self._sched.next_dispatch(self._session_ready, bucket_fn)
            if d is not None:
                charged = d.session
                with span("sr.dispatch"):
                    self._launch(d)  # a launch FAILURE finishes futures
            elif self._inflight:
                inf = self._inflight.popleft()
                charged = inf.dispatch.session
                self._completing += 1
            elif self._completing:
                self._cv.wait()
            else:
                # nothing to launch or complete: progress only if expiry
                # just finished futures
                progress = bool(self._just_finished)
            charged._note_lock_wait("drain", waited)
            finished = self._take_finished()
        finally:
            self._lock.release()
        self._run_finished(finished)
        if inf is None:
            return progress
        error: Optional[BaseException] = None
        with span("sr.wait"):
            try:
                if inf.event is not None:
                    inf.event.synchronize()  # off-lock device wait
            except Exception as e:  # deferred device-side failure
                error = e
        waited = self._acquire()
        try:
            inf.dispatch.session._note_lock_wait("drain", waited)
            try:
                with span("sr.finalize"):
                    self._finalize_complete(inf, error)
            finally:
                self._completing -= 1
                self._cv.notify_all()
            finished = self._take_finished()
        finally:
            self._lock.release()
        self._run_finished(finished)
        return True

    def _take_finished(self) -> list:
        finished, self._just_finished = self._just_finished, []
        return finished

    @staticmethod
    def _run_finished(finished: list) -> None:
        for fut in finished:
            fut._run_callbacks()

    def _launch(self, d: Dispatch) -> None:
        session: SRSession = d.session
        t_launch = time.perf_counter()
        for t in d.tickets:
            if t.start == 0:  # the request's first frames leave the queue
                t.request.dispatched_at = t_launch
        try:
            with self.device_stream(session):
                dtype = d.tickets[0].request.flat.dtype
                # a cache miss warms the executor on a dummy (and builds the
                # kernel on first use) before the timed dispatch starts
                if d.band_subset is not None:
                    entry, _ = session.band_executor_for(d.plan, d.bucket, dtype)
                else:
                    entry, _ = session.executor_for(d.plan, d.bucket, dtype)
                if self._injector is not None:
                    # a raise here fails exactly this dispatch's requests
                    self._injector.on_dispatch(model=d.key[0], replica=entry.replica)
                # a routed dispatch arrives on its replica's first position;
                # the sharded executor joins its shard streams back into
                # that stream, so the event below marks the whole dispatch
                d.replica = entry.replica
                home = self._home(d)
                away = home != session.device  # a replica on another GPU
                stream = self._streams.get(home if away else id(session))
                # only the single-device executor marks K1 and its epilogue
                # (engine.executor._execute_stack, on the clock made active)
                clock = (StageClock(home) if d.band_subset is None and entry.replica is None
                         else None)
                with torch.cuda.stream(stream) if away else contextlib.nullcontext():
                    with span("sr.assemble"):
                        if clock is not None:
                            clock.mark("upload")
                        if d.band_subset is not None:
                            args = self._assemble_bands(d)
                        else:
                            args = (self._assemble(d),)
                    timed = clock.active() if clock is not None else contextlib.nullcontext()
                    t0 = time.perf_counter()
                    with span("sr.execute"), timed:
                        hr = entry.fn(*args)  # asynchronous on CUDA
                    event = None
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
            session._dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:
            self._fail_dispatch(d, e)
            return
        # mesh serving: credit the routing decision — the scheduler's
        # replica counters and the router's live load both key off it
        if d.replica is not None:
            self._sched.note_routed(d.replica)
            session._router.note_launch(d.replica, d.real)
        sid = id(session)
        count = self._session_inflight.get(sid, 0)
        if count == 0:
            self._window_start[sid] = t0
        self._session_inflight[sid] = count + 1
        session._peak_inflight = max(session._peak_inflight, count + 1)
        self._inflight_frames += d.real
        self._inflight.append(_Inflight(d, hr, event, t0, clock))

    @staticmethod
    def _home(d: Dispatch) -> torch.device:
        """The device a dispatch runs from: its routed replica's first
        position on a mesh session, else the session's device."""
        s = d.session
        return s.device if d.replica is None else s._router.home_device(d.replica)

    @classmethod
    def _assemble(cls, d: Dispatch) -> torch.Tensor:
        """The device slab of a dispatch: the tickets' rows
        uploaded (asynchronously from the pinned host copy
        :meth:`_pinned_for` made; device rows stay put), concatenated on
        the dispatch's home device (:meth:`_home`) and, where the executor
        needs the bucket's shape, zero padded to it: a band dispatch's slots
        and a mesh session's shards.  The single-device frame executor takes
        any batch (K1 and the epilogue build nothing per shape), so there
        its slab is the real rows alone and a carry's padding costs no
        work."""
        device = cls._home(d)
        pieces = [t.request.flat[t.start:t.start + t.n].to(device, non_blocking=True)
                  for t in d.tickets]
        padded = d.band_subset is not None or d.session.mesh_spec is not None
        if d.real < d.bucket and padded:
            pieces.append(torch.zeros((d.bucket - d.real, *pieces[0].shape[1:]),
                                      dtype=pieces[0].dtype, device=device))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)

    def _assemble_bands(self, d: Dispatch):
        """A band dispatch's ``(slab, bounds)`` device pair.

        Band slabs are assembled as frames are (:meth:`_assemble`), padded
        with zero slabs to the bucket.  The per-slot valid-row bounds follow
        from the dispatched band indices (``band_diff.band_bounds``, the
        ``halo_slabs`` formula); padded slots keep ``(0, 0)``: every row phantom, so a padding slab
        computes zero features and its HR rows are never read back.
        """
        from repro_torch.engine.temporal.band_diff import band_bounds

        plan = d.plan
        bounds = band_bounds(plan.height, plan.band_rows, plan.num_layers, d.band_subset,
                             slots=d.bucket)
        bounds = torch.from_numpy(bounds)
        if d.session.device.type == "cuda":
            bounds = bounds.pin_memory()  # a pageable copy would sync the stream
        return self._assemble(d), bounds.to(d.session.device, non_blocking=True)

    def _finalize_complete(self, inf: _Inflight, error: Optional[BaseException]) -> None:
        """Bookkeeping for a completed (or device-failed) dispatch — runs
        under the lock, after the off-lock wait."""
        d, session = inf.dispatch, inf.dispatch.session
        sid = id(session)
        now = time.perf_counter()
        # release the replica's in-flight slot FIRST — device failures must
        # not leave a replica looking permanently loaded
        if d.replica is not None and session._router is not None:
            session._router.note_complete(d.replica)
        self._inflight_frames -= d.real
        self._session_inflight[sid] -= 1
        if self._session_inflight[sid] == 0:
            session._span_s += now - self._window_start.pop(sid)
        if error is not None:
            self._fail_dispatch(d, error)
            return
        session._complete_ms.append((now - inf.t0) * 1e3)
        if inf.clock is not None:
            session._note_stages(inf.clock, d.real)
        session._read_joins()
        if d.band_subset is None:
            session._frames += d.real
        else:
            # partial-band traffic counts band rows of compute, not frames
            session._band_rows_served += d.real * d.plan.band_rows
            session._band_dispatches += 1
        for t in d.tickets:
            r = t.request
            if r.failed:
                continue  # cancelled mid-flight: its rows are discarded
            # keyed by the ticket's offset: concurrent drains may finalize
            # a long request's dispatches out of order; a replica on another
            # GPU hands its rows back on the session's device
            piece = inf.hr[t.slot:t.slot + t.n]
            if piece.device != session.device:
                piece = piece.to(session.device, non_blocking=True)
            r.pieces.append((t.start, piece))
            r.completed += t.n
            if r.completed == r.n:
                self._finish_request(r)

    def _finish_request(self, req: SchedRequest) -> None:
        pieces = [p for _, p in sorted(req.pieces, key=lambda sp: sp[0])]
        if len(pieces) == 1:
            out = pieces[0]
        else:
            with span("sr.join"):
                clock = StageClock(pieces[0].device)
                clock.mark("join")
                out = torch.cat(pieces, dim=0)
                clock.mark(None)
            req.session._note_join(clock, req.n)
        req.pieces = []
        if req.ndim == 3:
            out = out[0]
        elif req.ndim == 5:
            out = out.reshape(*req.lead, *req.plan.hr_shape)
        req.future._finish(result=out)
        self._just_finished.append(req.future)
        ready = time.perf_counter()
        req.session._request_ms.append(((req.dispatched_at - req.submitted_at) * 1e3,
                                        (ready - req.submitted_at) * 1e3))
        if self._degrade is not None and req.admitted_at:
            # end-to-end latency (admission -> resolution) sees queue delay,
            # which is what overload inflates
            self._degrade.observe((time.monotonic() - req.admitted_at) * 1e3)

    def _fail_dispatch(self, d: Dispatch, exc: BaseException) -> None:
        """A dispatch failed (build, launch, injected or device error): fail
        every involved request's future and drop their queued remainders."""
        for r in d.requests:
            if r.failed:
                continue
            r.failed = True
            self._sched.drop(r)
            r.future._finish(exc=exc)
            self._just_finished.append(r.future)

    # ------------------------------------------------------------------
    # Streaming
    # ------------------------------------------------------------------
    async def stream(self, frames, *, model: Optional[str] = None,
                     priority: int = 0, lookahead: int = 4,
                     delta: bool = False, cache_bytes: Optional[int] = None):
        """Serve an iterable of frames one at a time; yields HR frames (on
        the session's device) in order — ``async for hr in
        server.stream(...)``.

        ``lookahead`` frames are submitted ahead of the one being awaited,
        which keeps the micro-batcher's queue non-empty: a stream coalesces
        its own lookahead window into full buckets, and concurrent streams
        share dispatches.  Waiting happens off the event loop
        (``asyncio.to_thread``), so streams interleave.  Under a
        :class:`DegradePolicy` at level >= 2 the window is halved, re-read
        every turn.

        ``delta=True`` serves the clip through a
        :class:`~repro_torch.engine.temporal.DeltaSession`: each frame is
        band-diffed against the previous one, only dirty bands dispatch,
        and clean bands splice from the session's output cache, bit-exact
        with a full re-upscale.  Delta streams are sequential (frame k's
        dirty set needs frame k-1's digests), so ``lookahead`` does not
        apply; ``cache_bytes`` bounds the output cache.  Abandoning either
        kind of stream (closing the generator mid-clip) cancels its pending
        requests and releases its cache pins.
        """
        import asyncio

        if delta:
            from repro_torch.engine.temporal import DeltaSession

            ds = DeltaSession(self.session(model), server=self,
                              priority=priority, cache_bytes=cache_bytes)
            try:
                for frame in frames:
                    yield await asyncio.to_thread(ds.serve, frame)
            finally:
                ds.close()
            return

        base = max(1, int(lookahead))
        pending: Deque[SRFuture] = deque()
        it = iter(frames)
        exhausted = False
        try:
            while pending or not exhausted:
                window = self._degrade.lookahead(base) if self._degrade is not None else base
                while not exhausted and len(pending) < window:
                    try:
                        frame = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    # submit off the loop too: a full bounded queue under
                    # admission="block" drains (device waits) until space
                    pending.append(await asyncio.to_thread(
                        self.submit, frame, model=model, priority=priority))
                if pending:
                    fut = pending.popleft()
                    yield await asyncio.to_thread(fut.result)
        finally:
            # abandoned mid-clip: drop the lookahead window's queued frames
            while pending:
                self.cancel(pending.popleft())

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Drain outstanding work, refuse further submits, and release the
        hosted sessions so a successor server may host them (their caches
        carry over)."""
        self.flush()
        self._closed = True
        for s in self._sessions.values():
            if s._server is self:
                s._server = None

    def __enter__(self) -> "SRServer":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
