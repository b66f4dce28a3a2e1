"""SRServer — the request/future serving front door over SRSessions.

* ``SRServer.open("abpn_x3", ...)`` hosts one or more named
  :class:`~repro_torch.engine.session.SRSession`\\ s.
* ``server.submit(frames, model=..., priority=...)`` validates and queues
  a request and returns an :class:`SRFuture` immediately; requests that
  share a ``(model, plan, dtype)`` key are COALESCED by the
  :class:`~repro_torch.engine.scheduler.MicroBatchScheduler` into
  bucket-sized dispatches.
* ``max_inflight_frames`` bounds the queue (pending + dispatched frames);
  at the bound, ``admission="block"`` drains the queue to make space and
  ``admission="reject"`` raises :class:`QueueFullError`.

Execution is a pipelined drain loop: each dispatch is assembled (host
frames through the session's one reused, pinned staging buffer and an
asynchronous copy; device frames through one concatenate), launched on the
current CUDA stream, and completed in order, with up to
``session.pipeline_depth`` dispatches in flight per session.  A
``torch.cuda.Event`` recorded after each launch is what a completion waits
on — with the server lock released, so other threads' submits are admitted
(and coalesce) meanwhile.  ``SRFuture.result()`` drives the drain; no
background thread exists.

Deadlines, load shedding, the degrade policy, fault injection, partial-band
requests, cancellation and ``stream()`` are not ported yet (ROADMAP queue 1,
item 8); passing their options raises.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.engine.scheduler import (
    DeadlineExceededError,
    Dispatch,
    MicroBatchScheduler,
    QueueFullError,
    RequestShedError,
    SchedRequest,
)
from repro_torch.engine.session import SRSession, _not_ported

__all__ = [
    "SRServer",
    "SRFuture",
    "QueueFullError",
    "DeadlineExceededError",
    "RequestShedError",
]

ADMISSION_POLICIES = ("block", "reject")


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
        self._request = None

    def done(self) -> bool:
        return self._done

    def _wait_done(self, timeout: Optional[float]) -> None:
        """Drive the drain, then wait for completion — both bounded by one
        monotonic deadline."""
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
        """The error that failed this request, or ``None`` (blocking)."""
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
            self._cond.notify_all()

    def _run_callbacks(self) -> None:
        with self._cond:
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


class _Inflight:
    """One launched dispatch: the HR tensor, the event recorded after its
    launch (None on the CPU, where the call returns when done), its timing
    and whether it staged through the session's shared host buffer."""

    __slots__ = ("dispatch", "hr", "event", "t0", "used_staging")

    def __init__(self, dispatch: Dispatch, hr, event, t0: float, used_staging: bool):
        self.dispatch = dispatch
        self.hr = hr
        self.event = event
        self.t0 = t0
        self.used_staging = used_staging


class SRServer:
    """One serving endpoint hosting named sessions behind a micro-batcher.

    ``sessions`` maps model names to :class:`SRSession`\\ s (a bare session
    is hosted under its model name).  ``max_inflight_frames`` bounds pending
    + dispatched frames; ``admission`` is ``"block"`` (drain to make space)
    or ``"reject"`` (raise :class:`QueueFullError`).
    """

    def __init__(
        self,
        sessions: Union[SRSession, Mapping[str, SRSession]],
        *,
        default_model: Optional[str] = None,
        max_inflight_frames: Optional[int] = None,
        admission: str = "block",
        degrade=None,
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
        if admission == "shed":
            raise _not_ported('admission="shed"', 8)
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission {admission!r} not in {ADMISSION_POLICIES}")
        if degrade is not None:
            raise _not_ported("the degrade policy (degrade=)", 8)
        if injector is not None:
            raise _not_ported("fault injection (injector=)", 8)
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
        # per-session count of in-flight dispatches staged through the
        # session's SHARED pinned host buffer: its asynchronous copy may
        # still be reading it until that dispatch's event completes, so
        # the next host dispatch stages through a fresh buffer meanwhile
        self._staging_busy: Dict[int, int] = {}
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
        degrade=None,
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
        """Scheduler counters and each hosted session's serving stats."""
        return {
            "scheduler": self.scheduler_stats(),
            "models": {name: dict(s.stats()) for name, s in self._sessions.items()},
        }

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

    def submit(self, frames, *, model: Optional[str] = None,
               priority: int = 0, deadline: Optional[float] = None,
               timeout: Optional[float] = None) -> SRFuture:
        """Queue a request; returns its :class:`SRFuture` immediately.

        ``frames`` is any rank ``upscale`` accepts (numpy array or tensor);
        validation happens HERE, synchronously.  Higher ``priority`` keys
        dispatch first.  The dispatch runs when the drain loop next turns
        over (``result()``/``flush()``), coalescing whatever compatible
        requests are queued by then.
        """
        if self._closed:
            raise RuntimeError("server is closed")
        if deadline is not None or timeout is not None:
            raise _not_ported("request deadlines (deadline=/timeout=)", 8)
        name = self._resolve_model(model)
        session = self._sessions[name]
        flat, ndim, lead = session.flatten_request(frames)
        shape = tuple(int(x) for x in flat.shape[1:])
        n = int(flat.shape[0])
        fut = SRFuture(self)
        plan = session.plan_for(shape, batch_hint=n or None)
        dtype = session.serving_dtype(flat.dtype)
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
        )
        fut._request = req
        self._admit(req)
        return fut

    def _admit(self, req: SchedRequest) -> None:
        bound = self.max_inflight_frames
        if bound is not None and req.n > bound:
            raise ValueError(
                f"request of {req.n} frames can never fit "
                f"max_inflight_frames={bound}"
            )
        while True:
            err: Optional[BaseException] = None
            admitted = False
            with self._lock:
                queued = self._sched.pending_frames + self._inflight_frames
                if bound is None or queued + req.n <= bound:
                    req.seq = self._sched.next_seq()
                    req.admitted_at = time.monotonic()
                    self._sched.add(req)
                    admitted = True
                elif self.admission == "reject":
                    self._sched.note_rejected()
                    err = QueueFullError(
                        f"queue full: {queued} frames in flight + {req.n} "
                        f"requested > max_inflight_frames={bound}"
                    )
                elif not (self._sched.has_pending() or self._inflight
                          or self._completing):
                    raise RuntimeError(
                        "queue full but no work to drain — "
                        "inconsistent scheduler state"
                    )
                finished = self._take_finished()
            self._run_finished(finished)
            if err is not None:
                raise err
            if admitted:
                return
            # block policy: make space by draining (outside the lock)
            self._step()

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
        with self._cv:
            d = self._sched.next_dispatch(self._session_ready)
            if d is not None:
                self._launch(d)  # a launch FAILURE finishes futures
            elif self._inflight:
                inf = self._inflight.popleft()
                self._completing += 1
            elif self._completing:
                self._cv.wait()
            else:
                progress = bool(self._just_finished)
            finished = self._take_finished()
        self._run_finished(finished)
        if inf is None:
            return progress
        error: Optional[BaseException] = None
        try:
            if inf.event is not None:
                inf.event.synchronize()  # off-lock device wait
        except Exception as e:  # deferred device-side failure
            error = e
        with self._cv:
            try:
                self._finalize_complete(inf, error)
            finally:
                self._completing -= 1
                self._cv.notify_all()
            finished = self._take_finished()
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
        try:
            # a cache miss warms the executor on a dummy (and builds the
            # kernel on first use) before the timed dispatch starts
            entry, _ = session.executor_for(d.plan, d.bucket, d.tickets[0].request.flat.dtype)
            slab, used_staging = self._assemble(d)
            t0 = time.perf_counter()
            hr = entry.fn(slab)  # asynchronous on CUDA: returns once enqueued
            event = None
            if session.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(session.device))
            session._dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:
            self._fail_dispatch(d, e)
            return
        sid = id(session)
        count = self._session_inflight.get(sid, 0)
        if count == 0:
            self._window_start[sid] = t0
        self._session_inflight[sid] = count + 1
        session._peak_inflight = max(session._peak_inflight, count + 1)
        self._inflight_frames += d.real
        if used_staging:
            self._staging_busy[sid] = self._staging_busy.get(sid, 0) + 1
        self._inflight.append(_Inflight(d, hr, event, t0, used_staging))

    def _assemble(self, d: Dispatch):
        """Build the bucket-sized device slab from the dispatch's tickets;
        returns ``(slab, used_shared_staging)``.

        On a CUDA session, all-host tickets are packed into the session's
        reused pinned staging buffer and copied asynchronously — unless an
        in-flight dispatch still owns that buffer, in which case a fresh
        pinned buffer keeps the earlier copy safe.  Everything else is one
        copy to the device plus a concatenate/zero pad.
        """
        session: SRSession = d.session
        device = session.device
        tickets = d.tickets
        real = d.real
        first = tickets[0]
        host = device.type == "cuda" and all(
            t.request.flat.device.type == "cpu" for t in tickets)
        if host:
            if len(tickets) == 1 and real == d.bucket:
                src = first.request.flat[first.start:first.start + first.n]
                return src.to(device), False
            frame_shape = first.request.flat.shape[1:]
            dtype = first.request.flat.dtype
            shared = not self._staging_busy.get(id(session), 0)
            if shared:
                buf = session._staging_for(d.bucket, frame_shape, dtype)
            else:
                buf = torch.zeros((d.bucket, *frame_shape), dtype=dtype, pin_memory=True)
            for t in tickets:
                buf[t.slot:t.slot + t.n] = t.request.flat[t.start:t.start + t.n]
            buf[real:] = 0
            return buf.to(device, non_blocking=True), shared
        pieces = [t.request.flat[t.start:t.start + t.n].to(device) for t in tickets]
        if real < d.bucket:
            pieces.append(torch.zeros((d.bucket - real, *pieces[0].shape[1:]),
                                      dtype=pieces[0].dtype, device=device))
        return (pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)), False

    def _finalize_complete(self, inf: _Inflight, error: Optional[BaseException]) -> None:
        """Bookkeeping for a completed (or device-failed) dispatch — runs
        under the lock, after the off-lock wait."""
        d, session = inf.dispatch, inf.dispatch.session
        sid = id(session)
        now = time.perf_counter()
        self._inflight_frames -= d.real
        self._session_inflight[sid] -= 1
        if self._session_inflight[sid] == 0:
            session._span_s += now - self._window_start.pop(sid)
        if inf.used_staging:
            self._staging_busy[sid] -= 1
        if error is not None:
            self._fail_dispatch(d, error)
            return
        session._complete_ms.append((now - inf.t0) * 1e3)
        session._frames += d.real
        for t in d.tickets:
            r = t.request
            if r.failed:
                continue
            # keyed by the ticket's offset: concurrent drains may finalize
            # a long request's dispatches out of order
            r.pieces.append((t.start, inf.hr[t.slot:t.slot + t.n]))
            r.completed += t.n
            if r.completed == r.n:
                self._finish_request(r)

    def _finish_request(self, req: SchedRequest) -> None:
        pieces = [p for _, p in sorted(req.pieces, key=lambda sp: sp[0])]
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
        req.pieces = []
        if req.ndim == 3:
            out = out[0]
        elif req.ndim == 5:
            out = out.reshape(*req.lead, *req.plan.hr_shape)
        req.future._finish(result=out)
        self._just_finished.append(req.future)

    def _fail_dispatch(self, d: Dispatch, exc: BaseException) -> None:
        """A dispatch failed (build, launch or device error): fail every
        involved request's future and drop their queued remainders."""
        for r in d.requests:
            if r.failed:
                continue
            r.failed = True
            self._sched.drop(r)
            r.future._finish(exc=exc)
            self._just_finished.append(r.future)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Drain outstanding work, refuse further submits, and release the
        hosted sessions so a successor server may host them."""
        self.flush()
        self._closed = True
        for s in self._sessions.values():
            if s._server is self:
                s._server = None

    def __enter__(self) -> "SRServer":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
