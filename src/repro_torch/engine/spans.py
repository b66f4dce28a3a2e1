"""The serving path's spans and stage clocks.

* :func:`span` names a stage of the serving path (``sr.<stage>``) for
  ``torch.profiler``: a ``record_function`` span while a profiler records,
  so the program's spans land in the same Kineto trace as the device's
  events, and otherwise one shared no-op context.  A span's name carries
  no id, so a trace's sums by name stay meaningful; a request's identity
  lives in the session's counters (``SRSession.stats()``).
* :class:`StageClock` stamps the boundaries of a dispatch's device stages
  (upload, K1's input marshalling, K1, epilogue; a request's join): CUDA
  timing events on the stream the work runs on, read only once the
  dispatch's own completion event has been waited for (or, for a join,
  once its last event has completed), so reading them never makes the
  host wait.  On the CPU every call returns done, and the host clock
  stands in.  The server makes a dispatch's clock :meth:`StageClock.active`
  around the executor call, and the executor marks its stages with
  :func:`mark` (a context variable, so the executor's functions keep their
  signatures: callers that wrap or replace them stay unchanged).  A
  hand-written kernel handed the clock notes its stage in
  :attr:`StageClock.kernels` when it launches (the session counts those
  frames too).

Whether a profiler records is read from the flag torch sets when any
profiler starts or stops (``torch.autograd.profiler._is_profiler_enabled``).
``torch.autograd._profiler_enabled()`` reads the calling thread's profiler
state, which is false in every thread under a profiler that records all
threads, so the spans of the threads that drive the server would be lost.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span", "mark", "active_clock", "StageClock", "SPAN_PREFIX"]

#: every span of the serving path is named ``sr.<stage>``
SPAN_PREFIX = "sr."

_OFF = contextlib.nullcontext()

# the clock of the dispatch this thread is executing, if the server keeps one
_CLOCK: contextvars.ContextVar = contextvars.ContextVar("repro_torch_stage_clock",
                                                        default=None)


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler records,
    else a shared no-op context (a bare ``record_function`` costs
    microseconds even with no profiler running)."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


class StageClock:
    """Timestamps where the device stages of a dispatch (or a request's
    join) begin, on ``device``: :meth:`mark` ``(stage)`` ends the stage
    open on the clock, if any, and opens ``stage`` (``None``: none); once
    :meth:`done`, :meth:`stage_ms` sums each stage's intervals.  On the
    card a mark is a timing event recorded on the device's current stream
    (the stream the stages' work is issued on).  ``kernels`` holds the
    stages whose work a hand-written kernel ran (the kernel's wrapper adds
    its stage when it launches); ``launches`` counts a stage's kernel
    launches where its wrapper notes them (:meth:`note_launches`)."""

    __slots__ = ("_device", "_marks", "kernels", "launches")

    def __init__(self, device: torch.device):
        self._device = device if device.type == "cuda" else None
        self._marks: List[Tuple[Optional[str], object]] = []
        self.kernels: Set[str] = set()
        self.launches: Dict[str, int] = {}

    def note_launches(self, stage: str, count: int) -> None:
        """A hand-written kernel's wrapper launched ``count`` kernels for
        ``stage``."""
        self.kernels.add(stage)
        self.launches[stage] = self.launches.get(stage, 0) + count

    def mark(self, stage: Optional[str]) -> None:
        if self._device is None:
            self._marks.append((stage, time.perf_counter()))
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        self._marks.append((stage, event))

    @contextlib.contextmanager
    def active(self):
        """Make this the clock :func:`mark` marks, for the ``with`` block."""
        token = _CLOCK.set(self)
        try:
            yield self
        finally:
            _CLOCK.reset(token)

    def count(self, stage: str) -> int:
        """How many times ``stage`` was begun (a staged model's K1 segments)."""
        return sum(1 for st, _ in self._marks if st == stage)

    def done(self) -> bool:
        """Whether every mark has completed (a query; never waits)."""
        return self._device is None or self._marks[-1][1].query()

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds of each stage marked, summed over its intervals
        (every mark complete)."""
        out: Dict[str, float] = {}
        for (stage, a), (_, b) in zip(self._marks, self._marks[1:]):
            if stage is not None:
                ms = (b - a) * 1e3 if self._device is None else a.elapsed_time(b)
                out[stage] = out.get(stage, 0.0) + ms
        return out


def active_clock() -> Optional[StageClock]:
    """The clock the server made active for the dispatch being executed."""
    return _CLOCK.get()


def mark(stage: Optional[str]) -> None:
    """Begin ``stage`` on the active clock (:meth:`StageClock.mark`), if
    there is one."""
    clock = _CLOCK.get()
    if clock is not None:
        clock.mark(stage)
