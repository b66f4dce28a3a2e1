"""The traced run's device timeline, from ``torch.profiler``.

The profiler records host operations of every thread (where the installed
PyTorch can) and, through CUPTI, every kernel, copy and memset on the card,
including kernels that a library launches through ctypes outside any
PyTorch operator.  The events are read from the profiler's Kineto results
(the data ``export_chrome_trace`` writes), never from ``prof.events()``,
which keeps only device work it can tie to a PyTorch operator.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Trace:
    t0_ns: int  # the traced window, in the profiler's clock (ns since the epoch)
    t1_ns: int
    device: List[Tuple[str, int, int]]  # (name, start, end) of kernels, copies, memsets
    host: List[Tuple[str, int, int]]  # (name, start, end) of host operations and spans
    all_threads: bool  # host events of every thread, not only the one that started it

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def device_seconds(self, match=None) -> float:
        """Summed duration of the device events whose name ``match``
        accepts (all of them without one), inside the window."""
        return sum(e - s for n, s, e in self._clipped() if match is None or match(n)) / 1e9

    def count(self, match) -> int:
        return sum(1 for n, s, e in self.device if match(n) and self.t0_ns <= s < self.t1_ns)

    def _clipped(self):
        for n, s, e in self.device:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                yield n, s, e

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's intervals inside the window."""
        out: List[List[int]] = []
        for _, s, e in sorted(self._clipped(), key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals between the window's edges and the busy ones."""
        out, t = [], self.t0_ns
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1_ns > t:
            out.append((t, self.t1_ns))
        return out

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing: each gap is named by the shortest host
        event that spans its midpoint (the most specific), or ``host idle``."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self._clipped():
            ops[n] += (e - s) / 1e9
        host = sorted(self.host, key=lambda t: t[1])
        idle: Dict[str, float] = defaultdict(float)
        active: list = []
        i = 0
        for a, b in sorted(self.gaps(), key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            label = min(active, key=lambda h: h[2] - h[1])[0] if active else "host idle"
            idle[label] += (b - a) / 1e9
        top = lambda d: sorted(([k[:200], v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


class Profiler:
    """``torch.profiler`` over one window: :meth:`start`, then :meth:`stop`
    returns a :class:`Trace`."""

    def __init__(self):
        self._prof = None
        self.all_threads = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig

            cfg = _ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
            self.all_threads = True
        except (ImportError, TypeError):
            self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self, t0: float, t1: float) -> Trace:
        """Stop, and read the window ``[t0, t1]`` (``time.perf_counter``
        seconds) from what was recorded."""
        self._prof.stop()
        from torch.autograd import DeviceType

        device, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            item = (ev.name(), int(ev.start_ns()), int(ev.end_ns()))
            if ev.device_type() != DeviceType.CUDA:
                host.append(item)
            elif not annotation(ev):
                device.append(item)
        self._prof = None
        return Trace(t0_ns=wall_ns(t0), t1_ns=wall_ns(t1), device=device, host=host,
                     all_threads=self.all_threads)


def annotation(ev) -> bool:
    """Whether a device-side event is a span's projection onto the card's
    timeline (the profiler draws every ``record_function`` span over the
    device work inside it), not work of its own."""
    user = getattr(ev, "is_user_annotation", None)
    return (user is not None and user()) or ev.name().startswith("bench.")


def wall_ns(perf_s: float) -> int:
    """``time.perf_counter`` seconds in the profiler's clock (nanoseconds
    since the epoch)."""
    return int(time.time_ns() + (perf_s - time.perf_counter()) * 1e9)
