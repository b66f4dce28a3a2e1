"""Drive a traffic mix through an ``SRServer`` for one window.

The window's clients call only ``server.submit(frames)`` and
``future.result()``; the time a request's HR frames are ready on the device
is stamped by a done callback, which the server runs as soon as it has
waited for the dispatch's event.  A sample of finished requests, drawn from
the seed (the ``k`` whose seeded key is least, so the draw does not depend
on the order they finish in), keeps a copy of some of its HR frames, at
positions also drawn from the seed, for the correctness check; the rest of
its output is freed as the client drops it"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import math
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from harness import traffic as traffic_mod

GRACE_S = 60.0  # how long past the window's close a request may still finish


@dataclasses.dataclass
class Request:
    rid: int
    n: int  # frames
    start: int  # pool index of its first frame
    done: float = math.nan  # perf_counter seconds: its HR frames are ready on the device
    failed: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.failed is None and not math.isnan(self.done)


@dataclasses.dataclass
class Window:
    t0: float  # perf_counter seconds: the window opens; no request is sent after t0 + seconds
    t1: float  # the last request of the window is finished
    requests: List[Request]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _key(seed: int, rid: int) -> int:
    """A seeded 64-bit key for request ``rid`` (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(rid) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def positions(seed: int, rid: int, n: int, m: int) -> List[int]:
    """The frames of request ``rid`` (``n`` frames) that the check compares:
    ``m`` of them drawn from the seed, or all where ``n <= m``."""
    if n <= m:
        return list(range(n))
    rng = np.random.default_rng([int(seed), 3, int(rid)])
    return sorted(int(i) for i in rng.choice(n, size=m, replace=False))


class Sampler:
    """Keeps, of the ``k`` finished requests with the least seeded key, a
    copy of the ``m`` HR frames at their seeded :func:`positions`."""

    def __init__(self, k: int, seed: int, m: int = 1):
        self.k, self.seed, self.m = int(k), int(seed), int(m)
        self._heap: list = []  # (-key, rid, request, positions, hr at those positions)
        self._lock = threading.Lock()

    def offer(self, req: Request, hr) -> None:
        if self.k <= 0:
            return
        key = -_key(self.seed, req.rid)
        with self._lock:
            if len(self._heap) >= self.k and key <= self._heap[0][0]:
                return
            pos = positions(self.seed, req.rid, req.n, self.m)
            frames = hr.reshape(-1, *hr.shape[-3:]) if hr.dim() >= 3 else None
            kept = None  # an output of the wrong length: the check fails it
            if frames is not None and frames.shape[0] == req.n:
                kept = frames[torch.as_tensor(pos, device=frames.device)]
            item = (key, req.rid, req, pos, kept)
            if len(self._heap) < self.k:
                heapq.heappush(self._heap, item)
            else:
                heapq.heapreplace(self._heap, item)

    def items(self):
        """``[(request, positions, hr at those positions)]`` in request order."""
        with self._lock:
            return [(r, p, hr) for _, _, r, p, hr in sorted(self._heap, key=lambda t: t[1])]

    def nbytes(self) -> int:
        """Device bytes the kept frames hold."""
        with self._lock:
            return sum(hr.untyped_storage().nbytes() for *_, hr in self._heap
                       if hr is not None)

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()


def _stamp(req: Request) -> Callable:
    def done(_fut) -> None:
        req.done = time.perf_counter()
    return done


def drive(server, pool: np.ndarray, tr: dict, seed: int, seconds: float, sampler: Sampler,
          span: Callable = None, warm: bool = False) -> Window:
    """Run ``tr`` against ``server`` for ``seconds`` and wait (at most
    ``GRACE_S`` past the close) for every request of the window.
    ``span(name)`` wraps the calls into the server (a profiler span in a
    traced run)."""
    span = span or (lambda name: contextlib.nullcontext())
    return _closed(server, pool, tr, int(seed), float(seconds), sampler, span, warm)


def _closed(server, pool, tr, seed, seconds, sampler, span, warm) -> Window:
    n, clients = traffic_mod.frames_per_request(tr), int(tr["clients"])
    reqs: List[Request] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    t_close = t0 + seconds

    def client(c: int) -> None:
        starts = traffic_mod.closed_starts(tr, seed, c, len(pool), warm)
        k = 0
        while time.perf_counter() < t_close:
            req = Request(rid=c + clients * k, n=n, start=next(starts))
            k += 1
            with lock:
                reqs.append(req)
            try:
                with span("bench.submit"):
                    fut = server.submit(pool[req.start:req.start + n])
                fut.add_done_callback(_stamp(req))
                with span("bench.result"):
                    hr = fut.result(timeout=max(0.001, t_close + GRACE_S - time.perf_counter()))
            except TimeoutError:
                req.failed = "not finished within a minute of the window's close"
                return
            except Exception as e:  # the server failed the request: a miss
                req.failed = f"{type(e).__name__}: {e}"
                continue
            sampler.offer(req, hr)
            del hr

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, t_close + GRACE_S + 5 - time.perf_counter()))
    return _window(t0, reqs)


def _window(t0: float, reqs: List[Request]) -> Window:
    for r in reqs:
        if r.failed is None and math.isnan(r.done):
            r.failed = "not finished within a minute of the window's close"
    done = [r.done for r in reqs if r.ok]
    return Window(t0=t0, t1=max(done) if done else time.perf_counter(),
                  requests=sorted(reqs, key=lambda r: r.rid))
