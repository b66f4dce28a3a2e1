"""Input pipeline: deterministic generation with background prefetch — the
port of ``repro.data.pipeline``.

``Prefetcher`` overlaps host-side batch synthesis with device compute via a
bounded queue on a worker thread (double buffering by default).  A batch
for a CUDA device is made on the CPU and copied up from pinned memory
without blocking (``data.synthetic.to_device``), so the worker never
synchronizes the device.  Placement on a mesh (the reference's
``NamedSharding`` of each batch entry) comes with the dry-run slice
(ROADMAP queue 1, item 14g).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

__all__ = ["Prefetcher", "make_lm_stream"]


class Prefetcher:
    """Bounded background prefetch over a step-indexed batch function;
    iterating yields ``(step, batch)`` in step order.  ``close()`` stops
    and joins the worker."""

    def __init__(
        self,
        batch_fn: Callable[[int], Dict],
        start_step: int = 0,
        depth: int = 2,
    ):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_lm_stream(cfg, batch: int, seq: int, seed: int = 0, start_step: int = 0,
                   device="cpu") -> Prefetcher:
    """A :class:`Prefetcher` of ``data.synthetic.lm_batch`` batches on
    ``device``, from ``start_step`` on."""
    from repro_torch.data.synthetic import lm_batch

    return Prefetcher(lambda s: lm_batch(cfg, s, batch, seq, seed, device=device),
                      start_step=start_step)
