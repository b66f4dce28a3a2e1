"""Input pipeline: deterministic generation, background prefetch and mesh
placement — the port of ``repro.data.pipeline``.

``Prefetcher`` overlaps host-side batch synthesis with device compute via a
bounded queue on a worker thread (double buffering by default).  A batch
for a CUDA device is made on the CPU and copied up from pinned memory
without blocking (``data.synthetic.to_device``), so the worker never
synchronizes the device.  When a mesh context is active
(``distributed.partitioning.axis_rules``), ``make_lm_stream`` places each
batch entry on the mesh by its logical axes (a ``partitioning.Sharded``),
the reference's ``NamedSharding`` ``device_put``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

from repro_torch.config import resolve_device
from repro_torch.distributed import partitioning as pt

__all__ = ["Prefetcher", "make_lm_stream"]


class Prefetcher:
    """Bounded background prefetch over a step-indexed batch function;
    iterating yields ``(step, batch)`` in step order, each batch passed
    through ``place`` (when given) on the worker.  ``close()`` stops and
    joins the worker."""

    def __init__(
        self,
        batch_fn: Callable[[int], Dict],
        start_step: int = 0,
        depth: int = 2,
        place: Optional[Callable] = None,
    ):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._place = place
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fn(step)
            if self._place is not None:
                batch = self._place(batch)
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
                   batch_axes: Optional[Dict] = None, device=None) -> Prefetcher:
    """A :class:`Prefetcher` of ``data.synthetic.lm_batch`` batches on
    ``device`` (default the CUDA card; raises where there is none), from
    ``start_step`` on.  Under an active mesh with ``batch_axes`` given, each
    entry is placed on the mesh by ``partitioning.shape_aware_spec``."""
    from repro_torch.data.synthetic import lm_batch

    device = resolve_device("cuda" if device is None else device)
    place = None
    mesh = pt.current_mesh()
    if mesh is not None and batch_axes:
        def place(b):
            return {k: pt.place(v, pt.NamedSharding(
                        mesh, pt.shape_aware_spec(batch_axes[k], v.shape, mesh)))
                    for k, v in b.items()}

    return Prefetcher(lambda s: lm_batch(cfg, s, batch, seq, seed, device=device),
                      start_step=start_step, place=place)
