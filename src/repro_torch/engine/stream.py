"""VideoStream — DEPRECATED fixed-batch driver, a shim over SRSession.

.. deprecated::
    Use :class:`repro_torch.engine.SRSession`: ``session.upscale(clip)``
    replaces ``stream.run`` and ``session.stats()`` replaces
    ``stream.stats()``.  ``VideoStream`` remains for callers that hand-build
    an :class:`~repro_torch.engine.SRPlan` and want one pinned (plan, batch
    size) executor; it wraps ``SRSession.from_plan(plan, layers,
    bucket=batch_size)``.

``process`` is strict about the batch size; ``run`` serves clips of any
length by zero-padding the tail batch (same executor) and trimming the
output, and only real frames count in the throughput stats.  The executor
is always warmed on a dummy in the dtype being served, so no ``process``
call's recorded latency includes a build.  The shim pins
``pipeline_depth=1`` (every batch blocks before the next dispatches) and
serves through the same server drain as everyone else: ``run`` is
``upscale`` is ``submit().result()``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fusion import ConvLayer
from repro_torch.engine.plan import SRPlan
from repro_torch.engine.session import SRSession, StreamStats

__all__ = ["VideoStream", "StreamStats"]


class VideoStream:
    def __init__(
        self,
        plan: SRPlan,
        layers: Sequence[ConvLayer],
        batch_size: int = 1,
        dtype=torch.float32,
        device=None,
    ):
        warnings.warn(
            "VideoStream is deprecated; use repro_torch.engine.SRSession "
            "(session.upscale(clip) replaces stream.run)",
            DeprecationWarning,
            stacklevel=2,
        )
        if batch_size < 1:
            raise ValueError(f"batch_size={batch_size} must be >= 1")
        self.plan = plan
        self.batch_size = batch_size
        # the dtype this stream is expected to serve: warmup builds for it
        self.dtype = SRSession.serving_dtype(dtype)
        self._session = SRSession.from_plan(
            plan, layers, bucket=batch_size, pipeline_depth=1, donate_frames=False,
            device=device,
        )

    @property
    def session(self) -> SRSession:
        """The underlying session (one pinned plan + bucket)."""
        return self._session

    # ------------------------------------------------------------------
    def warmup(self) -> float:
        """Warm the executor for the serving dtype; returns its warm-up
        seconds (the cached figure if already warm)."""
        entry, _ = self._session.executor_for(self.plan, self.batch_size, self.dtype)
        return entry.compile_s

    def process(self, frames, real_frames: Optional[int] = None) -> torch.Tensor:
        """Run one batch (N, H, W, C) -> HR, recording its latency.

        The batch size must match the stream's.  ``real_frames`` counts only
        that many leading frames in the throughput stats (the rest are
        padding); the full batch is returned.
        """
        if frames.shape[0] != self.batch_size:
            raise ValueError(
                f"stream built for batch {self.batch_size}, got {frames.shape[0]}"
            )
        n_real = self.batch_size if real_frames is None else real_frames
        if not 0 <= n_real <= self.batch_size:
            raise ValueError(f"real_frames={n_real} outside [0, {self.batch_size}]")
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        frames = frames.to(SRSession.serving_dtype(frames.dtype))
        return self._session.serve_batch(self.plan, frames, real_frames=n_real)

    def run(self, frames) -> torch.Tensor:
        """Stream a clip (T, H, W, C) through in batch-size chunks; the tail
        is zero-padded to the batch (same executor) and trimmed.  Returns
        the (T, sH, sW, C) HR sequence."""
        if frames.ndim != 4:
            raise ValueError(f"expected a clip (T, H, W, C), got shape {tuple(frames.shape)}")
        return self._session.upscale(frames)

    # ------------------------------------------------------------------
    def cache_stats(self) -> dict:
        """The pinned session's executor-cache counters."""
        return self._session.cache_stats()

    def stats(self) -> StreamStats:
        return self._session.stats(batch_size=self.batch_size)

    def reset_stats(self) -> None:
        self._session.reset_stats()
