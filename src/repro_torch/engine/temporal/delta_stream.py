"""Delta-aware video serving: diff, dispatch dirty bands, splice.

:class:`DeltaSession` is the temporal subsystem's driver.  Per frame:

1. bring the frame to the host in the session's serving dtype (a tensor is
   copied once) and digest every band's own rows
   (``band_diff.band_digests``);
2. diff against the previous frame's digests and dilate the changed set by
   the halo reach (``band_diff.dilate_dirty``) — a changed band
   invalidates every neighbour whose receptive field it feeds;
3. verify the splice partition (``analysis.plan_check.verify_delta_cover``):
   the dirty set plus the cached clean bands must cover every output row
   exactly once and dominate the dilation — a violation raises before
   anything dispatches;
4. dispatch ONLY the dirty bands as one partial-band request
   (``SRServer.submit_bands`` -> ``Dispatch.band_subset`` through the
   micro-batch scheduler), with input slabs marshalled on the host in the
   exact ``core.fusion.halo_slabs`` geometry;
5. splice the HR frame on the session's device: fresh rows from the
   dispatch, clean rows from the
   :class:`~repro_torch.engine.temporal.output_cache.OutputBandCache`,
   keyed by ``(plan, dtype, band, window_digest)`` — the digest of the
   band's full receptive-field window, so a hit PROVES the cached rows were
   computed from byte-identical input.

That proof is the bit-exactness argument end to end: identical window bytes
-> identical executor input (band slabs mirror ``halo_slabs`` byte for
byte) -> identical per-band computation (the band executor runs the same
per-band sweep or K1 launch as the full-frame path, whose output for a band
depends neither on the other bands in the call nor on K1's segment count)
-> identical HR rows.

Delta streams are sequential by construction — frame k's dirty set needs
frame k-1's digests — so there is no cross-frame lookahead, and they
bypass the server's degrade dtype ladder (a mid-clip downcast would poison
the cache).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.temporal.band_diff import (
    band_digests,
    band_input_rows,
    band_slabs,
    changed_bands,
    dilate_dirty,
    window_digest,
)
from repro_torch.engine.temporal.output_cache import OutputBandCache

__all__ = ["DeltaSession"]


def _host_frame(frame, dtype: torch.dtype) -> np.ndarray:
    """The frame on the host, in the serving dtype, as numpy.  bfloat16,
    which numpy cannot hold, travels as its int16 bits (digested, and cut
    into slabs that are viewed as bfloat16 again)."""
    t = frame if isinstance(frame, torch.Tensor) else torch.from_numpy(frame)
    t = t.to(device="cpu", dtype=dtype).contiguous()  # one copy for a card tensor
    if dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class DeltaSession:
    """Serve a video stream delta-aware against one hosted session.

    ``session`` must use a banded backend (``tilted`` | ``kernel``).
    ``server`` defaults to the session's hosting (or embedded) server;
    ``cache_bytes`` bounds the shared output cache (only applied when this
    call creates it).  Not thread-safe per instance (the cache it shares
    is); run one ``DeltaSession`` per stream.

    ``last_ms`` holds the host milliseconds of the last frame's phases:
    ``digest`` (host copy, digests, dilation, cover check), ``dispatch``
    (slab marshalling and ``submit_bands`` to result, the device wait
    included; 0 when nothing was dirty) and ``splice`` (enqueueing the
    device splice; the copies may still run after ``serve`` returns).
    """

    def __init__(self, session, *, server=None, priority: int = 0,
                 cache_bytes: Optional[int] = None):
        if session.backend == "reference":
            raise ValueError(
                "delta serving needs a banded backend (tilted or kernel); "
                "the reference backend computes whole frames"
            )
        self.session = session
        self._server = server if server is not None else session._host_server()
        self._model = self._server._name_for(session)
        self._priority = int(priority)
        self._cache: OutputBandCache = session.output_cache(cache_bytes)
        self._plan = None
        self._prev_own: Optional[Tuple[bytes, ...]] = None
        self._prev_window: List[Optional[bytes]] = []
        self._pinned: List[tuple] = []
        self._inflight = None
        self._closed = False
        self.frames = 0
        self.last_ms: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _reset_plan(self, plan) -> None:
        """A resolution/plan switch resets temporal state (digests keyed to
        the old geometry are meaningless); the old plan's pins are
        released."""
        for key in self._pinned:
            self._cache.unpin(key)
        self._pinned = []
        self._plan = plan
        self._prev_own = None
        self._prev_window = [None] * plan.num_bands

    def serve(self, frame) -> torch.Tensor:
        """Upscale one ``(H, W, C)`` frame (numpy array or tensor), reusing
        cached output bands; blocking.  Returns the HR frame as a tensor on
        the session's device."""
        if self._closed:
            raise RuntimeError("DeltaSession is closed")
        session = self.session
        t0 = time.perf_counter()
        if not isinstance(frame, torch.Tensor):
            frame = np.ascontiguousarray(frame)
        if frame.ndim != 3:
            raise ValueError(
                f"DeltaSession serves single (H, W, C) frames, got rank {frame.ndim}"
            )
        dtype = session.serving_dtype(frame.dtype)
        arr = _host_frame(frame, dtype)
        dtype_name = session.dtype_name(dtype)
        plan = session.plan_for(tuple(int(x) for x in arr.shape))
        if plan is not self._plan:
            self._reset_plan(plan)
        num_bands = plan.num_bands
        own = band_digests(arr, plan.band_rows)
        if self._prev_own is None:
            changed = set(range(num_bands))
        else:
            changed = changed_bands(own, self._prev_own)
        dirty = dilate_dirty(changed, num_bands, plan.band_rows, plan.num_layers,
                             plan.vertical_policy)
        # window digests: recomputed for dirty bands; a clean band's window
        # is unchanged by the dilation invariant, so its digest carries over
        window = list(self._prev_window)
        for b in dirty:
            window[b] = window_digest(arr, plan.band_rows, plan.num_layers, b,
                                      plan.vertical_policy)

        def key(b: int) -> tuple:
            return (plan, dtype_name, b, window[b])

        # a clean band must be resident to splice — normally guaranteed by
        # the previous frame's pins, but re-serve it if the cache was
        # cleared externally (pure cost, never a correctness issue)
        clean = []
        for b in range(num_bands):
            if b in dirty:
                continue
            if self._cache.peek(key(b)) is None:
                dirty.add(b)
            else:
                clean.append(b)
        self._verify_cover(plan, dirty, changed)
        t1 = time.perf_counter()
        dirty_list = sorted(dirty)
        hr_bands = None
        if dirty_list:
            slabs = torch.from_numpy(band_slabs(arr, plan.band_rows, plan.num_layers,
                                                dirty_list, plan.vertical_policy))
            if dtype == torch.bfloat16:
                slabs = slabs.view(torch.bfloat16)
            fut = self._server.submit_bands(slabs, dirty_list, plan=plan, model=self._model,
                                            priority=self._priority)
            self._inflight = fut
            try:
                hr_bands = fut.result()
            finally:
                self._inflight = None
        t2 = time.perf_counter()
        # --- splice, on the device ------------------------------------
        # Pin-on-access (put/get with pin=True): this frame's bands are the
        # next frame's splice sources, and the pin must be atomic with the
        # insert/lookup.  On any failure mid-splice the partial pin set is
        # released before re-raising.
        out_dtype = hr_bands.dtype if hr_bands is not None else session.output_dtype(plan, dtype)
        hr_rows = plan.band_rows * plan.scale
        keys: List[tuple] = []
        try:
            with self._server.device_stream(session):
                out = torch.empty(plan.hr_shape, dtype=out_dtype, device=session.device)
                for i, b in enumerate(dirty_list):
                    out[b * hr_rows:(b + 1) * hr_rows] = hr_bands[i]
                    self._cache.put(key(b), hr_bands[i], pin=True)
                    keys.append(key(b))
                for b in clean:
                    rows = self._cache.get(key(b), pin=True)
                    if rows is None:  # pragma: no cover - pinned on entry
                        raise RuntimeError(
                            f"clean band {b} vanished from the output cache "
                            "mid-splice (its previous-frame pin was released "
                            "externally)"
                        )
                    keys.append(key(b))
                    out[b * hr_rows:(b + 1) * hr_rows] = rows
        except BaseException:
            for k in keys:
                self._cache.unpin(k)
            raise
        for k in self._pinned:
            self._cache.unpin(k)
        self._pinned = keys
        t3 = time.perf_counter()
        self.last_ms = {"digest": (t1 - t0) * 1e3, "dispatch": (t2 - t1) * 1e3,
                        "splice": (t3 - t2) * 1e3}
        self._account(plan, num_bands, len(dirty_list), arr.itemsize, out.element_size())
        self._prev_own = own
        self._prev_window = window
        self.frames += 1
        return out

    def _verify_cover(self, plan, dirty, changed) -> None:
        """The plan_check splice rule, enforced before anything dispatches."""
        from repro_torch.analysis.plan_check import verify_delta_cover

        errors = [f for f in verify_delta_cover(plan, sorted(dirty),
                                                changed_bands=sorted(changed))
                  if f.severity == "error"]
        if errors:
            with self._server._lock:
                self.session._temporal_counts["cover_violations"] += len(errors)
            raise RuntimeError(
                "delta splice invariant violated:\n" + "\n".join(f.format() for f in errors)
            )

    def _account(self, plan, num_bands: int, served: int, in_size: int, out_size: int) -> None:
        """Per-frame reuse accounting (the ``temporal`` stats section): the
        traffic model is LR slab bytes read plus HR band bytes written, per
        frame; weights are resident either way and excluded.  The counters
        are the session's, shared by every stream on it, so they move under
        the server lock that guards its other serving counters."""
        t = self.session._temporal_counts
        slab_rows = band_input_rows(plan.band_rows, plan.num_layers, plan.vertical_policy)
        lr_band_bytes = slab_rows * plan.width * plan.in_channels * in_size
        hr_band_bytes = (plan.band_rows * plan.scale * plan.width * plan.scale
                         * plan.in_channels * out_size)
        with self._server._lock:
            t["frames"] += 1
            t["bands_total"] += num_bands
            t["bands_skipped"] += num_bands - served
            t["band_rows_total"] += num_bands * plan.band_rows
            t["band_rows_served"] += served * plan.band_rows
            t["hbm_bytes_full"] += num_bands * (lr_band_bytes + hr_band_bytes)
            t["hbm_bytes_served"] += served * (lr_band_bytes + hr_band_bytes)

    def stats(self) -> dict:
        """The owning session's ``temporal`` stats section."""
        return self.session.temporal_stats()

    def close(self) -> None:
        """Release every cache pin (and cancel an in-flight dispatch, if the
        stream was abandoned mid-serve).  Idempotent."""
        if self._closed:
            return
        self._closed = True
        fut = self._inflight
        if fut is not None:
            self._server.cancel(fut)
            self._inflight = None
        for k in self._pinned:
            self._cache.unpin(k)
        self._pinned = []

    def __enter__(self) -> "DeltaSession":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
