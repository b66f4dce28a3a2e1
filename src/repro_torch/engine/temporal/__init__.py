"""Temporal delta serving: band-level frame diffing and output reuse.

Consecutive video frames usually change a few bands (a static camera
changes almost none); the band decomposition the engine already serves on
makes that reuse addressable:

* :mod:`~repro_torch.engine.temporal.band_diff` — per-band content
  digests, halo-reach dirty-set dilation, and host-side slab/bounds
  marshalling in the one true ``core.fusion.halo_slabs`` geometry;
* :mod:`~repro_torch.engine.temporal.output_cache` — a bounded, refcounted
  LRU of upscaled HR output bands (tensors on the session's device) keyed
  by (plan, dtype, band, window digest);
* :mod:`~repro_torch.engine.temporal.delta_stream` — :class:`DeltaSession`,
  which dispatches only dirty bands (``SRServer.submit_bands`` ->
  partial-band dispatches through the micro-batch scheduler) and splices
  clean bands from the cache on the device, bit-exact with a full
  re-upscale.

Entry points: ``SRServer.stream(delta=True)`` for the async streaming path,
or a :class:`DeltaSession` directly for synchronous per-frame control.
Stats land in ``session.stats()['temporal']``.
"""

from repro_torch.engine.temporal.band_diff import (
    BAND_DIGEST_ALGO,
    band_bounds,
    band_digest,
    band_digests,
    band_input_rows,
    band_slabs,
    changed_bands,
    dilate_dirty,
    halo_reach,
    window_digest,
    window_rows,
)
from repro_torch.engine.temporal.delta_stream import DeltaSession
from repro_torch.engine.temporal.output_cache import DEFAULT_CACHE_BYTES, OutputBandCache

__all__ = [
    "BAND_DIGEST_ALGO",
    "DEFAULT_CACHE_BYTES",
    "DeltaSession",
    "OutputBandCache",
    "band_bounds",
    "band_digest",
    "band_digests",
    "band_input_rows",
    "band_slabs",
    "changed_bands",
    "dilate_dirty",
    "halo_reach",
    "window_digest",
    "window_rows",
]
