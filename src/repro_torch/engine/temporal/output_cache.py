"""Bounded, refcounted cache of upscaled HR output bands.

The value side of delta serving: once a band's receptive-field window has
been upscaled, the HR rows are kept keyed by ``(plan, dtype, band_index,
window_digest)`` so the next frame that presents the same window bytes
splices them back instead of recomputing.

Values are tensors on the session's device (the HR rows the executor
produced there): the splice runs on the device, so a band that hits the
cache never crosses to the host.

Semantics:

* LRU bounded by ``max_bytes`` of stored HR band payload.  Eviction walks
  from the least recently used entry and skips pinned ones.
* Pins are refcounts: a :class:`~repro_torch.engine.temporal.delta_stream.
  DeltaSession` pins every band of its current frame (the splice sources
  for the next frame) and releases the previous frame's pins after each
  step, so an abandoned stream that calls ``close()`` leaves
  ``pinned == 0``.  If every entry is pinned the cache may transiently
  exceed ``max_bytes`` (``bytes > max_bytes`` in :meth:`stats` shows it)
  rather than evict a band another frame is about to splice.
* Counters — hits/misses/evictions/puts/``bytes_saved`` (HR bytes served
  from cache instead of recomputed) — feed the session's ``temporal``
  stats section.

Thread safety: a single lock guards the map and counters.  ``put`` copies
the value *before* taking the lock; values are handed out as stored, and
callers copy out of them and must not mutate them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, Optional

import torch

__all__ = ["DEFAULT_CACHE_BYTES", "OutputBandCache"]

# Generous for the design-point stream (360x640 -> x3: a 60-row HR band is
# ~4.1 MB fp32, one 1080x1920 HR frame ~24.9 MB) while still bounding a long
# multi-plan session.  Override per stream via ``cache_bytes``.
DEFAULT_CACHE_BYTES = 256 * 1024 * 1024


@dataclass
class _Entry:
    value: torch.Tensor
    nbytes: int
    pins: int = 0


class OutputBandCache:
    """LRU + refcount cache of HR output bands (see module docstring)."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        if max_bytes < 1:
            raise ValueError(f"max_bytes={max_bytes} must be positive")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0
        self.bytes_saved = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def peek(self, key: Hashable) -> Optional[torch.Tensor]:
        """Presence probe: no counters, no recency touch."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e.value

    def get(self, key: Hashable, *, pin: bool = False) -> Optional[torch.Tensor]:
        """Counted lookup; a hit refreshes recency and adds bytes_saved.
        ``pin=True`` takes a reference atomically with the hit; a miss pins
        nothing."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.bytes_saved += e.nbytes
            if pin:
                e.pins += 1
            return e.value

    def put(self, key: Hashable, value: torch.Tensor, *, pin: bool = False) -> None:
        """Insert an HR band (no-op if present: same key => same bytes).
        ``pin=True`` takes a reference atomically with the insert — the
        entry survives the eviction pass its own insert may trigger."""
        # an owned contiguous copy, made OUTSIDE the lock: the value is
        # usually a slice of a larger dispatch result, and storing the view
        # would keep the whole parent alive
        owned = value.clone(memory_format=torch.contiguous_format)
        nbytes = owned.numel() * owned.element_size()
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                if pin:
                    e.pins += 1
                return
            self._entries[key] = _Entry(owned, nbytes, pins=1 if pin else 0)
            self._bytes += nbytes
            self.puts += 1
            self._evict_over_budget()

    def pin(self, key: Hashable) -> None:
        """Take a reference on an entry (it becomes non-evictable)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise KeyError(f"cannot pin missing cache entry {key!r}")
            e.pins += 1

    def unpin(self, key: Hashable) -> None:
        """Drop a reference; the entry becomes evictable at zero pins."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise KeyError(f"cannot unpin missing cache entry {key!r}")
            if e.pins <= 0:
                raise ValueError(f"unbalanced unpin for cache entry {key!r}")
            e.pins -= 1
            if e.pins == 0:
                self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        # caller holds self._lock
        if self._bytes <= self.max_bytes:
            return
        for key in list(self._entries):
            if self._bytes <= self.max_bytes:
                return
            e = self._entries[key]
            if e.pins > 0:
                continue
            del self._entries[key]
            self._bytes -= e.nbytes
            self.evictions += 1

    @property
    def pinned(self) -> int:
        """Number of entries currently holding at least one pin."""
        with self._lock:
            return sum(1 for e in self._entries.values() if e.pins > 0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "pinned": sum(1 for e in self._entries.values() if e.pins > 0),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "evictions": self.evictions,
                "puts": self.puts,
                "bytes_saved": self.bytes_saved,
            }
