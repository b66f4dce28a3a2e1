"""Per-band frame diffing for temporal delta serving.

Video streams change a few bands per frame (a static camera changes
almost none); the band decomposition the engine already serves on makes
that reuse addressable.  This module provides the *content* side of the
delta path:

* digests — a cheap content hash per band.  ``band_digests`` hashes each
  band's OWN input rows (change detection between consecutive frames);
  ``window_digest`` hashes the band's full receptive-field WINDOW — own
  rows plus the halo margin rows its stacked 3x3 convs read — which is
  what the output actually depends on, so it keys the output cache.
* dirty-set dilation — a changed band feeds the receptive field of its
  neighbors under the ``halo`` policy, so the dirty set must be dilated
  by the halo reach (``ceil(L / R)`` bands for an L-deep stack over
  R-row bands; 0 for ``zero``/``replicate``, whose bands are
  independent).  The invariant the splice relies on:

      band not in dilate(changed)  =>  its window rows are unchanged
                                   =>  its cached output is still exact.

* slab/bounds construction — host-side mirrors of the one true
  ``core.fusion.halo_slabs`` geometry, so a partial-band dispatch feeds
  the kernel byte-identical inputs to what the full-frame path would
  have marshalled (tests cross-check them against ``halo_slabs``).

Numpy only: digests are of host bytes, and the digests of a numpy frame
equal the JAX package's byte for byte (same algorithm, same dtype fold).

Digests are ``blake2b(digest_size=16)`` over the raw bytes of the
serving-dtype-cast rows, with the dtype folded into the hash (same
bytes under a different dtype must not collide).  blake2b is in the
standard library — no xxhash dependency — and 16 bytes keeps keys
small while making accidental collision probability negligible.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "BAND_DIGEST_ALGO",
    "band_digest",
    "band_digests",
    "band_input_rows",
    "band_slabs",
    "band_bounds",
    "changed_bands",
    "dilate_dirty",
    "halo_reach",
    "window_digest",
    "window_rows",
]

BAND_DIGEST_ALGO = "blake2b-128"


def _digest_rows(frame: np.ndarray, lo: int, hi: int) -> bytes:
    """Digest of ``frame[lo:hi]`` with the dtype folded in."""
    h = hashlib.blake2b(digest_size=16)
    h.update(frame.dtype.str.encode("ascii"))
    rows = frame[lo:hi]
    if not rows.flags["C_CONTIGUOUS"]:
        rows = np.ascontiguousarray(rows)
    h.update(rows)
    return h.digest()


def band_digest(frame: np.ndarray, band_rows: int, band: int) -> bytes:
    """Digest of band ``band``'s own input rows."""
    return _digest_rows(frame, band * band_rows, (band + 1) * band_rows)


def band_digests(frame: np.ndarray, band_rows: int) -> Tuple[bytes, ...]:
    """Own-rows digest of every band of a (H, W, C) frame."""
    height = frame.shape[0]
    if height % band_rows != 0:
        raise ValueError(
            f"height {height} is not a multiple of band_rows {band_rows}"
        )
    return tuple(
        band_digest(frame, band_rows, b) for b in range(height // band_rows)
    )


def changed_bands(
    digests: Sequence[bytes], prev: Sequence[bytes]
) -> Set[int]:
    """Bands whose own-rows digest differs from the previous frame's."""
    if len(digests) != len(prev):
        raise ValueError(
            f"digest count changed between frames: {len(prev)} -> "
            f"{len(digests)} (same plan implies same band count)"
        )
    return {b for b, (d, p) in enumerate(zip(digests, prev)) if d != p}


def halo_reach(band_rows: int, num_layers: int, vertical_policy: str) -> int:
    """How many neighbor bands a changed band invalidates, per side.

    Under ``halo`` a band's receptive field reaches L real rows past its
    own, so a change in band b touches every band whose window overlaps
    rows [b*R, b*R + R): reach = ceil(L / R) bands (1 at the paper's
    design point, L=7 over R=60).  ``zero``/``replicate`` bands never
    read neighbor rows: reach 0.
    """
    if vertical_policy != "halo":
        return 0
    return -(-num_layers // band_rows)


def dilate_dirty(
    changed: Iterable[int],
    num_bands: int,
    band_rows: int,
    num_layers: int,
    vertical_policy: str,
) -> Set[int]:
    """Dilate the changed-band set by the halo reach (clipped to range)."""
    reach = halo_reach(band_rows, num_layers, vertical_policy)
    dirty: Set[int] = set()
    for b in changed:
        b = int(b)
        if not 0 <= b < num_bands:
            raise ValueError(f"changed band {b} out of range [0, {num_bands})")
        lo = max(0, b - reach)
        hi = min(num_bands, b + reach + 1)
        dirty.update(range(lo, hi))
    return dirty


def window_rows(
    height: int,
    band_rows: int,
    num_layers: int,
    band: int,
    vertical_policy: str,
) -> Tuple[int, int]:
    """Real-row interval [lo, hi) a band's output depends on.

    ``halo``: own rows widened by L per side, clipped to the frame (the
    out-of-frame part of the margin is constant zero padding, identical
    for every frame at the same band index, so it carries no content and
    stays out of the digest).  ``zero``/``replicate``: own rows only.
    """
    lo = band * band_rows
    hi = lo + band_rows
    if vertical_policy == "halo":
        lo = max(0, lo - num_layers)
        hi = min(height, hi + num_layers)
    return lo, hi


def window_digest(
    frame: np.ndarray,
    band_rows: int,
    num_layers: int,
    band: int,
    vertical_policy: str,
) -> bytes:
    """Digest of the receptive-field window — the output-cache key digest."""
    lo, hi = window_rows(
        frame.shape[0], band_rows, num_layers, band, vertical_policy
    )
    return _digest_rows(frame, lo, hi)


def band_input_rows(
    band_rows: int, num_layers: int, vertical_policy: str
) -> int:
    """Input rows per dispatched band slab (R + 2L under ``halo``)."""
    if vertical_policy == "halo":
        return band_rows + 2 * num_layers
    return band_rows


def band_slabs(
    frame: np.ndarray,
    band_rows: int,
    num_layers: int,
    bands: Sequence[int],
    vertical_policy: str,
) -> np.ndarray:
    """Host-side input slabs for a band subset of one (H, W, C) frame.

    Mirrors ``core.fusion.halo_slabs`` exactly (L rows of zero padding
    above and below the frame; slab b = padded rows [b*R, b*R + R + 2L))
    so a partial dispatch is byte-identical to the corresponding rows of
    a full-frame dispatch — the bit-exact splice guarantee starts here.
    """
    height, width, chans = frame.shape
    rows = band_input_rows(band_rows, num_layers, vertical_policy)
    out = np.zeros((len(bands), rows, width, chans), frame.dtype)
    if vertical_policy == "halo":
        padded = np.zeros((height + 2 * num_layers, width, chans), frame.dtype)
        padded[num_layers : num_layers + height] = frame
        for i, b in enumerate(bands):
            out[i] = padded[b * band_rows : b * band_rows + rows]
    else:
        for i, b in enumerate(bands):
            out[i] = frame[b * band_rows : (b + 1) * band_rows]
    return out


def band_bounds(
    height: int,
    band_rows: int,
    num_layers: int,
    bands: Sequence[int],
    *,
    slots: int = 0,
) -> np.ndarray:
    """Per-slab valid-row bounds, the ``halo_slabs`` formula verbatim.

    Row r of slab b is a real frame row iff ``lo <= r < hi`` with
    ``lo = clip(L - b*R, 0, rows)`` and ``hi = clip(L + H - b*R, 0,
    rows)``; rows outside are phantom padding the kernel re-zeroes.
    ``slots`` pads the array to a bucket size; padded slots get (0, 0)
    (all rows phantom), so a padded slab computes zero features and its
    output rows are never read.
    """
    rows = band_rows + 2 * num_layers
    n = max(len(bands), slots)
    out = np.zeros((n, 2), np.int32)
    for i, b in enumerate(bands):
        lo = min(max(num_layers - b * band_rows, 0), rows)
        hi = min(max(num_layers + height - b * band_rows, 0), rows)
        out[i] = (lo, hi)
    return out
