"""Tilted tile geometry (paper §II, Fig. 2) — numpy only.

The tilted layer fusion schedule partitions a feature-map band (R rows tall,
W image columns wide) into *parallelepipedal* tiles: tile ``k`` at layer ``l``
(the conv producing feature map ``F_{l+1}`` from ``F_l``) covers output
columns ``[k*C - l, k*C - l + C)`` — each layer's tile region is shifted one
column LEFT of the previous layer's, because a 3x3 conv consumes a one-column
halo per side.

Consequences (all encoded here and checked by :meth:`check_invariants`):

* RIGHT boundary: layer ``l`` needs ``F_l`` up to column ``k*C - l + C``
  (inclusive); the same tile's layer ``l-1`` just produced ``F_l`` up to
  exactly that column — data is ready with zero waiting and zero storage.
* LEFT boundary: layer ``l`` needs ``F_l`` columns ``k*C - l - 1`` and
  ``k*C - l``; these are precisely the LAST TWO columns of ``F_l`` produced
  by tile ``k-1`` — retained in the overlap buffer (paper §III-F).
* The overlap buffer therefore stores, for each of the L fused feature maps
  ``F_0 .. F_{L-1}``, two columns of R rows: ``M_o = L * R * 2 * max(Ch)``
  (paper eq. 2).

Column coordinates here are *absolute image columns*; negative columns and
columns ``>= W`` are phantom (outside the image). Phantom columns must read
as zero wherever consumed so the fused result matches SAME-padded
convolution exactly — see :func:`phantom_mask`.

This module is the PyTorch package's own copy of the geometry: it has no
dependency on the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

__all__ = [
    "TileSchedule",
    "make_schedule",
    "phantom_mask",
]


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """Static geometry of a tilted layer-fusion sweep over one band.

    Attributes:
      width: W, image width in columns.
      tile_cols: C, tile width in columns (paper uses 8).
      num_layers: L, number of fused conv layers (paper's ABPN uses 7).
      num_tiles: K, total tiles per band *including* the epilogue tiles that
        flush the last output columns (the final layer's tile is shifted
        L-1 columns left, so ``K = ceil((W + L - 1) / C)``).
    """

    width: int
    tile_cols: int
    num_layers: int

    def __post_init__(self):
        if self.width <= 0 or self.tile_cols <= 0 or self.num_layers <= 0:
            raise ValueError(
                f"width={self.width}, tile_cols={self.tile_cols}, "
                f"num_layers={self.num_layers} must all be positive"
            )

    @property
    def num_tiles(self) -> int:
        """K — includes epilogue tiles that flush the tilted tail."""
        return math.ceil((self.width + self.num_layers - 1) / self.tile_cols)

    def out_cols(self, k: int, layer: int) -> Tuple[int, int]:
        """Absolute [start, stop) columns of F_{layer+1} produced by tile k."""
        start = k * self.tile_cols - layer
        return start, start + self.tile_cols

    def in_cols(self, k: int, layer: int) -> Tuple[int, int]:
        """Absolute [start, stop) columns of F_layer consumed by tile k.

        A 3x3 conv over output columns [a, a+C) reads input [a-1, a+C+1).
        """
        a, b = self.out_cols(k, layer)
        return a - 1, b + 1

    def overlap_cols(self, k: int, layer: int) -> Tuple[int, int]:
        """The two F_layer columns tile k reads from the overlap buffer."""
        a, _ = self.in_cols(k, layer)
        return a, a + 2

    def saved_cols(self, k: int, feature: int) -> Tuple[int, int]:
        """The two columns of F_feature tile k writes INTO the overlap buffer.

        ``feature`` 0 is the band input; features 1..L-1 are intermediate
        outputs.  These are always the last two columns tile k holds of that
        feature map.
        """
        if feature == 0:
            _, b = self.in_cols(k, 0)
            return b - 2, b
        _, b = self.out_cols(k, feature - 1)
        return b - 2, b

    def fresh_input_cols(self, k: int) -> Tuple[int, int]:
        """Absolute F_0 columns streamed from device memory for tile k.

        The input slab of tile k is ``in_cols(k, 0)`` = C+2 columns; the left
        two arrive from the overlap buffer (saved by tile k-1), so only C
        fresh columns stream per tile.
        """
        a, b = self.in_cols(k, 0)
        return a + 2, b

    @property
    def final_offset(self) -> int:
        """Column of F_L produced first (tile 0): ``-(L-1)``."""
        return -(self.num_layers - 1)

    def check_invariants(self) -> None:
        """Check the schedule's correctness properties for every tile/layer.

        1. Right-readiness: layer l's input never extends past what layer
           l-1 of the SAME tile has produced.
        2. Left-overlap: the two left input columns of tile k, layer l are
           exactly the columns tile k-1 saved for feature l.
        3. Output coverage: final-layer outputs of consecutive tiles are
           contiguous and disjoint, and their union covers [0, W).
        """
        L, W, K = self.num_layers, self.width, self.num_tiles
        for k in range(K):
            for l in range(L):
                in_a, in_b = self.in_cols(k, l)
                if l > 0:
                    prod_a, prod_b = self.out_cols(k, l - 1)
                    assert in_b <= prod_b, (k, l, in_b, prod_b)
                    assert in_a + 2 == prod_a, (k, l)
                if k > 0:
                    sa, sb = self.saved_cols(k - 1, l)
                    oa, ob = self.overlap_cols(k, l)
                    assert (sa, sb) == (oa, ob), (k, l, (sa, sb), (oa, ob))
        lo = self.out_cols(0, L - 1)[0]
        hi = self.out_cols(K - 1, L - 1)[1]
        assert lo <= 0 and hi >= W, (lo, hi, W)
        for k in range(K - 1):
            assert self.out_cols(k, L - 1)[1] == self.out_cols(k + 1, L - 1)[0]

    def table(self) -> List[dict]:
        """Every (tile, layer)'s column ranges, for analysis and debugging."""
        rows = []
        for k in range(self.num_tiles):
            for l in range(self.num_layers):
                rows.append(
                    dict(
                        tile=k,
                        layer=l,
                        in_cols=self.in_cols(k, l),
                        out_cols=self.out_cols(k, l),
                        overlap_read=self.overlap_cols(k, l),
                        overlap_write=self.saved_cols(k, l),
                    )
                )
        return rows


def make_schedule(width: int, tile_cols: int, num_layers: int) -> TileSchedule:
    """Build a :class:`TileSchedule`."""
    return TileSchedule(width=width, tile_cols=tile_cols, num_layers=num_layers)


def phantom_mask(col_start: int, num_cols: int, width: int) -> np.ndarray:
    """Boolean mask over ``num_cols`` absolute columns starting at ``col_start``.

    True for real image columns ``0 <= c < width``; False for phantom columns.
    Phantom columns produced by the tilted sweep MUST be zeroed before they
    are consumed by the next layer, otherwise values computed from edge
    padding leak into real columns and the result diverges from SAME-padded
    convolution.
    """
    cols = np.arange(col_start, col_start + num_cols)
    return (cols >= 0) & (cols < width)
