"""Staged SR models: a model that is not one chain of fused 3x3 convs.

A :class:`StagedModel` is a list of stages run in order over a frame batch,
each reading the output of the one before it:

* a :class:`Segment` — consecutive SAME 3x3 conv layers that K1 runs fused,
  in one launch over the frames' bands; its ``residual`` names an earlier
  value (0: the model's input, i: stage i - 1's output), added to the last
  layer's output after its activation (a residual block's skip);
* a whole-frame stage — any object with a ``name``, ``to(device, dtype)``
  and a call ``(x, clock=None)``, ``(N, H, W, C) -> (N, H, W, C')`` in the
  frames' dtype (``clock``: the dispatch's stage clock, on which its
  kernels note their launches), for work
  that ties each output pixel to the whole frame (RLFN's ESA, whose resize
  from a pooled map reaches every row), so that it cannot be cut into bands.

The last stage's output is the features the epilogue pixel-shuffles, with
the anchor added where ``anchor`` says so.  The executor runs a plain
``ConvLayer`` chain (ABPN) as one segment with the anchor
(``engine.executor.prepare_stack``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.fusion import ConvLayer

__all__ = ["Segment", "StagedModel"]


@dataclasses.dataclass(frozen=True)
class Segment:
    """Consecutive SAME 3x3 convs fused into one K1 launch, plus a residual
    (the index of an earlier value) added after the last activation."""

    layers: Tuple[ConvLayer, ...]
    residual: Optional[int] = None

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def to(self, device=None, dtype=None) -> "Segment":
        return Segment(tuple(l.to(device=device, dtype=dtype) for l in self.layers),
                       self.residual)


@dataclasses.dataclass(frozen=True)
class StagedModel:
    """An SR model as stages in order (:class:`Segment` or whole-frame) and
    whether the epilogue adds the anchor."""

    stages: tuple
    anchor: bool = False

    def __post_init__(self):
        if not self.stages or not isinstance(self.stages[0], Segment):
            raise ValueError("a staged model starts with a K1 segment")
        if not isinstance(self.stages[-1], Segment):
            raise ValueError("a staged model ends with a K1 segment (the epilogue's features)")
        for i, st in enumerate(self.stages):
            if isinstance(st, Segment):
                if not st.layers:
                    raise ValueError(f"stage {i} is a segment with no layers")
                if st.residual is not None and not 0 <= st.residual <= i:
                    raise ValueError(f"stage {i}'s residual reads value {st.residual}, "
                                     f"not one of the values 0..{i} before it")

    @property
    def conv_layers(self) -> Tuple[ConvLayer, ...]:
        """Every segment's layers in order: the first reads the frames' channels,
        the last writes the epilogue's."""
        return tuple(l for st in self.stages if isinstance(st, Segment) for l in st.layers)

    @property
    def max_depth(self) -> int:
        return max(st.num_layers for st in self.stages if isinstance(st, Segment))

    def to(self, device=None, dtype=None) -> "StagedModel":
        return StagedModel(tuple(st.to(device=device, dtype=dtype) for st in self.stages),
                           self.anchor)
