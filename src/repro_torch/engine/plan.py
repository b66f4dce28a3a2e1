"""SRPlan — the single description of a super-resolution execution.

An :class:`SRPlan` captures everything the execution paths need — geometry
(bands, tile columns, the :class:`~repro_torch.core.tiling.TileSchedule`),
numerics (fp32 / bf16 / int8-dequant), vertical boundary policy and backend
— in one validated, hashable object that is built once and reused across
frames.  The executor layer (``engine.executor``) binds a plan + weight
stack into one callable over a batch of frames.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.tiling import TileSchedule, make_schedule

__all__ = [
    "SRPlan",
    "make_plan",
    "check_layer_channels",
    "derive_band_rows",
    "legal_band_rows",
    "shardable_band_rows",
    "BACKENDS",
    "PRECISIONS",
    "VERTICAL_POLICIES",
]

BACKENDS = ("reference", "tilted", "kernel")
PRECISIONS = ("fp32", "bf16", "int8")
VERTICAL_POLICIES = ("zero", "halo", "replicate")

# The paper's design point: 60-row bands for 360-row frames.  Requests for
# other heights derive a legal band height near this (derive_band_rows).
PREFERRED_BAND_ROWS = 60

# Below this band height the per-band recompute/boundary overhead dominates
# (the 3x3 stack's receptive field spans 2L+1 rows); rather than slice a
# frame into slivers, fall back to a single full-height band.
MIN_BAND_ROWS = 8


def legal_band_rows(
    height: int,
    preferred: int = PREFERRED_BAND_ROWS,
    min_rows: int = MIN_BAND_ROWS,
) -> List[int]:
    """ALL legal ``band_rows`` for a frame height, best-default first.

    Banded backends need ``height % band_rows == 0``, so the legal space
    is the divisors of ``height`` that are not degenerate slivers
    (``>= min_rows``), plus the always-legal full-height single band.
    Sorted by distance from ``preferred`` (the paper's 60-row design
    point), ties preferring the divisor ``<= preferred`` — so element 0
    is a sensible default and the whole list is the autotuner's
    ``band_rows`` candidate axis.
    """
    if height <= 0:
        raise ValueError(f"height={height} must be positive")
    divisors = [d for d in range(min_rows, height + 1) if height % d == 0]
    if height not in divisors:
        divisors.append(height)  # one full-height band is always legal
    return sorted(divisors, key=lambda d: (abs(d - preferred), d > preferred))


def derive_band_rows(
    height: int,
    preferred: int = PREFERRED_BAND_ROWS,
    min_rows: int = MIN_BAND_ROWS,
) -> int:
    """The DEFAULT legal ``band_rows`` for an arbitrary frame height.

    Pick the largest divisor of ``height`` that is ``<= preferred`` (the
    paper's 60-row design point); if the only such divisors are degenerate
    slivers (``< min_rows``, e.g. a prime height), serve the frame as one
    full-height band — always legal for any positive height.  The full
    candidate space this default is drawn from is :func:`legal_band_rows`.
    """
    if height <= 0:
        raise ValueError(f"height={height} must be positive")
    if height <= preferred:
        return height
    candidates = [d for d in legal_band_rows(height, preferred, min_rows)
                  if d <= preferred]
    return max(candidates) if candidates else height


def shardable_band_rows(
    height: int,
    band_shards: int,
    preferred: int = PREFERRED_BAND_ROWS,
    min_rows: int = MIN_BAND_ROWS,
) -> Optional[int]:
    """Best legal ``band_rows`` whose band count splits across shards.

    Band-sharded execution places ``num_bands // band_shards`` whole bands
    on each device along the ``bands`` mesh axis, so it needs
    ``(height // band_rows) % band_shards == 0`` on top of the usual
    divisibility.  Returns the highest-preference such divisor from
    :func:`legal_band_rows`, or ``None`` when no legal decomposition
    exists (e.g. more shards than bands at every legal ``band_rows``).
    """
    if band_shards <= 0:
        raise ValueError(f"band_shards={band_shards} must be positive")
    for d in legal_band_rows(height, preferred, min_rows):
        if (height // d) % band_shards == 0:
            return d
    return None


def _is_degenerate_fallback(height: int, band_rows: int, preferred: int) -> bool:
    """True when a derived ``band_rows`` is the one-giant-band fallback —
    the frame is TALLER than the preferred band yet serves as a single
    band (e.g. a prime height with no legal divisor)."""
    return band_rows == height and height > preferred


@dataclasses.dataclass(frozen=True)
class SRPlan:
    """Static plan for running an SR conv stack over LR frames.

    Geometry:
      height/width/in_channels: LR frame shape (H, W, C0).
      num_layers: L, depth of the fused conv stack.
      band_rows: R, rows per band (paper: 60 for 360-row frames).
      tile_cols: C, parallelepiped width of the tilted sweep (paper: 8).
    Numerics:
      precision: ``fp32`` | ``bf16`` | ``int8`` (int8 = symmetric
        weight quantisation with dequant-on-read, ``core.quant``).
    Policy:
      vertical_policy: ``zero`` | ``halo`` | ``replicate`` band boundaries.
      backend: ``reference`` | ``tilted`` | ``kernel`` datapath.
    Output:
      scale: pixel-shuffle upscale factor (anchor residual is added).
      clip: clip HR output to [0, 1].
    Diagnostics:
      degenerate_bands: the derived ``band_rows`` was the one-giant-band
        fallback (a taller-than-preferred frame with no legal divisor,
        e.g. a prime height).  Metadata only — excluded from equality and
        hashing so plan/cache keys are unaffected.
    """

    height: int
    width: int
    in_channels: int = 3
    num_layers: int = 7
    band_rows: int = 60
    tile_cols: int = 8
    vertical_policy: str = "zero"
    backend: str = "tilted"
    precision: str = "fp32"
    scale: int = 3
    clip: bool = True
    degenerate_bands: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0 or self.in_channels <= 0:
            raise ValueError(
                f"frame shape ({self.height}, {self.width}, {self.in_channels}) "
                "must be positive"
            )
        if self.num_layers <= 0:
            raise ValueError(f"num_layers={self.num_layers} must be positive")
        if self.scale < 1:
            raise ValueError(f"scale={self.scale} must be >= 1")
        if self.band_rows <= 0:
            raise ValueError(f"band_rows={self.band_rows} must be positive")
        if self.backend != "reference" and self.height % self.band_rows != 0:
            # the reference backend has no bands; only banded datapaths
            # need the height to partition evenly
            raise ValueError(
                f"height {self.height} must be a multiple of "
                f"band_rows {self.band_rows} for backend {self.backend!r}"
            )
        if self.tile_cols < 2:
            raise ValueError(
                f"tile_cols={self.tile_cols} must be >= 2 "
                "(overlap hand-off is 2 columns)"
            )
        if self.vertical_policy not in VERTICAL_POLICIES:
            raise ValueError(
                f"vertical_policy {self.vertical_policy!r} not in {VERTICAL_POLICIES}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r} not in {PRECISIONS}")

    # ------------------------------------------------------------------
    # Derived geometry
    # ------------------------------------------------------------------
    @property
    def num_bands(self) -> int:
        return self.height // self.band_rows

    @property
    def schedule(self) -> TileSchedule:
        """The tilted sweep geometry shared by every backend."""
        return make_schedule(
            width=self.width, tile_cols=self.tile_cols, num_layers=self.num_layers
        )

    @property
    def lr_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.in_channels)

    @property
    def hr_shape(self) -> Tuple[int, int, int]:
        return (self.height * self.scale, self.width * self.scale, self.in_channels)

    @property
    def stack_key(self) -> Tuple[str, str]:
        """Key of the device-resident prepared weight stack this plan's
        executor consumes.  Weight preparation (numerics policy + kernel
        packing) depends only on ``(precision, backend)`` — NOT on frame
        geometry, bucket or serving dtype — so every resolution/bucket a
        session serves shares one ``PreparedStack`` under this key."""
        return (self.precision, self.backend)

    def check_invariants(self) -> None:
        """Validate the full plan: field constraints ran in ``__post_init__``;
        this additionally asserts the tilted schedule's hand-off invariants
        for every (tile, layer)."""
        self.schedule.check_invariants()

    def verify(self, **kwargs):
        """Statically verify this plan (band coverage, halo sufficiency, the
        Hopper kernels' shared memory, the Table II budget) and return the
        list of :class:`~repro_torch.analysis.findings.Finding` diagnostics —
        empty when clean.  Keyword overrides (``channels``, ``budget_kb``,
        ``halo_margin``, ``band_shards``) pass through to
        :func:`repro_torch.analysis.plan_check.verify_plan`."""
        from repro_torch.analysis.plan_check import verify_plan  # lazy: no cycle

        return verify_plan(self, **kwargs)

    # ------------------------------------------------------------------
    # Construction from a serving request
    # ------------------------------------------------------------------
    @classmethod
    def from_request(
        cls,
        lr_shape: Tuple[int, int, int],
        *,
        num_layers: int,
        band_rows: int | None = None,
        tile_cols: int = 8,
        vertical_policy: str = "zero",
        backend: str = "tilted",
        precision: str = "fp32",
        scale: int = 3,
        clip: bool = True,
        preferred_band_rows: int = PREFERRED_BAND_ROWS,
        validate: bool = True,
        tuner: Optional[object] = None,
        bucket: Optional[int] = None,
    ) -> "SRPlan":
        """Build a plan for an arbitrary request shape — the ONE owner of
        the shape -> geometry derivation.

        ``band_rows=None`` derives a legal band height for the incoming
        frame (:func:`derive_band_rows`), so any positive ``(H, W, C)`` is
        servable without the caller knowing the banding rules.  This is
        what :class:`~repro_torch.engine.session.SRSession` calls per new
        resolution; ``make_plan`` routes through it with an explicit
        ``band_rows``.

        ``tuner`` (an object with a ``band_rows_for(**config)`` method) is
        consulted BEFORE the default derivation: if its tuning database
        holds a measured-best ``band_rows`` for this exact configuration
        (optionally at batch ``bucket``), that schedule wins; a miss falls
        back to the unchanged defaults.  The tuner only ever returns
        numerics-safe overrides (see ``PlanTuner.band_rows_for``).

        A derived one-giant-band fallback (a taller-than-preferred frame
        with no legal divisor, e.g. a prime height) is no longer silent:
        it warns and the plan records ``degenerate_bands=True``.
        """
        if len(lr_shape) != 3:
            raise ValueError(f"lr_shape {lr_shape!r} must be (H, W, C)")
        H, W, C = (int(x) for x in lr_shape)
        degenerate = False
        if band_rows is None:
            if tuner is not None:
                band_rows = tuner.band_rows_for(
                    lr_shape=(H, W, C),
                    num_layers=num_layers,
                    tile_cols=tile_cols,
                    vertical_policy=vertical_policy,
                    backend=backend,
                    precision=precision,
                    scale=scale,
                    clip=clip,
                    bucket=bucket,
                )
            if band_rows is None:
                band_rows = derive_band_rows(H, preferred_band_rows)
                # a tuner override is a MEASURED choice, never degenerate;
                # only the silent default fallback warrants the signal
                degenerate = _is_degenerate_fallback(H, band_rows,
                                                     preferred_band_rows)
            if degenerate:
                warnings.warn(
                    f"height {H} has no band decomposition with bands in "
                    f"[{MIN_BAND_ROWS}, {preferred_band_rows}] rows; serving "
                    f"as ONE {H}-row band (degenerate_bands=True on the "
                    "plan) — banded backends lose their streaming locality "
                    "at this height",
                    RuntimeWarning,
                    stacklevel=2,
                )
        plan = cls(
            height=H,
            width=W,
            in_channels=C,
            num_layers=num_layers,
            band_rows=band_rows,
            tile_cols=tile_cols,
            vertical_policy=vertical_policy,
            backend=backend,
            precision=precision,
            scale=scale,
            clip=clip,
            degenerate_bands=degenerate,
        )
        if validate:
            plan.check_invariants()
        return plan


def make_plan(
    layers: Sequence,
    lr_shape: Tuple[int, int, int],
    *,
    band_rows: int = 60,
    tile_cols: int = 8,
    vertical_policy: str = "zero",
    backend: str = "tilted",
    precision: str = "fp32",
    scale: int = 3,
    clip: bool = True,
    validate: bool = True,
) -> SRPlan:
    """Build (and optionally fully validate) an :class:`SRPlan` from a conv
    stack and an LR frame shape.

    ``layers`` is a ``Sequence[ConvLayer]`` — only its length and input
    channel count are read, so quantised stacks work too.
    """
    if len(layers) == 0:
        raise ValueError("layer stack is empty")
    H, W, C0 = lr_shape
    plan = SRPlan.from_request(
        (H, W, C0),
        num_layers=len(layers),
        band_rows=band_rows,
        tile_cols=tile_cols,
        vertical_policy=vertical_policy,
        backend=backend,
        precision=precision,
        scale=scale,
        clip=clip,
        validate=False,
    )
    check_layer_channels(layers, C0, scale)
    if validate:
        plan.check_invariants()
    return plan


def check_layer_channels(layers: Sequence, in_channels: int, scale: int) -> None:
    """Assert a conv stack fits ``in_channels`` frames and the anchor +
    pixel-shuffle epilogue at ``scale`` (shared by ``make_plan`` and
    ``SRSession``)."""
    lc = getattr(layers[0], "ci", None)
    if lc is not None and lc != in_channels:
        raise ValueError(
            f"layer stack expects {lc} input channels, frames have {in_channels}"
        )
    co = getattr(layers[-1], "co", None)
    if co is not None and co != in_channels * scale * scale:
        raise ValueError(
            f"final layer produces {co} channels; the anchor + pixel-shuffle "
            f"epilogue needs in_channels * scale^2 = {in_channels * scale * scale}"
        )
