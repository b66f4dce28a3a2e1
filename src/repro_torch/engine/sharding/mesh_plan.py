"""Mesh-aware plan wrapping: ``SRPlan`` + device-mesh topology.

The tilted decomposition already splits a frame into independent R-row
bands whose only coupling is the L-row halo ``core.fusion.halo_slabs``
defines.  A :class:`MeshSpec` names the two ways that structure maps onto
devices:

  * ``band_shards`` (mesh axis ``bands``): each device owns
    ``num_bands // band_shards`` whole bands of every frame.  Halo policy
    ``halo`` needs an L-row exchange at shard edges (``shard_exec``);
    ``zero``/``replicate`` shard with no communication at all.
  * ``replicas`` (mesh axis ``replica``): whole micro-batches are routed to
    independent copies of the executor (``router``) — pure data
    parallelism, never visible inside an executor.

:class:`ShardedPlan` validates that a plan's band geometry actually splits
across the requested shards and derives the per-shard local plan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.engine.plan import SRPlan, shardable_band_rows
from repro_torch.launch.mesh import SR_BAND_AXIS, SR_REPLICA_AXIS, SRMesh

__all__ = [
    "MeshSpec",
    "ShardedPlan",
    "check_shardable",
    "ensure_shardable",
]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Serving-mesh topology: ``replicas x band_shards`` devices.

    ``mesh`` keeps the :class:`~repro_torch.launch.mesh.SRMesh` the spec
    was taken from (its devices and streams), when there was one; it takes
    no part in equality.
    """

    replicas: int = 1
    band_shards: int = 1
    mesh: Optional[SRMesh] = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self.replicas <= 0 or self.band_shards <= 0:
            raise ValueError(
                f"mesh axes must be positive, got replicas={self.replicas} "
                f"band_shards={self.band_shards}"
            )

    @classmethod
    def coerce(
        cls, value: Union["MeshSpec", SRMesh, Tuple[int, int], None]
    ) -> "MeshSpec":
        """Accept a MeshSpec, an SR mesh (its shape, and the mesh kept), a
        ``(replicas, band_shards)`` tuple, or None."""
        if value is None:
            return cls()
        if isinstance(value, MeshSpec):
            return value
        if isinstance(value, SRMesh):
            if value.axis_names != (SR_REPLICA_AXIS, SR_BAND_AXIS):
                raise ValueError(
                    f"mesh must have axes ({SR_REPLICA_AXIS!r}, {SR_BAND_AXIS!r}), "
                    f"got {value.axis_names}"
                )
            return cls(replicas=value.shape[0], band_shards=value.shape[1], mesh=value)
        try:
            replicas, band_shards = value
        except (TypeError, ValueError):
            raise ValueError(
                "mesh must be a MeshSpec, an SRMesh or a (replicas, band_shards) "
                f"pair, got {value!r}"
            ) from None
        return cls(replicas=int(replicas), band_shards=int(band_shards))

    @property
    def devices_needed(self) -> int:
        return self.replicas * self.band_shards

    @property
    def descriptor(self) -> str:
        """Topology stamp, e.g. ``"2x4"`` — autotune DB validity key."""
        return f"{self.replicas}x{self.band_shards}"

    @property
    def is_trivial(self) -> bool:
        return self.devices_needed == 1


def check_shardable(plan: SRPlan, band_shards: int) -> Optional[str]:
    """Why ``plan`` cannot band-shard ``band_shards`` ways (None = it can)."""
    if band_shards <= 1:
        return None
    if plan.backend == "reference":
        return (
            "reference backend computes over the full frame and cannot "
            "band-shard; use the tilted or kernel backend"
        )
    bands = plan.num_bands
    if bands % band_shards != 0:
        return (
            f"{bands} bands (height {plan.height} / band_rows "
            f"{plan.band_rows}) do not split into {band_shards} equal "
            "shards"
        )
    return None


def ensure_shardable(
    plan: SRPlan, spec: MeshSpec, preferred: Optional[int] = None
) -> SRPlan:
    """Return ``plan`` (or a re-banded copy) legal for ``spec``.

    If the plan's current ``band_rows`` does not split across the shards,
    try the best legal alternative from :func:`shardable_band_rows`;
    raise ``ValueError`` when no decomposition exists.
    """
    err = check_shardable(plan, spec.band_shards)
    if err is None:
        return plan
    if plan.backend == "reference":
        raise ValueError(err)
    kwargs = {} if preferred is None else {"preferred": preferred}
    rows = shardable_band_rows(plan.height, spec.band_shards, **kwargs)
    if rows is None:
        raise ValueError(
            f"no legal band_rows splits height {plan.height} across "
            f"{spec.band_shards} band shards ({err})"
        )
    return dataclasses.replace(plan, band_rows=rows)


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """An ``SRPlan`` bound to a mesh topology (validated at construction)."""

    plan: SRPlan
    spec: MeshSpec = MeshSpec()

    def __post_init__(self) -> None:
        err = check_shardable(self.plan, self.spec.band_shards)
        if err is not None:
            raise ValueError(f"plan not shardable over {self.spec}: {err}")

    @property
    def local_plan(self) -> SRPlan:
        """The per-shard plan: same bands/tiles, ``1/S`` of the rows.

        Each shard runs the ordinary band loop over its own contiguous row
        block, so the local plan is just the global one with
        ``height / band_shards`` rows — band_rows, tile_cols and numerics
        are untouched and the schedule is identical per band.
        """
        s = self.spec.band_shards
        if s == 1:
            return self.plan
        return dataclasses.replace(self.plan, height=self.plan.height // s)

    @property
    def bands_per_shard(self) -> int:
        return self.plan.num_bands // self.spec.band_shards

    def verify(self, **kwargs):
        """Static verification including shard-boundary halo checks."""
        from repro_torch.analysis.plan_check import verify_plan

        kwargs.setdefault("band_shards", self.spec.band_shards)
        return verify_plan(self.plan, **kwargs)
