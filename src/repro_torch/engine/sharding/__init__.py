"""Sharded multi-device serving: band-sharded execution + replica routing.

The tilted decomposition's band structure maps directly onto a device
mesh: a ``bands`` axis splits each frame's row bands spatially (with the
L-row halo exchange ``core.fusion.halo_slabs`` geometry implies at shard
edges), and a ``replica`` axis runs independent copies of the executor
for data parallelism.  Three layers:

  * ``mesh_plan``  — :class:`MeshSpec` / :class:`ShardedPlan`: topology +
    plan validation (band counts must split across shards).
  * ``shard_exec`` — :func:`build_sharded_executor`: the band loop once
    per shard, each on its mesh position's stream, with the margin
    exchange at shard edges; bit-exact vs the single-device executor by
    construction.
  * ``router``     — :class:`ReplicaRouter`: per-replica executor caches +
    prepared stacks, round-robin / least-loaded dispatch routing.

One process drives the whole mesh (``repro_torch.launch.mesh.Mesh``),
whose positions may repeat a device: everything runs on the CPU with
``make_sr_mesh(R, S, device="cpu")``, and on one card with
``devices=[torch.device("cuda:0")] * (R * S)``.
"""

from repro_torch.engine.sharding.mesh_plan import (
    MeshSpec,
    ShardedPlan,
    check_shardable,
    ensure_shardable,
)
from repro_torch.engine.sharding.router import ROUTE_POLICIES, ReplicaRouter
from repro_torch.engine.sharding.shard_exec import (
    build_sharded_executor,
    frame_spec,
    halo_exchange_bytes_per_frame,
)

__all__ = [
    "MeshSpec",
    "ShardedPlan",
    "check_shardable",
    "ensure_shardable",
    "ReplicaRouter",
    "ROUTE_POLICIES",
    "build_sharded_executor",
    "frame_spec",
    "halo_exchange_bytes_per_frame",
]
