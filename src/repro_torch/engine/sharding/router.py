"""Replica routing: coalesced dispatches over the ``replica`` mesh axis.

Band sharding splits one frame's rows across mesh positions; replication
runs whole micro-batches on independent position groups.
``ReplicaRouter`` owns the per-replica state the session would otherwise
hold once globally — a warmed-executor
:class:`~repro_torch.engine.session.PlanCache` and refcounted
``PreparedStack`` copies, one per distinct device of the replica — and
picks a replica per dispatch:

  * ``round_robin`` — strict rotation, ignores load.
  * ``least_loaded`` — fewest in-flight dispatches, ties broken by fewest
    total dispatches then lowest index (the default: keeps replicas full
    under uneven batch sizes).

The replica axis never appears inside an executor: each replica's
executor is band-sharded over its own 1-D ``bands`` submesh
(:func:`repro_torch.launch.mesh.band_submesh`) of the session's mesh, so
routing is pure host-side bookkeeping and the outputs are bit-exact
regardless of which replica served a request.

Thread-safety: the server calls :meth:`executor_for` / :meth:`note_launch`
under its drain lock and :meth:`note_complete` from completion handling —
the router's counters piggyback on that external serialization, same as
the session's own caches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.engine.executor import prepare_stack
from repro_torch.engine.sharding.mesh_plan import MeshSpec, ShardedPlan
from repro_torch.engine.sharding.shard_exec import (
    build_sharded_executor,
    halo_exchange_bytes_per_frame,
)
from repro_torch.launch.mesh import SRMesh, band_submesh

__all__ = ["ReplicaRouter", "ROUTE_POLICIES"]

ROUTE_POLICIES = ("round_robin", "least_loaded")


@dataclasses.dataclass
class _Replica:
    """One replica's positions + its private serving state."""

    index: int
    mesh: Optional[SRMesh]
    cache: "PlanCache"  # noqa: F821 - imported lazily (session cycle)
    stacks: dict
    inflight: int = 0
    dispatches: int = 0
    frames: int = 0


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class ReplicaRouter:
    """Route ``executor_for`` calls across replicas of a serving mesh.

    The mesh is the session's (``spec.mesh``, built by the session from
    its ``mesh=`` argument), so an explicit ``devices=`` placement is
    served as given.
    """

    def __init__(
        self,
        session,
        spec: MeshSpec,
        *,
        policy: str = "least_loaded",
        cache_capacity: Optional[int] = None,
    ):
        from repro_torch.engine.session import PlanCache  # lazy: session imports us

        if policy not in ROUTE_POLICIES:
            raise ValueError(f"route policy {policy!r} not in {ROUTE_POLICIES}")
        if spec.mesh is None:
            raise ValueError("the router needs the session's SRMesh (spec.mesh)")
        self.session = session
        self.spec = spec
        self.policy = policy
        self.mesh = spec.mesh
        capacity = cache_capacity or getattr(session._cache, "capacity", 8)
        self._replicas: List[_Replica] = []
        for r in range(spec.replicas):
            rep = _Replica(
                index=r,
                mesh=band_submesh(self.mesh, r),
                cache=PlanCache(
                    capacity,
                    on_evict=lambda key, entry, _r=r: self._on_evict(_r, entry),
                ),
                stacks={},
            )
            self._replicas.append(rep)
        self._rr = 0
        self._compile_counts: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    # Replica selection
    # ------------------------------------------------------------------
    def pick(self) -> int:
        """The replica index the next dispatch should run on."""
        if self.policy == "round_robin":
            idx = self._rr % len(self._replicas)
            self._rr += 1
            return idx
        return min(
            self._replicas,
            key=lambda rep: (rep.inflight, rep.dispatches, rep.index),
        ).index

    def home_device(self, replica: int) -> torch.device:
        """The device a replica's dispatches arrive on (its first position)."""
        return self._replicas[replica].mesh.devices[0]

    # ------------------------------------------------------------------
    # Per-replica executor cache (mirrors SRSession.executor_for)
    # ------------------------------------------------------------------
    def _acquire_stack(self, rep: _Replica, plan) -> Tuple[dict, tuple]:
        """The replica's prepared weights for this plan's numerics, one
        ``PreparedStack`` per distinct device of the replica (not per
        position), prepared on first use and refcounted per cache entry."""
        skey = plan.stack_key
        rec = rep.stacks.get(skey)
        if rec is None:
            from repro_torch.engine.session import _StackRecord  # lazy

            t0 = time.perf_counter()
            devices = rep.mesh.distinct_devices()
            stacks = {
                d: prepare_stack(plan, [l.to(device=d) for l in self.session.layers])
                for d in devices
            }
            _synchronize(devices)
            rec = _StackRecord(stack=stacks, refs=0, prepare_s=time.perf_counter() - t0)
            rep.stacks[skey] = rec
        rec.refs += 1
        return rec.stack, skey

    def _release_stack(self, rep: _Replica, skey: tuple) -> None:
        rec = rep.stacks.get(skey)
        if rec is None:
            return
        rec.refs -= 1
        if rec.refs <= 0:
            del rep.stacks[skey]

    def _on_evict(self, replica: int, entry) -> None:
        self._release_stack(self._replicas[replica], entry.stack_key)

    def executor_for(self, plan, bucket: int, dtype):
        """A warmed band-sharded executor on the next routed replica.

        Returns ``(entry, built_now)`` exactly like
        ``SRSession.executor_for``; ``entry.replica`` records the routing
        decision so the server can credit launch/complete back via
        :meth:`note_launch` / :meth:`note_complete`.  A miss runs the
        executor once on a zero dummy and synchronizes the replica's
        devices; that time is the entry's ``compile_s``.
        """
        from repro_torch.engine.session import SRSession, _CacheEntry  # lazy

        rep = self._replicas[self.pick()]
        dtype = SRSession.serving_dtype(dtype)
        key = SRSession.cache_key(plan, bucket, dtype)
        entry = rep.cache.get(key)
        if entry is not None:
            return entry, False
        splan = ShardedPlan(plan=plan, spec=self.spec)
        stacks, skey = self._acquire_stack(rep, plan)
        try:
            fn = build_sharded_executor(splan, stacks, rep.mesh)
            dummy = torch.zeros((bucket, *plan.lr_shape), dtype=dtype,
                                device=rep.mesh.devices[0])
            t0 = time.perf_counter()
            fn(dummy)
            _synchronize(rep.mesh.distinct_devices())
            compile_s = time.perf_counter() - t0
        except BaseException:
            self._release_stack(rep, skey)
            raise
        entry = _CacheEntry(
            fn=fn,
            plan=plan,
            bucket=int(bucket),
            dtype=SRSession.dtype_name(dtype),
            compile_s=compile_s,
            stack_key=skey,
            donates=False,
            replica=rep.index,
        )
        ckey = (rep.index, *key)
        self._compile_counts[ckey] = self._compile_counts.get(ckey, 0) + 1
        rep.cache.put(key, entry)
        return entry, True

    # ------------------------------------------------------------------
    # Load accounting (driven by SRServer launch/complete)
    # ------------------------------------------------------------------
    def note_launch(self, replica: int, frames: int = 0) -> None:
        rep = self._replicas[replica]
        rep.inflight += 1
        rep.dispatches += 1
        rep.frames += frames

    def note_complete(self, replica: int) -> None:
        rep = self._replicas[replica]
        rep.inflight = max(0, rep.inflight - 1)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def clear(self) -> None:
        """Evict every replica's executors + prepared weights."""
        for rep in self._replicas:
            rep.cache.clear()

    def replica_fill(self) -> float:
        """Dispatch balance across replicas: 1.0 = perfectly even, ->0 as
        one replica takes all the traffic (mean / max dispatches)."""
        counts = [rep.dispatches for rep in self._replicas]
        peak = max(counts, default=0)
        if peak == 0:
            return 0.0
        return (sum(counts) / len(counts)) / peak

    def stats(self) -> dict:
        plan_probe = None
        for rep in self._replicas:
            for entry in rep.cache.entries():
                plan_probe = entry.plan
                break
            if plan_probe is not None:
                break
        return {
            "mesh": self.spec.descriptor,
            "devices": self.spec.devices_needed,
            "policy": self.policy,
            "replica_fill": self.replica_fill(),
            "halo_bytes_per_frame": (
                0 if plan_probe is None else halo_exchange_bytes_per_frame(
                    plan_probe, self.spec.band_shards
                )
            ),
            "replicas": [
                {
                    "index": rep.index,
                    "dispatches": rep.dispatches,
                    "frames": rep.frames,
                    "inflight": rep.inflight,
                    "cache": rep.cache.stats(),
                }
                for rep in self._replicas
            ],
        }
