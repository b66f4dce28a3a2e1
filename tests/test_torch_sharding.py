"""The PyTorch port's sharded serving vs the JAX package's.

Twins of every test in ``tests/test_sharding.py`` — MeshSpec/ShardedPlan
validation, shard-aware plan verification, the halo-exchange traffic
model, replica routing, the session's mesh validation, and multi-device
bit-exactness — plus parity with the JAX package.

The JAX tests force 8 host devices with ``XLA_FLAGS`` (in-process, or in
subprocesses); the port's mesh may repeat a device, so every twin runs
in-process on a mesh of ``cpu`` positions (``make_sr_mesh(R, S,
device="cpu")`` or ``devices=["cpu"] * n``).  The kernel backend runs K1's
plain version.

Sharded output is held to the port's single-device executor with
``torch.equal`` (bit-exact by construction, as in the JAX package), and to
the JAX single-device executor (``kernel`` in interpret mode) within the
README support matrix's tolerances: max abs diff 5e-4 fp32, 5e-2 bf16.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.engine.sharding import halo_exchange_bytes_per_frame as jhalo_bytes
from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.analysis.plan_check import required_halo_margin, verify_plan
from repro_torch.engine import executor
from repro_torch.engine.plan import SRPlan, shardable_band_rows
from repro_torch.engine.server import SRServer
from repro_torch.engine.session import SRSession
from repro_torch.engine.sharding import (
    MeshSpec,
    ReplicaRouter,
    ShardedPlan,
    build_sharded_executor,
    halo_exchange_bytes_per_frame,
)
from repro_torch.engine.sharding import shard_exec
from repro_torch.engine.sharding.mesh_plan import check_shardable, ensure_shardable
from repro_torch.engine.sharding.router import _Replica
from repro_torch.launch.mesh import SRMesh, band_submesh, make_sr_mesh
from repro_torch.models.abpn import layers_from_numpy
from repro_torch.runtime import resilience
from repro_torch.runtime.resilience import FailureInjector

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


CFG = ABPNConfig(num_layers=3, feature_channels=8)
JLAYERS = init_abpn(jax.random.PRNGKey(0), CFG)
LAYERS = layers_from_numpy(JLAYERS)
TOL = {"fp32": 5e-4, "int8": 5e-4, "bf16": 5e-2}


def small_plan(**kw):
    kw.setdefault("height", 24)
    kw.setdefault("width", 16)
    kw.setdefault("num_layers", 3)
    kw.setdefault("band_rows", 6)
    return SRPlan(**kw)


def frames_of(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def cpu_bands(shards):
    return band_submesh(make_sr_mesh(1, shards, device="cpu"), 0)


def session(**kw):
    kw.setdefault("autotune", "off")
    return SRSession(LAYERS, device="cpu", **kw)


def sharded(plan, shards, stack=None, mesh=None):
    stack = stack if stack is not None else engine.prepare_stack(plan, LAYERS)
    return build_sharded_executor(ShardedPlan(plan=plan, spec=MeshSpec(1, shards)), stack,
                                  mesh if mesh is not None else cpu_bands(shards))


def single(plan, frames):
    return engine.build_stack_executor(plan, engine.prepare_stack(plan, LAYERS))(frames)


# ----------------------------------------------------------------------
# The mesh (launch.mesh): the port's own
# ----------------------------------------------------------------------
def test_make_sr_mesh_on_cpu_and_band_submesh():
    mesh = make_sr_mesh(2, 3, device="cpu")
    assert mesh.shape == (2, 3) and mesh.axis_names == ("replica", "bands")
    assert mesh.devices == (torch.device("cpu"),) * 6 and mesh.streams == (None,) * 6
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    row = band_submesh(mesh, 1)
    assert row.shape == (3,) and row.axis_names == ("bands",) and row.size == 3
    explicit = make_sr_mesh(1, 2, devices=["cpu", torch.device("cpu")])
    assert explicit.devices == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("bad", [
    lambda: make_sr_mesh(0, 2, device="cpu"),
    lambda: make_sr_mesh(1, 2, devices=["cpu"]),  # 2 positions, 1 device
    lambda: make_sr_mesh(1, 2, devices=["cpu", "meta"]),  # mixed device types
    lambda: make_sr_mesh(1, 2, device="meta"),
    lambda: band_submesh(make_sr_mesh(2, 2, device="cpu"), 2),
    lambda: band_submesh(band_submesh(make_sr_mesh(2, 2, device="cpu"), 0), 0),
], ids=["axes", "count", "mixed", "kind", "replica", "not_sr"])
def test_make_sr_mesh_rejects(bad):
    with pytest.raises(ValueError):
        bad()


def test_mesh_spec_coerce_keeps_an_sr_mesh():
    mesh = make_sr_mesh(2, 2, device="cpu")
    spec = MeshSpec.coerce(mesh)
    assert spec == MeshSpec(2, 2) and spec.mesh is mesh
    with pytest.raises(ValueError):
        MeshSpec.coerce(band_submesh(mesh, 0))  # a bands row is not a serving mesh


# ----------------------------------------------------------------------
# MeshSpec
# ----------------------------------------------------------------------
def test_mesh_spec_coerce():
    assert MeshSpec.coerce(None) == MeshSpec(1, 1)
    assert MeshSpec.coerce((2, 4)) == MeshSpec(replicas=2, band_shards=4)
    spec = MeshSpec(3, 2)
    assert MeshSpec.coerce(spec) is spec


def test_mesh_spec_properties():
    spec = MeshSpec(replicas=2, band_shards=4)
    assert spec.devices_needed == 8
    assert spec.descriptor == "2x4"
    assert not spec.is_trivial
    assert MeshSpec().is_trivial


def test_mesh_spec_rejects_bad_values():
    with pytest.raises(ValueError):
        MeshSpec(0, 1)
    with pytest.raises(ValueError):
        MeshSpec(1, -2)
    with pytest.raises(ValueError):
        MeshSpec.coerce("2x4")  # strings are not topologies
    with pytest.raises(ValueError):
        MeshSpec.coerce((1, 2, 3))


# ----------------------------------------------------------------------
# Shardability: check / ensure / ShardedPlan
# ----------------------------------------------------------------------
def test_check_shardable():
    assert check_shardable(small_plan(), 1) is None
    assert check_shardable(small_plan(), 2) is None  # 4 bands / 2 shards
    err = check_shardable(small_plan(backend="reference"), 2)
    assert err is not None and "reference" in err
    err = check_shardable(small_plan(band_rows=24), 2)  # 1 band, 2 shards
    assert err is not None and "split" in err


def test_ensure_shardable_rebands():
    plan = small_plan(height=48, band_rows=48)  # 1 band: not 2-shardable
    fixed = ensure_shardable(plan, MeshSpec(1, 2))
    assert fixed.band_rows == 24 and fixed.num_bands == 2
    assert fixed.height == plan.height
    ok = small_plan()
    assert ensure_shardable(ok, MeshSpec(1, 2)) is ok  # untouched when legal
    with pytest.raises(ValueError):
        ensure_shardable(small_plan(backend="reference"), MeshSpec(1, 2))
    with pytest.raises(ValueError):
        # prime height: only the full-height single band is legal
        ensure_shardable(SRPlan(height=97, width=16, num_layers=3,
                                band_rows=97), MeshSpec(1, 2))


def test_shardable_band_rows():
    assert shardable_band_rows(360, 3) == 60  # paper frame: 6 bands / 3
    assert shardable_band_rows(48, 2) == 24
    assert shardable_band_rows(97, 2) is None
    with pytest.raises(ValueError):
        shardable_band_rows(48, 0)
    # the card's phase-4e geometry: 360 rows re-band to 60 (S=2), 45 (S=4)
    assert shardable_band_rows(360, 2) == 60 and shardable_band_rows(360, 4) == 45


def test_sharded_plan_local_geometry():
    splan = ShardedPlan(plan=small_plan(), spec=MeshSpec(1, 2))
    assert splan.local_plan.height == 12
    assert splan.local_plan.band_rows == 6
    assert splan.bands_per_shard == 2
    trivial = ShardedPlan(plan=small_plan())
    assert trivial.local_plan is trivial.plan
    with pytest.raises(ValueError):
        ShardedPlan(plan=small_plan(band_rows=24), spec=MeshSpec(1, 2))
    with pytest.raises(ValueError):
        ShardedPlan(plan=small_plan(backend="reference"), spec=MeshSpec(1, 2))


# ----------------------------------------------------------------------
# Shard-aware static verification (analysis.plan_check)
# ----------------------------------------------------------------------
def _shard_errors(findings):
    return [f for f in findings
            if f.rule.startswith("shard_") and f.severity == "error"]


def test_verify_plan_shard_halo_insufficiency_is_error():
    plan = small_plan(vertical_policy="halo")
    need = required_halo_margin(plan.num_layers)
    bad = verify_plan(plan, band_shards=2, shard_halo_margin=need - 1)
    errs = _shard_errors(bad)
    assert errs and errs[0].rule == "shard_halo_sufficiency"
    assert "shards=2" in errs[0].where
    # sufficient margin (the default, derived from the geometry) is clean
    good = verify_plan(plan, band_shards=2)
    assert not _shard_errors(good)


def test_verify_plan_shard_backend_and_alignment():
    ref = SRPlan(height=24, width=16, num_layers=3, backend="reference",
                 band_rows=24)
    errs = _shard_errors(verify_plan(ref, band_shards=2))
    assert errs and errs[0].rule == "shard_backend"
    one_band = small_plan(band_rows=24)
    errs = _shard_errors(verify_plan(one_band, band_shards=2))
    assert errs and errs[0].rule == "shard_band_alignment"


def test_verify_plan_unsharded_has_no_shard_findings():
    plan = small_plan(vertical_policy="halo")
    assert not [f for f in verify_plan(plan) if f.rule.startswith("shard_")]
    assert not [f for f in verify_plan(plan, band_shards=1)
                if f.rule.startswith("shard_")]


def test_sharded_plan_verify_threads_band_shards():
    splan = ShardedPlan(plan=small_plan(vertical_policy="halo"),
                        spec=MeshSpec(1, 2))
    assert not _shard_errors(splan.verify())
    errs = _shard_errors(splan.verify(shard_halo_margin=0))
    assert errs and errs[0].rule == "shard_halo_sufficiency"


# ----------------------------------------------------------------------
# Halo-exchange traffic model
# ----------------------------------------------------------------------
def test_halo_exchange_bytes_per_frame():
    plan = small_plan(vertical_policy="halo", width=32)
    # 2 directions * (S-1) edges * L rows * W * C0 * fp32
    assert halo_exchange_bytes_per_frame(plan, 2) == 2 * 1 * 3 * 32 * 3 * 4
    assert halo_exchange_bytes_per_frame(plan, 4) == 2 * 3 * 3 * 32 * 3 * 4
    assert halo_exchange_bytes_per_frame(plan, 1) == 0
    for policy in ("zero", "replicate"):
        p = small_plan(vertical_policy=policy, width=32)
        assert halo_exchange_bytes_per_frame(p, 4) == 0


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_halo_exchange_bytes_equal_the_jax_model(precision):
    from repro.engine.plan import SRPlan as JSRPlan

    for policy in ("zero", "halo", "replicate"):
        for shards in (1, 2, 4):
            kw = dict(height=360, width=640, num_layers=7, band_rows=45,
                      vertical_policy=policy, precision=precision)
            assert (halo_exchange_bytes_per_frame(SRPlan(**kw), shards)
                    == jhalo_bytes(JSRPlan(**kw), shards))
    # the card's geometry: fp32 halo at 360x640, L = 7
    halo = SRPlan(height=360, width=640, num_layers=7, band_rows=45,
                  vertical_policy="halo", precision=precision)
    full = {"fp32": 1, "int8": 1, "bf16": 2}[precision]
    assert halo_exchange_bytes_per_frame(halo, 2) == 107_520 // full
    assert halo_exchange_bytes_per_frame(halo, 4) == 322_560 // full


# ----------------------------------------------------------------------
# Replica routing policy (host-side logic; no devices required)
# ----------------------------------------------------------------------
def _bare_router(policy, n):
    r = ReplicaRouter.__new__(ReplicaRouter)
    r.policy = policy
    r._replicas = [_Replica(index=i, mesh=None, cache=None, stacks={})
                   for i in range(n)]
    r._rr = 0
    return r


def test_round_robin_rotation():
    r = _bare_router("round_robin", 3)
    assert [r.pick() for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]


def test_least_loaded_prefers_idle_then_cold():
    r = _bare_router("least_loaded", 3)
    assert r.pick() == 0  # all equal: lowest index
    r.note_launch(0)
    assert r.pick() == 1  # 0 has one in flight
    r.note_launch(1)
    assert r.pick() == 2
    r.note_launch(2)
    r.note_complete(1)
    # inflight: [1, 0, 1] -> replica 1
    assert r.pick() == 1
    r.note_complete(0)
    r.note_complete(2)
    # all idle again; dispatch history [1, 1, 1] ties -> lowest index
    assert r.pick() == 0


def test_note_complete_floors_at_zero():
    r = _bare_router("least_loaded", 2)
    r.note_complete(0)
    assert r._replicas[0].inflight == 0


def test_replica_fill():
    r = _bare_router("round_robin", 2)
    assert r.replica_fill() == 0.0  # no traffic yet
    r.note_launch(0)
    r.note_launch(1)
    assert r.replica_fill() == 1.0
    r.note_launch(0)
    r.note_launch(0)
    assert r.replica_fill() == pytest.approx(2 / 3)  # mean 2 / peak 3


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        ReplicaRouter(None, MeshSpec(1, 1), policy="random")


# ----------------------------------------------------------------------
# Session-level mesh validation
# ----------------------------------------------------------------------
def test_session_trivial_mesh_is_unsharded():
    s = session(mesh=(1, 1))
    assert s.mesh_spec is None and s._router is None
    assert s.sharding_stats() is None


def test_session_rejects_full_autotune_on_mesh():
    with pytest.raises(ValueError, match="full"):
        session(mesh=(1, 2), autotune="full")


def test_session_rejects_bogus_mesh():
    with pytest.raises(ValueError):
        session(mesh="2x4")


def test_session_mesh_needs_devices(monkeypatch):
    """Too few CUDA devices for the mesh fail at construction, before any
    weight moves to the card (one visible device, a 1x2 mesh)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices"):
        SRSession(LAYERS, mesh=(1, 2), autotune="off", device="cuda")
    with pytest.raises(ValueError, match="devices"):
        make_sr_mesh(1, 2, device="cuda")


def test_session_route_defaults_to_least_loaded():
    assert inspect.signature(SRSession).parameters["route"].default == "least_loaded"
    s = session(mesh=(2, 1), vertical_policy="halo")
    assert s.sharding_stats()["policy"] == "least_loaded"
    with pytest.raises(ValueError):
        session(mesh=(2, 1), route="random")


def test_session_takes_its_devices_and_tuner_stamp_from_the_mesh():
    mesh = make_sr_mesh(2, 2, devices=["cpu"] * 4)
    s = SRSession(LAYERS, mesh=mesh, autotune="cached")
    assert s.device == torch.device("cpu") and s.mesh_spec.mesh is mesh
    assert s._router.mesh is mesh  # the caller's mesh, not a default one
    assert s._tuner.mesh_shape == "2x2"
    with pytest.raises(ValueError, match="match"):
        SRSession(LAYERS, mesh=mesh, autotune="off", device="cuda")


# ----------------------------------------------------------------------
# Multi-device parity, in-process on meshes of cpu positions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["tilted", "kernel"])
@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_executor_bit_exact(backend, policy, shards):
    plan = small_plan(vertical_policy=policy, backend=backend)
    stack = engine.prepare_stack(plan, LAYERS)
    frames = frames_of(7, (2, *plan.lr_shape))
    ref = engine.build_stack_executor(plan, stack)(frames)
    fn = sharded(plan, shards, stack)
    out = fn(frames)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert fn.donates_frames is False and fn.sharded_plan.spec.band_shards == shards


def test_sharded_executor_rejects_mismatched_mesh():
    plan = small_plan()
    stack = engine.prepare_stack(plan, LAYERS)
    with pytest.raises(ValueError, match="band_shards"):
        build_sharded_executor(ShardedPlan(plan=plan, spec=MeshSpec(1, 4)), stack,
                               cpu_bands(2))
    with pytest.raises(ValueError, match="band_submesh"):
        # a whole 2x2 serving mesh: pass one replica's row
        build_sharded_executor(ShardedPlan(plan=plan, spec=MeshSpec(1, 2)), stack,
                               make_sr_mesh(2, 2, device="cpu"))


def test_session_serving_bit_exact_and_routed():
    base = session(vertical_policy="halo")
    mesh_s = session(vertical_policy="halo", mesh=(2, 4), route="round_robin")
    frames = frames_of(3, (2, 48, 16, 3))
    want = base.upscale(frames)
    for _ in range(4):  # sequential: each call is its own routed dispatch
        assert torch.equal(mesh_s.upscale(frames), want)
    stats = mesh_s.sharding_stats()
    assert stats["mesh"] == "2x4" and stats["devices"] == 8
    assert sum(r["dispatches"] for r in stats["replicas"]) >= 4
    assert all(r["dispatches"] >= 1 for r in stats["replicas"])  # rotated
    assert stats["replica_fill"] > 0.0
    assert stats["halo_bytes_per_frame"] > 0
    assert mesh_s._server.scheduler_stats()["replica_dispatches"] == {0: 2, 1: 2}


def test_session_auto_rebands_for_mesh():
    # height 48 defaults to one 48-row band; 2 band shards force 24.
    # halo policy so the re-banded output stays bit-identical (zero /
    # replicate boundaries legitimately depend on where the bands fall).
    s = session(vertical_policy="halo", mesh=(1, 2))
    plan = s.plan_for((48, 16, 3))
    assert plan.num_bands % 2 == 0
    base = session(vertical_policy="halo")
    frames = frames_of(9, (1, 48, 16, 3))
    assert torch.equal(s.upscale(frames), base.upscale(frames))


def test_session_rejects_unshardable_explicit_band_rows():
    s = session(mesh=(1, 2), band_rows=48)
    with pytest.raises(ValueError):
        s.plan_for((48, 16, 3))


def test_sharded_parity_in_process():
    """The twin of the JAX package's subprocess parity test: every backend x
    policy x S through a mesh given position by position (``devices=``)."""
    frames = frames_of(7, (2, 24, 16, 3))
    for backend in ("tilted", "kernel"):
        for policy in ("zero", "halo", "replicate"):
            plan = small_plan(vertical_policy=policy, backend=backend)
            stack = engine.prepare_stack(plan, LAYERS)
            ref = engine.build_stack_executor(plan, stack)(frames)
            for S in (2, 4):
                mesh = band_submesh(make_sr_mesh(1, S, devices=["cpu"] * S), 0)
                assert torch.equal(sharded(plan, S, stack, mesh)(frames), ref)


def test_replica_routing_in_process():
    """The twin of the JAX package's subprocess routing test: a (2, 2) mesh
    under least-loaded routing serves exactly and spreads the dispatches."""
    base = session(vertical_policy="halo")
    mesh_s = session(vertical_policy="halo", mesh=(2, 2), route="least_loaded")
    frames = frames_of(3, (2, 24, 16, 3))
    want = base.upscale(frames)
    for _ in range(4):
        assert torch.equal(mesh_s.upscale(frames), want)
    stats = mesh_s.sharding_stats()
    assert stats["mesh"] == "2x2", stats
    assert sum(r["dispatches"] for r in stats["replicas"]) >= 4, stats
    assert [r["dispatches"] for r in stats["replicas"]] == [2, 2]
    assert all(r["inflight"] == 0 for r in stats["replicas"])


# ----------------------------------------------------------------------
# The port's own: precisions, JAX parity, stacks, partial bands, bounds
# ----------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_halo_bit_exact_across_precisions(precision, shards):
    """The scatter and the margins are taken after the cast to the compute
    dtype, so bf16 and int8 shard as exactly as fp32."""
    for backend in ("tilted", "kernel"):
        plan = small_plan(vertical_policy="halo", backend=backend, precision=precision)
        frames = frames_of(5, (2, *plan.lr_shape))
        ref = single(plan, frames)
        out = sharded(plan, shards)(frames)
        assert out.dtype == torch.float32 and torch.equal(out, ref)


@pytest.mark.parametrize("backend", ["tilted", "kernel"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_sharded_matches_the_jax_single_device_executor(backend, precision, policy):
    """The JAX package's sharded output equals its single-device output, so
    the port's sharded output is held to the JAX single-device executor
    (``kernel`` in interpret mode) at the support matrix's tolerance."""
    from repro.engine.plan import SRPlan as JSRPlan

    kw = dict(height=24, width=16, num_layers=3, band_rows=6, vertical_policy=policy,
              backend=backend, precision=precision)
    frames = np.random.default_rng(8).random((2, 24, 16, 3), dtype=np.float32)
    jplan = JSRPlan(**kw)
    want = np.asarray(jengine.build_stack_executor(
        jplan, jengine.prepare_stack(jplan, JLAYERS))(jnp.asarray(frames)), np.float32)
    plan = SRPlan(**kw)
    for shards in (2, 4):
        got = sharded(plan, shards)(torch.from_numpy(frames)).float().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL[precision], (shards, np.abs(got - want).max())


def test_router_prepares_one_stack_per_distinct_device():
    mesh_s = session(mesh=(2, 2), vertical_policy="halo")
    mesh_s.upscale(frames_of(1, (2, 24, 16, 3)))
    mesh_s.upscale(frames_of(2, (2, 24, 16, 3)))
    for rep in mesh_s._router._replicas:
        (rec,) = rep.stacks.values()
        assert list(rec.stack) == [torch.device("cpu")] and rec.refs == 1
    mesh_s.clear_cache()
    assert all(not rep.stacks for rep in mesh_s._router._replicas)


def test_mesh_session_serves_partial_bands_locally():
    """Delta serving's partial-band executor is built unsharded, on the
    session's device (replica 0's first position), in the session's own
    cache; whole frames route to the replicas."""
    s = session(mesh=(2, 2), vertical_policy="halo", band_rows=6)
    plan = s.plan_for((24, 16, 3))
    entry, built = s.band_executor_for(plan, 2, torch.float32)
    assert built and entry.replica is None and len(s._cache) == 1
    frame_entry, _ = s.executor_for(plan, 2, torch.float32)
    assert frame_entry.replica in (0, 1) and len(s._cache) == 1


def test_strict_mesh_session_verifies_with_band_shards(monkeypatch):
    from repro_torch.analysis import plan_check

    seen = []
    real = plan_check.verify_plan
    monkeypatch.setattr(plan_check, "verify_plan",
                        lambda plan, **kw: seen.append(kw) or real(plan, **kw))
    s = session(mesh=(1, 2), vertical_policy="halo", strict=True)
    frames = frames_of(4, (1, 24, 16, 3))
    assert torch.equal(s.upscale(frames), session(vertical_policy="halo").upscale(frames))
    assert seen and seen[0]["band_shards"] == 2


def test_one_by_one_tuning_entries_do_not_apply_on_a_mesh(tmp_path):
    """A tuned schedule is stamped with its mesh shape: a ``1x1`` entry is
    not consulted by a ``1x2`` session."""
    from repro_torch.engine import autotune

    db = autotune.TuningDB(str(tmp_path / "db.json"))
    plan = SRPlan.from_request((24, 16, 3), num_layers=3, vertical_policy="halo")
    db.put(autotune.TuningKey.from_plan(plan, 1), autotune.TuningEntry(
        band_rows=4, pipeline_depth=1, bucket=1, bucket_policy="exact",
        predicted_ms=1.0, measured_ms=1.0, default_ms=1.5, speedup=1.5,
        torch_version=torch.__version__, cuda_version=torch.version.cuda,
        device_name="cpu", created=123.0, device_count=1, mesh_shape="1x1"))
    db.save()
    flat = session(vertical_policy="halo", autotune="cached", tuning_db=db.path)
    mesh_s = session(vertical_policy="halo", autotune="cached", tuning_db=db.path,
                     mesh=(1, 2))
    assert flat.plan_for((24, 16, 3), batch_hint=1).band_rows == 4
    assert flat.tuning_stats()["hits"] == 1
    assert mesh_s.plan_for((24, 16, 3), batch_hint=1).band_rows != 4
    assert mesh_s.tuning_stats()["hits"] == 0


def test_halo_bounds_and_margins_copy_nothing_from_the_host():
    """The shard's valid-row bounds and its edge margins are made on the
    shard's device: a host array copied up would make torch synchronize
    the stream inside every halo dispatch.  A non-CPU device (``meta``)
    shows such a copy on the CPU too."""
    from repro_torch.analysis import program_audit

    meta = torch.device("meta")
    plan = small_plan(vertical_policy="halo")
    stack = shard_exec.stack_on(engine.prepare_stack(plan, LAYERS), meta)
    mesh = SRMesh(devices=(meta, meta), shape=(2,), axis_names=("bands",),
                  streams=(None, None))
    fn = sharded(plan, 2, stack, mesh)
    frames = torch.zeros((2, *plan.lr_shape), device=meta)
    ops = executor._record_ops(lambda: fn(frames))
    assert program_audit.audit_ops(ops) == []
    assert not any(o["from_host"] for o in ops)


# ----------------------------------------------------------------------
# The server: routing, completion, the injector's replica
# ----------------------------------------------------------------------
class _FakeClock:
    """The injector's clock: ``sleep`` moves it instead of waiting."""

    def __init__(self, monkeypatch):
        self.slept = []
        monkeypatch.setattr(resilience, "time",
                            types.SimpleNamespace(sleep=self.slept.append))


def test_injector_delays_the_routed_replica(monkeypatch):
    clock = _FakeClock(monkeypatch)
    injector = FailureInjector(delay_replicas={1: 0.25})
    mesh_s = session(mesh=(2, 2), vertical_policy="halo", route="round_robin")
    server = SRServer({"m": mesh_s}, injector=injector)
    frame = frames_of(6, (24, 16, 3))
    outs = [server.submit(frame).result() for _ in range(4)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    # round robin: replicas 0, 1, 0, 1 -> the two dispatches on replica 1
    assert clock.slept == [0.25, 0.25]
    assert injector.stats()["injected_delays"] == 2
    assert server.scheduler_stats()["replica_dispatches"] == {0: 2, 1: 2}


def test_failed_dispatch_releases_its_replica():
    injector = FailureInjector(fail_dispatches={0})
    mesh_s = session(mesh=(2, 1), vertical_policy="halo")
    server = SRServer({"m": mesh_s}, injector=injector)
    frame = frames_of(6, (24, 16, 3))
    failed = server.submit(frame)
    assert isinstance(failed.exception(), resilience.InjectedFailure)
    ok = server.submit(frame).result()
    assert torch.equal(ok, session(vertical_policy="halo").upscale(frame))
    stats = mesh_s.sharding_stats()
    assert all(r["inflight"] == 0 for r in stats["replicas"])
    # the injected failure fired before the launch: nothing was routed there
    assert sum(r["dispatches"] for r in stats["replicas"]) == 1


def test_audit_server_warms_every_replica():
    """Each replica builds its executor on its first dispatch (a warm-up
    that synchronizes), so the audit warms every replica before the call
    it traces."""
    from repro_torch.analysis import program_audit

    mesh_s = session(mesh=(2, 1), vertical_policy="halo")
    server = SRServer({"m": mesh_s})
    frame = frames_of(6, (24, 16, 3))
    calls = []

    def submit():
        calls.append(len(mesh_s._router._replicas[1].cache))
        return server.submit(frame)

    assert program_audit.audit_server(server, submit) == []
    assert calls == [0, 0, 1]  # the traced call finds replica 1 built
