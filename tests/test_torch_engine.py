"""The PyTorch port's engine vs the JAX package's: ``run`` over the backend
x policy x precision matrix, and the serving slice end to end.

Everything here runs the port with ``device="cpu"`` (the kernel backend
takes K1's plain version); the JAX side runs its Pallas kernel in
interpret mode.  Weights and frames are made with numpy (or, for the
slice, the JAX package's ``init_abpn(PRNGKey(0))``) and cross as arrays
through ``layers_from_numpy``.  Tolerances are the README support matrix's,
max abs diff on the [0, 1] HR output:

* fp32 and int8 — 5e-4: fp32 accumulation in a different order; int8
  dequantises to the same fp32 weights on both sides (codes are equal);
* bf16 — 5e-2: bf16 feature maps on both sides, with rounding points
  that differ by one reordered fp32 sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core.fusion import ConvLayer as JConvLayer
from repro.models.abpn import init_abpn as jinit_abpn

from repro_torch import engine as tengine
from repro_torch.models.abpn import layers_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


TOL = {"fp32": 5e-4, "int8": 5e-4, "bf16": 5e-2}
MATRIX = [(b, p, q) for b in ("reference", "tilted", "kernel")
          for p in ("zero", "halo", "replicate") for q in ("fp32", "bf16", "int8")]


def np_stack(seed, channels):
    rng = np.random.default_rng(seed)
    return [
        ((rng.normal(size=(3, 3, channels[i], channels[i + 1])) * 0.2).astype(np.float32),
         (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
         i < len(channels) - 2)
        for i in range(len(channels) - 1)
    ]


# a 3-layer stack sized for the anchor epilogue at scale 2
ARRAYS = np_stack(0, [3, 12, 12, 12])
JLAYERS = [JConvLayer(w=jnp.asarray(w), b=jnp.asarray(b), relu=r) for w, b, r in ARRAYS]
TLAYERS = layers_from_numpy(ARRAYS)
FRAMES = np.random.default_rng(1).uniform(size=(2, 40, 24, 3)).astype(np.float32)


def to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("backend,policy,precision", MATRIX)
def test_run_matches_jax(backend, policy, precision):
    kw = dict(band_rows=20, tile_cols=4, scale=2, vertical_policy=policy,
              precision=precision, backend=backend)
    jp = jengine.make_plan(JLAYERS, FRAMES.shape[1:], **kw)
    tp = tengine.make_plan(TLAYERS, FRAMES.shape[1:], **kw)
    j = jengine.run(jp, JLAYERS, jnp.asarray(FRAMES))
    t = tengine.run(tp, TLAYERS, FRAMES, device="cpu")
    assert tuple(t.shape) == tuple(j.shape) == (2, 80, 48, 3)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(to_np(t), to_np(j), atol=TOL[precision], rtol=0)


# ABPN x4's shape cut to 3 layers of 8 features: 48 outputs, so K1 runs at
# Chp 48 (a wide instance on the card) and the anchor repeats 16 times
ARRAYS_X4 = [(w * (2.0 / (9 * w.shape[2])) ** 0.5 / 0.2, b, r)
             for w, b, r in np_stack(2, [3, 8, 8, 48])]
JLAYERS_X4 = [JConvLayer(w=jnp.asarray(w), b=jnp.asarray(b), relu=r) for w, b, r in ARRAYS_X4]
TLAYERS_X4 = layers_from_numpy(ARRAYS_X4)


@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_run_at_scale_4_matches_jax(policy, precision):
    """``engine.run`` on the kernel backend at ``scale=4`` (Chp 48) against
    the JAX package's on the same weights: (1, 20, 16) LR -> (80, 64) HR."""
    frames = FRAMES[:1, :20, :16]
    kw = dict(band_rows=10, tile_cols=4, scale=4, vertical_policy=policy,
              precision=precision, backend="kernel")
    jp = jengine.make_plan(JLAYERS_X4, frames.shape[1:], **kw)
    tp = tengine.make_plan(TLAYERS_X4, frames.shape[1:], **kw)
    j = jengine.run(jp, JLAYERS_X4, jnp.asarray(frames))
    t = tengine.run(tp, TLAYERS_X4, frames, device="cpu")
    assert tuple(t.shape) == tuple(j.shape) == (1, 80, 64, 3)
    assert tengine.prepare_stack(tp, TLAYERS_X4).packed.chp == 48
    np.testing.assert_allclose(to_np(t), to_np(j), atol=TOL[precision], rtol=0)


def test_run_needs_cuda_or_an_explicit_cpu():
    plan = tengine.make_plan(TLAYERS, FRAMES.shape[1:], band_rows=20, tile_cols=4, scale=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.run(plan, TLAYERS, FRAMES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.SRSession(TLAYERS, scale=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.SRServer.open("abpn_x3")


# ----------------------------------------------------------------------
# The slice: SRServer.open("abpn_x3", backend="kernel") end to end
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def abpn_weights():
    return jinit_abpn(jax.random.PRNGKey(0))


def _requests():
    rng = np.random.default_rng(2)
    a = rng.uniform(size=(2, 24, 32, 3)).astype(np.float32)
    b = rng.uniform(size=(2, 24, 32, 3)).astype(np.float32)
    c = rng.uniform(size=(16, 24, 3)).astype(np.float32)  # a second resolution
    return a, b, c


def _serve(server, reqs):
    futs = [server.submit(r) for r in reqs]  # all queued before any drains
    return [f.result() for f in futs], server.scheduler_stats()


def test_server_slice_matches_jax(abpn_weights):
    reqs = _requests()
    jsrv = jengine.SRServer.open("abpn_x3", backend="kernel", autotune="off",
                                 layers=abpn_weights)
    tsrv = tengine.SRServer.open("abpn_x3", backend="kernel", device="cpu",
                                 layers=layers_from_numpy(abpn_weights))
    jout, jstats = _serve(jsrv, reqs)
    tout, tstats = _serve(tsrv, reqs)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(to_np(t), to_np(j), atol=TOL["fp32"], rtol=0)
    keys = ("dispatches", "coalesced_dispatches", "frames_dispatched", "slots_dispatched",
            "submitted_requests", "submitted_frames")
    assert {k: tstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert tstats["dispatches"] == 2 and tstats["coalesced_dispatches"] == 1
    assert [d["bucket"] for d in tstats["recent_dispatches"]] == \
        [d["bucket"] for d in jstats["recent_dispatches"]]
    session = tsrv.session()
    assert session.plan_for((24, 32, 3)).backend == "kernel"
    assert {e["lr_shape"][0] for e in session.cache_stats()["entries"]} == {24, 16}


def test_upscale_equals_submit_result_bitwise():
    session = tengine.SRSession(TLAYERS, backend="kernel", scale=2, tile_cols=4,
                                device="cpu")
    frames = FRAMES[:, :20]
    via_future = session.submit(frames).result()
    via_upscale = session.upscale(frames)
    assert torch.equal(via_future, via_upscale)
    one = session.upscale(frames[0])  # rank-3 request
    assert tuple(one.shape) == (40, 48, 3)
    clip = session.upscale(np.stack([frames, frames]))  # rank-5 request
    assert tuple(clip.shape) == (2, 2, 40, 48, 3)
    assert torch.equal(clip[1], via_future)
    stats = session.stats()
    assert stats["frames"] == 2 + 2 + 1 + 4 and stats["batches"] == 4


def test_session_validation_and_unported_options():
    session = tengine.SRSession(TLAYERS, scale=2, device="cpu")
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        session.submit(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="channels"):
        session.submit(np.zeros((8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="numeric"):
        session.submit(np.array([["a"]]))
    empty = session.upscale(np.zeros((0, 8, 8, 3), np.float32))
    assert tuple(empty.shape) == (0, 16, 16, 3)
    # items 10 (autotune), 11 (mesh) and 12 (strict) are ported: a mesh
    # session serves; a bogus mesh or route is rejected
    meshed = tengine.SRSession(TLAYERS, scale=2, device="cpu", mesh=(1, 2),
                               route="least_loaded")
    assert meshed.sharding_stats()["mesh"] == "1x2"
    assert tuple(meshed.upscale(np.zeros((16, 8, 3), np.float32)).shape) == (32, 16, 3)
    for kwargs in (dict(mesh="1x2"), dict(mesh=(1, 2), route="random")):
        with pytest.raises(ValueError):
            tengine.SRSession(TLAYERS, scale=2, device="cpu", **kwargs)
    for mode in ("off", "cached", "full"):
        tuned = tengine.SRSession(TLAYERS, scale=2, device="cpu", autotune=mode, strict=True)
        assert tuned.autotune == mode and tuned.strict
    assert session.autotune == "cached"  # the default, as in the JAX package
    # the temporal and front-door options (items 8 and 9) now work
    plan = session.plan_for((8, 8, 3))
    entry, built = session.band_executor_for(plan, 1, torch.float32)
    assert built and session.band_executor_for(plan, 1, torch.float32) == (entry, False)
    slabs = torch.zeros((1, plan.band_rows, 8, 3))
    assert tuple(entry.fn(slabs, torch.zeros((1, 2), dtype=torch.int32)).shape) == \
        (1, 2 * plan.band_rows, 16, 3)
    served = session.submit(np.zeros((8, 8, 3), np.float32), timeout=60.0).result()
    assert tuple(served.shape) == (16, 16, 3)
    other = tengine.SRSession(TLAYERS, scale=2, device="cpu")
    shed = tengine.SRServer(other, admission="shed", max_inflight_frames=4)
    assert shed.admission == "shed" and shed.max_inflight_frames == 4


def test_scheduler_matches_jax_on_the_same_traffic():
    """The port's scheduler is its own copy: the same adds, expiries, sheds
    and dispatch turns must form the same dispatches as the JAX one."""
    from repro.engine import scheduler as jsched
    from repro_torch.engine import scheduler as tsched

    class FakeSession:
        pipeline_depth = 2

        def _bucket_for(self, n):
            return min(tengine.bucket_batch(n), 8)

    class FakePlan:
        lr_shape = (24, 32, 3)

    def drive(mod):
        sched, session, log = mod.MicroBatchScheduler(), FakeSession(), []
        traffic = [("a", 3, 0, None), ("a", 6, 1, 5.0), ("b", 2, 0, 1.0), ("a", 1, 2, None),
                   ("b", 9, 0, None), ("c", 4, 1, 2.0)]
        for i, (key, n, prio, dl) in enumerate(traffic):
            sched.add(mod.SchedRequest(seq=sched.next_seq(), key=(key, "plan", "float32"),
                                       session=session, plan=FakePlan(), flat=None, n=n,
                                       priority=prio, future=None, ndim=4, lead=None,
                                       deadline=dl))
            if i == 3:
                log.append([r.n for r in sched.expire_due(1.5)])
                victims = sched.shed_victims(2, priority=3, deadline=None)
                log.append(None if victims is None else [r.n for r in victims])
        while (d := sched.next_dispatch(lambda s: True)) is not None:
            log.append((d.key, d.bucket, [(t.start, t.n, t.slot) for t in d.tickets]))
        stats = sched.stats()
        return log, stats, list(sched.recent_dispatches)

    ours = drive(tsched)
    assert ours[1]['dispatches'] >= 4 and ours[1]['shed'] + ours[1]['expired'] >= 1
    assert ours == drive(jsched)


def test_server_reject_admission_and_cache_refcounts():
    session = tengine.SRSession(TLAYERS, backend="tilted", scale=2, tile_cols=4,
                                device="cpu", cache_capacity=1)
    server = tengine.SRServer(session, max_inflight_frames=2, admission="reject")
    f = server.submit(FRAMES[:, :20])
    with pytest.raises(tengine.QueueFullError):
        server.submit(FRAMES[:1, :20])
    f.result()
    g = server.submit(FRAMES[:1, :10])  # a second shape evicts the first entry
    assert tuple(g.result().shape) == (1, 20, 48, 3)
    stats = session.cache_stats()
    assert stats["evictions"] == 1 and stats["size"] == 1
    assert [s["refs"] for s in stats["stacks"]] == [1]
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(FRAMES[:1, :20])
