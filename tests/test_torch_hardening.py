"""The PyTorch port's serving hardening: twins of ``tests/test_hardening.py``.

Per-request deadlines and cancellation, ``admission="shed"``, the degrade
ladder (``DegradePolicy``) and its hysteresis, fault injection through the
server's launch path, and concurrent ``admission="reject"`` without hangs.
Everything runs with ``device="cpu"`` on the ``tilted`` backend at a tiny
shape; outputs are held bit for bit against the port's own ``engine.run``
over the whole clip.

Where the JAX test sleeps past a short deadline, the twin moves the
server's clock instead (``_FakeClock``), so no assertion depends on how
long the machine takes to get there.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.engine import server as server_mod
from repro_torch.engine.scheduler import (
    DeadlineExceededError,
    MicroBatchScheduler,
    QueueFullError,
    RequestShedError,
    SchedRequest,
)
from repro_torch.engine.server import DEGRADE_LADDER, DegradePolicy, SRFuture, SRServer
from repro_torch.models.abpn import layers_from_numpy
from repro_torch.runtime.resilience import FailureInjector, InjectedFailure

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


LAYERS = layers_from_numpy(init_abpn(jax.random.PRNGKey(2), ABPNConfig()))
LR = (12, 16, 3)
CLIP = np.random.default_rng(21).random((8, *LR), dtype=np.float32)
ORACLE = None  # filled lazily


def oracle(frames):
    global ORACLE
    if ORACLE is None:
        plan = engine.make_plan(LAYERS, LR, band_rows=12, backend="tilted")
        ORACLE = engine.run(plan, LAYERS, CLIP, device="cpu").numpy()
    n = frames.shape[0]
    for i in range(CLIP.shape[0] - n + 1):
        if np.array_equal(np.asarray(frames), CLIP[i:i + n]):
            return ORACLE[i:i + n]
    raise AssertionError("frames are not a contiguous CLIP slice")


def assert_served(out, frames):
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), oracle(frames))


def make_session(**kw):
    kw.setdefault("backend", "tilted")
    return engine.SRSession(LAYERS, device="cpu", **kw)


def make_server(*, session_kw=None, **server_kw):
    session = make_session(**(session_kw or {}))
    return SRServer({"abpn": session}, **server_kw), session


def sched_req(n, *, seq=0, priority=0, deadline=None, served=0):
    """A scheduler-only request for unit tests of expiry and shedding."""
    r = SchedRequest(
        seq=seq, key=("m", "plan", "float32"), session=None, plan=None,
        flat=None, n=n, priority=priority, future=None, ndim=4, lead=None,
        deadline=deadline,
    )
    r.served = served
    return r


class _FakeClock:
    """Stands in for the server module's ``time``: ``monotonic`` reads a
    value the test sets; everything else is the real module."""

    def __init__(self, monkeypatch, now=1000.0):
        self.now = now
        fake = types.SimpleNamespace(monotonic=lambda: self.now,
                                     perf_counter=time.perf_counter, sleep=time.sleep)
        monkeypatch.setattr(server_mod, "time", fake)


# ----------------------------------------------------------------------
# Deadlines: scheduler-level expiry semantics
# ----------------------------------------------------------------------
def test_expire_due_removes_only_queued_due_requests():
    s = MicroBatchScheduler()
    fresh = sched_req(2, seq=0, deadline=100.0)
    due = sched_req(2, seq=1, deadline=5.0)
    no_deadline = sched_req(2, seq=2)
    for r in (fresh, due, no_deadline):
        s.add(r)
    assert s.expire_due(now=10.0) == [due]
    assert s.pending_frames == 4
    assert s.stats()["expired"] == 1
    assert s.expire_due(now=10.0) == []


def test_expire_due_spares_partially_served_requests():
    s = MicroBatchScheduler()
    partial = sched_req(4, deadline=5.0, served=2)
    s.add(partial)
    assert s.expire_due(now=10.0) == []
    assert s.pending_frames == 4


def test_shed_victims_picks_lowest_priority_latest_deadline():
    s = MicroBatchScheduler()
    low_late = sched_req(2, seq=0, priority=0)
    low_soon = sched_req(2, seq=1, priority=0, deadline=5.0)
    high = sched_req(2, seq=2, priority=5, deadline=50.0)
    for r in (low_late, low_soon, high):
        s.add(r)
    assert s.shed_victims(2, priority=1, deadline=None) == [low_late]
    assert s.stats()["shed"] == 1
    assert s.pending_frames == 4
    assert s.shed_victims(2, priority=1, deadline=None) == [low_soon]
    assert s.shed_victims(2, priority=1, deadline=None) is None
    assert s.pending_frames == 2 and s.stats()["shed"] == 2


def test_shed_victims_equal_priority_breaks_on_deadline():
    s = MicroBatchScheduler()
    urgent = sched_req(2, seq=0, priority=0, deadline=5.0)
    relaxed = sched_req(2, seq=1, priority=0, deadline=50.0)
    s.add(urgent)
    s.add(relaxed)
    assert s.shed_victims(2, priority=0, deadline=10.0) == [relaxed]
    assert s.shed_victims(2, priority=0, deadline=10.0) is None


def test_shed_victims_never_touches_partially_served():
    s = MicroBatchScheduler()
    s.add(sched_req(4, seq=0, priority=0, served=1))
    assert s.shed_victims(1, priority=9, deadline=None) is None


# ----------------------------------------------------------------------
# Deadlines: server behaviour
# ----------------------------------------------------------------------
def test_queued_deadline_expiry_spares_coalesced_neighbor(monkeypatch):
    """A request expires while QUEUED; the same-key request it would have
    coalesced with completes bit-exact."""
    clock = _FakeClock(monkeypatch)
    server, _ = make_server(session_kw={"max_bucket": 4})
    keeper = server.submit(CLIP[:2])
    doomed = server.submit(CLIP[2:4], timeout=0.02)
    clock.now += 0.06  # the deadline passes while both are queued
    assert_served(keeper.result(), CLIP[:2])  # drives the drain; expiry first
    with pytest.raises(DeadlineExceededError):
        doomed.result()
    s = server.scheduler_stats()
    assert s["expired"] == 1
    # the expired frames left the queue BEFORE bucket sizing
    assert s["dispatches"] == 1
    assert s["recent_dispatches"][0]["frames"] == 2
    assert_served(server.submit(CLIP[4:6]).result(), CLIP[4:6])


def test_dead_on_arrival_fails_before_any_work():
    server, session = make_server()
    fut = server.submit(CLIP[:2], timeout=0.0)
    assert fut.done()
    with pytest.raises(DeadlineExceededError):
        fut.result()
    assert server.scheduler_stats()["expired"] == 1
    assert server.scheduler_stats()["dispatches"] == 0
    assert session.cache_stats()["entries"] == []  # nothing built


def test_deadline_and_timeout_are_exclusive():
    server, _ = make_server()
    with pytest.raises(ValueError, match="not both"):
        server.submit(CLIP[:2], deadline=time.monotonic() + 1, timeout=1)


def test_flush_cancels_expired_work(monkeypatch):
    clock = _FakeClock(monkeypatch)
    server, _ = make_server()
    fut = server.submit(CLIP[:2], timeout=0.01)
    clock.now += 0.05
    server.flush()
    assert isinstance(fut.exception(), DeadlineExceededError)


def test_exceptions_are_distinguishable():
    assert issubclass(DeadlineExceededError, TimeoutError)
    assert issubclass(RequestShedError, QueueFullError)
    assert not issubclass(DeadlineExceededError, QueueFullError)


# ----------------------------------------------------------------------
# SRFuture.result(timeout=): wall clock honoured while driving the drain
# ----------------------------------------------------------------------
def test_result_timeout_honored_while_caller_drives_drain():
    """A caller draining a deep queue gets TimeoutError when its budget
    runs out mid-drain — not after the whole queue finishes."""
    injector = FailureInjector(delay_dispatches={k: 0.25 for k in range(16)})
    server, _ = make_server(session_kw={"max_bucket": 2}, injector=injector)
    fut = server.submit(CLIP[:8])  # 4 dispatches x >= 0.25 s each
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.3)
    elapsed = time.monotonic() - t0
    assert elapsed < 0.85
    assert not fut.done()
    # a wait timeout does not cancel the request: it still completes
    assert_served(fut.result(), CLIP[:8])


def test_wait_done_survives_spurious_wakeups():
    class _FakeServer:
        def _drain_until(self, fut, deadline=None):
            pass  # another thread "owns" the drain

    fut = SRFuture(_FakeServer())
    stop = threading.Event()

    def spam():
        while not stop.is_set():
            with fut._cond:
                fut._cond.notify_all()
            time.sleep(0.005)

    spammer = threading.Thread(target=spam, daemon=True)
    spammer.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.15)
        assert time.monotonic() - t0 >= 0.15
        finisher = threading.Timer(0.1, lambda: fut._finish(result=42))
        finisher.start()
        assert fut.result(timeout=5.0) == 42
    finally:
        stop.set()
        spammer.join()


# ----------------------------------------------------------------------
# admission="shed"
# ----------------------------------------------------------------------
def test_shed_requires_a_bound():
    with pytest.raises(ValueError, match="max_inflight_frames"):
        make_server(admission="shed")


def test_shed_evicts_lower_priority_for_newcomer():
    server, _ = make_server(session_kw={"max_bucket": 4}, max_inflight_frames=4,
                            admission="shed")
    victim = server.submit(CLIP[:4], priority=0)
    keeper = server.submit(CLIP[4:6], priority=1)  # queue full: sheds victim
    assert victim.done()
    with pytest.raises(RequestShedError):
        victim.result()
    assert isinstance(victim.exception(), QueueFullError)
    assert_served(keeper.result(), CLIP[4:6])
    s = server.scheduler_stats()
    assert s["shed"] == 1 and s["rejected"] == 0


def test_shed_rejects_newcomer_when_it_ranks_lowest():
    server, _ = make_server(session_kw={"max_bucket": 4}, max_inflight_frames=4,
                            admission="shed")
    queued = server.submit(CLIP[:4], priority=1)
    with pytest.raises(QueueFullError):
        server.submit(CLIP[4:6], priority=0)
    s = server.scheduler_stats()
    assert s["rejected"] == 1 and s["shed"] == 0
    assert_served(queued.result(), CLIP[:4])


def test_shed_equal_priority_prefers_deadline_holders():
    server, _ = make_server(session_kw={"max_bucket": 4}, max_inflight_frames=4,
                            admission="shed")
    relaxed = server.submit(CLIP[:4], priority=0)
    urgent = server.submit(CLIP[4:6], priority=0, timeout=30.0)
    with pytest.raises(RequestShedError):
        relaxed.result()
    assert_served(urgent.result(), CLIP[4:6])


# ----------------------------------------------------------------------
# DegradePolicy: the ladder itself
# ----------------------------------------------------------------------
def test_degrade_policy_validates():
    with pytest.raises(ValueError):
        DegradePolicy(0.0)
    with pytest.raises(ValueError):
        DegradePolicy(10.0, breach_steps=0)
    with pytest.raises(ValueError):
        DegradePolicy(10.0, recover_fraction=1.5)
    with pytest.raises(ValueError):
        make_server(degrade="not a policy")


def test_degrade_steps_down_ladder_on_sustained_breach():
    p = DegradePolicy(10.0, breach_steps=3)
    for _ in range(2):
        assert p.observe(100.0) is None
    t = p.observe(100.0)
    assert t is not None and t["reason"] == "slo_breach"
    assert p.level == 1 and t["to_step"] == "bf16"
    for _ in range(3):
        p.observe(100.0)
    assert p.level == 2
    for _ in range(3):
        p.observe(100.0)
    assert p.level == 3
    for _ in range(6):
        p.observe(100.0)
    assert p.level == 3  # clamped
    assert [t["to_step"] for t in p.transitions] == list(DEGRADE_LADDER[1:])


def test_degrade_recovers_with_hysteresis():
    p = DegradePolicy(10.0, alpha=0.5, breach_steps=1, recover_steps=3)
    p.observe(100.0)
    p.observe(100.0)
    assert p.level >= 1
    for _ in range(200):
        p.observe(1.0)
    assert p.level == 0
    assert any(t["reason"] == "recovered" for t in p.transitions)
    p2 = DegradePolicy(10.0, breach_steps=3)
    p2.observe(100.0)
    p2.observe(1.0)
    assert p2.level == 0 and p2.transitions == []


def test_degrade_knobs_follow_level():
    p = DegradePolicy(10.0)
    assert p.serve_dtype(np.float32) == torch.float32
    assert p.serve_dtype(torch.float32) == torch.float32
    assert p.lookahead(4) == 4 and p.bucket_cap(8) == 8
    p.level = 1
    assert p.serve_dtype(np.float32) == torch.bfloat16
    assert p.serve_dtype(torch.float32) == torch.bfloat16
    assert p.serve_dtype(np.int8) == torch.int8  # only fp32 downcasts
    assert p.lookahead(4) == 4
    p.level = 2
    assert p.lookahead(4) == 2 and p.lookahead(1) == 1
    assert p.bucket_cap(8) == 8
    p.level = 3
    assert p.bucket_cap(8) == 4 and p.bucket_cap(1) == 1


# ----------------------------------------------------------------------
# DegradePolicy: wired into the server
# ----------------------------------------------------------------------
def test_degrade_ladder_visible_in_server_dispatches():
    policy = DegradePolicy(1e-6, breach_steps=1)
    server, _ = make_server(session_kw={"max_bucket": 4}, degrade=policy)
    assert_served(server.submit(CLIP[:2]).result(), CLIP[:2])  # level 0: fp32
    assert policy.level == 1
    out = server.submit(CLIP[:2]).result()  # level 1: dispatches in bf16
    assert out.dtype == torch.bfloat16
    assert server.scheduler_stats()["recent_dispatches"][-1]["dtype"] == "bfloat16"
    assert policy.level == 2
    server.submit(CLIP[:2]).result()
    assert policy.level == 3
    # level 3: a 4-frame request's fresh bucket (4) halves to 2
    server.submit(CLIP[:4]).result()
    buckets = [d["bucket"] for d in server.scheduler_stats()["recent_dispatches"][-2:]]
    assert buckets == [2, 2]
    st = server.stats()["degrade"]
    assert st["level"] == 3 and st["step"] == "half_buckets"
    assert len(st["transitions"]) == 3
    assert st["degraded_requests"] >= 1
    assert st["p99_ms"] > st["slo_p99_ms"]


def test_degrade_halves_stream_lookahead():
    import asyncio

    policy = DegradePolicy(10.0)
    server, _ = make_server(degrade=policy)
    policy.level = 2
    assert policy.lookahead(4) == 2

    async def run():
        return [hr.float().numpy() async for hr in server.stream(list(CLIP[:4]), lookahead=4)]

    outs = asyncio.run(run())
    assert len(outs) == 4
    # level 2 includes the bf16 step: bf16 tolerance
    np.testing.assert_allclose(np.stack(outs), oracle(CLIP[:4]), rtol=0, atol=1e-2)


def test_degrade_never_applies_to_band_requests():
    """The delta path's band requests keep their dtype at every level —
    their contract is bit-exactness with a full re-upscale."""
    from repro_torch.engine.temporal import DeltaSession

    policy = DegradePolicy(10.0)
    policy.level = 3
    server, session = make_server(degrade=policy)
    with DeltaSession(session, server=server) as ds:
        out = ds.serve(CLIP[0])
    assert out.dtype == torch.float32
    assert_served(out[None], CLIP[:1])
    assert all(d["dtype"] == "float32" for d in server.scheduler_stats()["recent_dispatches"])


# ----------------------------------------------------------------------
# Fault injection through the launch path
# ----------------------------------------------------------------------
def test_injected_dispatch_failure_is_isolated():
    injector = FailureInjector(fail_dispatches={1})
    server, _ = make_server(session_kw={"max_bucket": 2}, injector=injector)
    futs = [server.submit(CLIP[2 * i:2 * i + 2]) for i in range(3)]
    server.flush()
    assert_served(futs[0].result(), CLIP[:2])
    with pytest.raises(InjectedFailure):
        futs[1].result()
    assert_served(futs[2].result(), CLIP[4:6])
    assert injector.stats()["injected_failures"] == 1
    assert_served(server.submit(CLIP[6:8]).result(), CLIP[6:8])


def test_poisoned_model_fails_only_its_own_traffic():
    injector = FailureInjector(poison_models={"bad"})
    server = SRServer({"good": make_session(), "bad": make_session()}, injector=injector)
    ok = server.submit(CLIP[:2], model="good")
    doomed = server.submit(CLIP[2:4], model="bad")
    server.flush()
    assert_served(ok.result(), CLIP[:2])
    with pytest.raises(InjectedFailure, match="poison"):
        doomed.result()
    with pytest.raises(InjectedFailure):
        server.submit(CLIP[:2], model="bad").result()
    assert_served(server.submit(CLIP[4:6], model="good").result(), CLIP[4:6])


def test_injector_requires_on_dispatch():
    with pytest.raises(ValueError, match="on_dispatch"):
        make_server(injector=object())


def test_close_releases_sessions_for_rehosting():
    session = make_session()
    server = SRServer({"abpn": session})
    assert_served(server.submit(CLIP[:2]).result(), CLIP[:2])
    built = session.cache_stats()["entries"]
    server.close()
    successor = SRServer({"abpn": session}, max_inflight_frames=8, admission="shed")
    assert_served(successor.submit(CLIP[2:4]).result(), CLIP[2:4])
    assert session.cache_stats()["entries"] == built  # no rebuild


# ----------------------------------------------------------------------
# admission="reject" under concurrent submits
# ----------------------------------------------------------------------
def test_concurrent_reject_no_hangs_no_lost_futures():
    oracle(CLIP[:1])  # build the oracle before threads race the global
    server, _ = make_server(session_kw={"max_bucket": 2}, max_inflight_frames=4,
                            admission="reject")
    threads, outcomes, errs = 6, [], []

    def worker(tid):
        for i in range(5):
            start = (tid + i) % 7
            frames = CLIP[start:start + 2]
            try:
                fut = server.submit(frames)
            except QueueFullError:
                outcomes.append(("rejected", None, None))
                continue
            try:
                hr = fut.result(timeout=60)
            except Exception as e:  # pragma: no cover - diagnostics
                errs.append(e)
                return
            outcomes.append(("ok", start, hr.numpy()))

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=120)
        assert not t.is_alive(), "worker hung"
    assert errs == []
    assert len(outcomes) == threads * 5  # no lost futures
    served = [(s, hr) for kind, s, hr in outcomes if kind == "ok"]
    assert served, "at least some requests must be admitted"
    for start, hr in served:
        np.testing.assert_array_equal(hr, oracle(CLIP[start:start + 2]))
    s = server.scheduler_stats()
    assert s["rejected"] == sum(1 for k, _, _ in outcomes if k == "rejected")
    assert s["pending_frames"] == 0 and s["inflight_frames"] == 0
