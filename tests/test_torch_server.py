"""The PyTorch port's serving front door: twins of the ``tests/test_server.py``
cases that exercise streaming, cancellation of a partial request's carry
bucket, concurrent submitters and stored timeout errors, and of the
``StragglerDetector`` / ``EMAMeanVar`` cases of ``tests/test_runtime.py``.

Everything runs with ``device="cpu"`` on the ``tilted`` backend at a tiny
shape; outputs are held bit for bit against the port's own ``engine.run``
over the whole clip.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from repro.models.abpn import ABPNConfig, init_abpn
from repro.runtime import resilience as jresilience

from repro_torch import engine
from repro_torch.engine.server import SRServer
from repro_torch.models.abpn import layers_from_numpy
from repro_torch.runtime.resilience import (
    EMAMeanVar,
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
)

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


def make_server(*, session_kw=None, **server_kw):
    session = engine.SRSession(LAYERS, backend="tilted", device="cpu", **(session_kw or {}))
    return SRServer({"abpn": session}, **server_kw), session


# ----------------------------------------------------------------------
# Streaming
# ----------------------------------------------------------------------
def test_stream_yields_in_order_and_coalesces_lookahead():
    server, _ = make_server(session_kw={"max_bucket": 4})

    async def run():
        return [hr.numpy() async for hr in server.stream(list(CLIP[:4]), lookahead=4)]

    outs = asyncio.run(run())
    assert len(outs) == 4
    np.testing.assert_array_equal(np.stack(outs), oracle(CLIP[:4]))
    s = server.scheduler_stats()
    # the lookahead window coalesced the four single frames into one bucket
    assert s["dispatches"] == 1 and s["mean_fill_ratio"] == 1.0


def test_two_concurrent_streams_share_the_server():
    server, _ = make_server(session_kw={"max_bucket": 4})

    async def one(clip):
        return [hr.numpy() async for hr in server.stream(list(clip), lookahead=2)]

    async def both():
        return await asyncio.gather(one(CLIP[:3]), one(CLIP[3:6]))

    a, b = asyncio.run(both())
    np.testing.assert_array_equal(np.stack(a), oracle(CLIP[:3]))
    np.testing.assert_array_equal(np.stack(b), oracle(CLIP[3:6]))
    assert server.scheduler_stats()["frames_dispatched"] == 6


# ----------------------------------------------------------------------
# Failure bookkeeping
# ----------------------------------------------------------------------
def test_dropping_partial_request_releases_carry_bucket(monkeypatch):
    """A failed partially-served request unpins its carry bucket: the next
    request on the key dispatches at its own natural bucket."""
    server, session = make_server(session_kw={"max_bucket": 4})
    big = server.submit(CLIP[:6])  # 4 + 2-frame tail at carry bucket 4
    real_fn = session.executor_for
    calls = {"n": 0}

    def fail_second(plan, bucket, dtype):
        calls["n"] += 1
        if calls["n"] == 2:  # the tail dispatch
            raise RuntimeError("tail exploded")
        return real_fn(plan, bucket, dtype)

    monkeypatch.setattr(session, "executor_for", fail_second)
    with pytest.raises(RuntimeError, match="tail exploded"):
        big.result()
    monkeypatch.undo()
    fut = server.submit(CLIP[6:7])  # 1 frame — natural bucket 1, not 4
    np.testing.assert_array_equal(fut.result().numpy(), oracle(CLIP[6:7]))
    assert server.scheduler_stats()["recent_dispatches"][-1]["bucket"] == 1
    assert server.scheduler_stats()["carry_buckets"] == 0


def test_future_exception_returns_stored_timeout_error(monkeypatch):
    """A dispatch failure that IS a TimeoutError is returned by
    exception(), not re-raised as if the wait timed out."""
    server, session = make_server()

    def slow(plan, bucket, dtype):
        raise TimeoutError("device timed out")

    monkeypatch.setattr(session, "executor_for", slow)
    fut = server.submit(CLIP[:1])
    exc = fut.exception()
    assert isinstance(exc, TimeoutError) and "device timed out" in str(exc)


def test_concurrent_submit_threads_coalesce_and_serve_correctly():
    """Many threads submitting + waiting concurrently: every result is
    bit-exact and the scheduler's frame accounting balances."""
    server, _ = make_server(session_kw={"max_bucket": 8})
    results = {}

    def client(i):
        results[i] = server.submit(CLIP[i:i + 2]).result().numpy()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(0, 6, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 2, 4):
        np.testing.assert_array_equal(results[i], oracle(CLIP[i:i + 2]))
    s = server.scheduler_stats()
    assert s["frames_dispatched"] == 6 and s["pending_frames"] == 0
    assert s["inflight_dispatches"] == 0 and s["dispatches"] <= 3


def test_a_resolved_request_is_freed_without_the_cycle_collector():
    """A request holds its frames (pinned host memory on the card) and
    refers to its future.  Once the future resolves, with the caller still
    holding it, nothing may keep the request alive: with the cycle
    collector off, the request is gone, whether it was served or
    cancelled."""
    import gc
    import weakref

    server, _ = make_server()
    gc.disable()
    try:
        fut = server.submit(CLIP[0:2])
        req = weakref.ref(fut._request)
        fut.result()
        assert req() is None and fut.done()
        queued = server.submit(CLIP[2:4])
        req = weakref.ref(queued._request)
        assert server.cancel(queued)
        assert req() is None and not server.cancel(queued)
    finally:
        gc.enable()


# ----------------------------------------------------------------------
# runtime.resilience: StragglerDetector, EMAMeanVar, FailureInjector
# ----------------------------------------------------------------------
def test_straggler_detector_flags_outlier():
    d = StragglerDetector(z_threshold=3.0, warmup=3)
    for i in range(20):
        d.update(i, 0.10 + 0.001 * (i % 3))
    assert not d.flagged
    assert d.update(20, 1.5)  # 15x the mean
    assert d.flagged and d.flagged[0][0] == 20


def test_straggler_detector_constant_warmup_then_spike():
    """Constant step times leave var == 0; with var seeded from the first
    nonzero delta and an infinite z on zero variance, a spike after a
    constant warm-up is flagged and not folded into the mean."""
    d = StragglerDetector(z_threshold=3.0, warmup=3)
    for i in range(10):
        assert not d.update(i, 0.10)
    assert d.update(10, 0.5)
    assert d.flagged and d.flagged[0][0] == 10
    assert d.mean == pytest.approx(0.10)


def test_ema_mean_var_seeds_var_from_first_delta():
    e = EMAMeanVar(alpha=0.1)
    e.fold(0.10)
    assert e.mean == pytest.approx(0.10) and e.var == 0.0
    e.fold(0.12)  # first nonzero delta seeds var, not alpha-shrunk
    assert e.var == pytest.approx(0.02**2)
    assert e.std > 0
    e2 = EMAMeanVar()
    e2.fold(1.0)
    assert e2.zscore(1.0) == 0.0
    assert e2.zscore(2.0) == float("inf")


def test_resilience_matches_the_reference_on_the_same_stream():
    """The port's copies fold, flag and inject exactly as the JAX
    package's on the same latency stream and dispatch sequence."""
    stream = [0.1] * 6 + [0.1 + 0.003 * (i % 5) for i in range(30)] + [0.9, 0.11, 2.0]
    mine, ref = StragglerDetector(warmup=4), jresilience.StragglerDetector(warmup=4)
    ema, jema = EMAMeanVar(0.2), jresilience.EMAMeanVar(0.2)
    for i, x in enumerate(stream):
        assert mine.update(i, x) == ref.update(i, x)
        ema.fold(x)
        jema.fold(x)
        assert (ema.mean, ema.var, ema.upper(2.326)) == (jema.mean, jema.var, jema.upper(2.326))
    assert mine.flagged == ref.flagged and mine.flagged
    kw = dict(fail_dispatches={1, 4}, poison_models={"bad"})
    inj, jinj = FailureInjector(**kw), jresilience.FailureInjector(**kw)
    for k, model in enumerate(["a", "a", "bad", "a", "a", "a"]):
        outcome = []
        for injector, err in ((inj, InjectedFailure), (jinj, jresilience.InjectedFailure)):
            try:
                injector.on_dispatch(model=model)
                outcome.append(None)
            except err as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], k
    assert inj.stats() == jinj.stats() == {"dispatches_seen": 6, "injected_failures": 3,
                                           "injected_delays": 0}
