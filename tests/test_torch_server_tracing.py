"""The serving path's own spans (``sr.*``, ``engine.spans.span``) and the
counters ``SRSession.stats()`` reports for them: queue wait and latency per
request, the submit path's pin and lock waits, and each device stage's time
with the frames it covered.

Everything runs with ``device="cpu"`` at a tiny shape, on the ``tilted``
backend (and, where K1's stages are counted, on the ``kernel`` backend's
plain version), where every call is synchronous and the stage counters
read the host clock.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import engine
from repro_torch.engine import spans
from repro_torch.engine.server import SRServer
from repro_torch.models.abpn import init_abpn

torch.set_num_threads(2)

LAYERS = init_abpn(torch.Generator().manual_seed(3))
LR = (12, 16, 3)
CLIP = np.random.default_rng(33).random((12, *LR), dtype=np.float32)
STAGES = ("upload", "k1", "epilogue", "join")

# child span -> the span it runs inside, as the server nests them
PARENTS = {
    "sr.pin": "sr.submit",
    "sr.assemble": "sr.dispatch",
    "sr.execute": "sr.dispatch",
    "sr.k1": "sr.execute",
    "sr.epilogue": "sr.execute",
    "sr.join": "sr.finalize",
}
SPANS = set(PARENTS) | set(PARENTS.values()) | {"sr.lock_wait", "sr.wait"}


def make_server(max_bucket=4, backend="tilted"):
    session = engine.SRSession(LAYERS, backend=backend, device="cpu", autotune="off",
                               max_bucket=max_bucket)
    return SRServer({"abpn": session}), session


def serve(server, starts=(0, 6), n=6):
    """Submit a request of ``n`` frames at each start, then wait for all:
    with buckets of at most 4, every 6-frame request spans two dispatches
    and its pieces are joined."""
    futs = [server.submit(CLIP[s:s + n]) for s in starts]
    return [f.result() for f in futs]


def test_profiled_requests_record_every_span_nested():
    server, _ = make_server()
    serve(server)  # warm: plan and executor
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(server)
    events = [e for e in prof.events()
              if e.name.startswith(spans.SPAN_PREFIX) and e.device_type == DeviceType.CPU]
    assert {e.name for e in events} == SPANS

    def inside(child, parent_name):
        return any(p.name == parent_name and p.thread == child.thread
                   and p.time_range.start <= child.time_range.start
                   and child.time_range.end <= p.time_range.end for p in events)

    for e in events:
        if e.name in PARENTS:
            assert inside(e, PARENTS[e.name]), e.name
    # one lock wait a submit's admission, the rest the drain's own turns
    waits = [e for e in events if e.name == "sr.lock_wait"]
    assert sum(inside(e, "sr.submit") for e in waits) == 2 < len(waits)
    # no span wraps a single frame: one join a request, one K1 a dispatch
    assert sum(e.name == "sr.join" for e in events) == 2
    assert sum(e.name == "sr.k1" for e in events) == sum(e.name == "sr.dispatch"
                                                        for e in events) == 3


def test_spans_cost_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("sr.a") is spans.span("sr.b")
    server, session = make_server()
    outs = serve(server)
    want = engine.run(session.plan_for(LR), LAYERS, CLIP, device="cpu")
    assert torch.equal(torch.cat(outs), want)


def test_wrapped_executor_functions_still_serve_and_count(monkeypatch):
    """The server hands its stage clock to the executor through
    ``spans.mark``, so the executor's functions keep their signatures: a
    caller that wraps them as they were still serves, and the stages are
    still counted."""
    from repro_torch.engine import executor

    execute, features = executor._execute_stack, executor.sr_features
    monkeypatch.setattr(executor, "_execute_stack",
                        lambda plan, stack, frames: execute(plan, stack, frames))
    monkeypatch.setattr(executor, "sr_features",
                        lambda plan, layers, frames, packed=None:
                        features(plan, layers, frames, packed))
    server, session = make_server()
    outs = serve(server)
    want = engine.run(session.plan_for(LR), LAYERS, CLIP, device="cpu")
    assert torch.equal(torch.cat(outs), want)
    st = session.stats()
    assert st["upload_frames"] == st["k1_frames"] == st["epilogue_frames"] == 12
    spans.mark("k1")  # no clock is active outside a dispatch: nothing to mark


def test_reset_stats_zeroes_every_counter():
    server, session = make_server()
    serve(server)
    before = session._serving_stats()
    assert before["requests"] == 2 and before["submits"] == 2
    assert before["submit_max_ms"] > 0 and before["lock_wait_drain_ms"] > 0
    assert all(before[f"{s}_frames"] == 12 and before[f"{s}_device_ms"] > 0 for s in STAGES)
    session.reset_stats()
    after = session._serving_stats()
    assert after.keys() == before.keys() and after.items() <= session.stats().items()
    assert all(v == 0 for v in after.values()), after


def test_queue_wait_never_exceeds_latency_under_concurrent_clients():
    server, session = make_server()
    serve(server)
    session.reset_stats()
    errors = []

    def client(c):
        try:
            for k in range(3):
                s = (c * 3 + k) % 7
                server.submit(CLIP[s:s + 5]).result()
        except Exception as e:  # reported below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    pairs = np.asarray(session._request_ms)
    assert pairs.shape == (12, 2)
    assert (pairs[:, 0] >= 0).all() and (pairs[:, 0] <= pairs[:, 1]).all()
    st = session.stats()
    assert st["requests"] == 12 and st["submits"] == 12
    assert st["queue_wait_max_ms"] == pairs[:, 0].max()
    assert st["queue_wait_p50_ms"] <= st["queue_wait_p90_ms"] <= st["queue_wait_max_ms"]
    assert st["latency_p50_ms"] <= st["latency_p90_ms"]
    assert st["latency_mean_ms"] == pytest.approx(pairs[:, 1].mean())


@pytest.mark.parametrize("backend", ["tilted", "kernel"])
def test_stage_frames_equal_the_frames_served(backend):
    server, session = make_server(backend=backend)
    serve(server)
    session.reset_stats()
    serve(server, starts=(0, 3, 6), n=6)
    # a request within one dispatch is not joined: its frames are not counted
    server.submit(CLIP[:2]).result()
    st = session.stats()
    assert st["frames"] == 20
    assert st["upload_frames"] == st["k1_frames"] == st["epilogue_frames"] == 20
    assert st["join_frames"] == 18
    assert all(st[f"{s}_device_ms"] > 0 for s in STAGES)
    # K1's input streams are marshalled on the kernel backend alone
    marshalled = 20 if backend == "kernel" else 0
    assert st["marshal_frames"] == marshalled and (st["marshal_device_ms"] > 0) == bool(marshalled)


def test_a_held_lock_shows_in_the_submit_counters():
    server, session = make_server()
    serve(server)
    session.reset_stats()
    held, started = threading.Event(), threading.Event()
    t_start = []

    def holder():
        with server._lock:
            held.set()
            started.wait(5)
            while time.perf_counter() < t_start[0] + 0.12:
                time.sleep(0.005)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    t_start.append(time.perf_counter())
    started.set()
    fut = server.submit(CLIP[:2])
    t.join(timeout=5)
    assert not t.is_alive()
    fut.result()
    st = session.stats()
    assert st["lock_wait_submit_max_ms"] >= 100
    assert st["lock_wait_submit_ms"] >= st["lock_wait_submit_max_ms"]
    assert st["submit_max_ms"] >= st["lock_wait_submit_max_ms"]
    assert st["lock_wait_drain_max_ms"] < 100
