"""The PyTorch port's SRSession: twins of the serving behaviours that
``tests/test_session.py`` and ``tests/test_pipeline.py`` check on the JAX
package — bucket padding and ``max_bucket``, LRU eviction, an empty
request's dtype, pipelined vs blocking serving, ragged tails, padding that
must not leak, the prepared weight stack's lifetime, float64 input, and the
deprecated ``VideoStream`` shim.

The JAX tests of the jitted program itself (its jaxpr, buffer donation)
have no direct meaning in eager PyTorch, which has no compiled program and
no buffer donation.  What they assert is held here instead: weight
preparation runs once per session (never per batch), and
``donate_frames`` is accepted and changes no output.

Everything runs with ``device="cpu"`` (the kernel backend through K1's
plain version); outputs are held bit for bit against the port's own
``engine.run``.
"""

import gc
import warnings
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.engine import session as session_mod
from repro_torch.models.abpn import layers_from_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


LAYERS = layers_from_numpy(init_abpn(jax.random.PRNGKey(2), ABPNConfig()))
LR = (12, 16, 3)
CLIP = torch.from_numpy(np.random.default_rng(11).random((7, *LR), dtype=np.float32))


def make_session(**kw):
    kw.setdefault("backend", "tilted")
    return engine.SRSession(LAYERS, device="cpu", **kw)


def small_session(**kw):
    kw.setdefault("max_bucket", 2)  # 7-frame clip -> 4 chunks (ragged tail)
    return make_session(**kw)


def run(session, frames):
    plan = session.plan_for(tuple(frames.shape[1:]))
    return engine.run(plan, LAYERS, frames, device="cpu")


def assert_equal(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want)


def make_stream(plan, batch_size, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return engine.VideoStream(plan, LAYERS, batch_size, device="cpu", **kw)


# ----------------------------------------------------------------------
# Buckets, eviction, empty requests, ranks
# ----------------------------------------------------------------------
def test_session_bucket_padding_parity():
    """A batch that is not a power of two is padded to its bucket; the
    padding does not reach the real frames' output."""
    session = make_session()
    out3 = session.upscale(CLIP[:3])  # bucket 4, one padded frame
    assert [e["bucket"] for e in session.cache_stats()["entries"]] == [4]
    assert_equal(out3, run(session, CLIP[:3]))


def test_session_max_bucket_is_a_ceiling():
    """max_bucket clamps the bucket DOWN to the largest power of two within
    the cap, and larger requests chunk."""
    session = make_session(max_bucket=5)
    frames = torch.cat([CLIP, CLIP[:1]])  # 8 frames
    out = session.upscale(frames)  # bucket 4, two chunks
    assert tuple(out.shape) == (8, 36, 48, 3)
    assert [e["bucket"] for e in session.cache_stats()["entries"]] == [4]
    assert session.stats()["batches"] == 2
    assert_equal(out, run(session, frames))


def test_session_lru_eviction_keeps_serving():
    session = make_session(cache_capacity=1)
    a = torch.ones((1, 12, 16, 3))
    b = torch.ones((1, 24, 16, 3))
    first = session.upscale(a)
    session.upscale(b)  # evicts the (12, 16) entry
    again = session.upscale(a)  # rebuilt, still correct
    assert_equal(again, first)
    s = session.cache_stats()
    assert s["evictions"] == 2 and s["size"] == 1 and s["misses"] == 3


def test_session_empty_request_matches_served_dtype():
    session = make_session()
    for dtype in (torch.float32, torch.bfloat16):
        full = session.upscale(torch.ones((1, *LR), dtype=dtype))
        empty = session.upscale(torch.zeros((0, *LR), dtype=dtype))
        assert tuple(empty.shape) == (0, 36, 48, 3)
        assert empty.dtype == full.dtype == dtype
    nested = session.upscale(torch.zeros((2, 0, *LR)))
    assert tuple(nested.shape) == (2, 0, 36, 48, 3)


def test_session_rank_handling_matches_flat_batch():
    session = make_session()
    flat = session.upscale(CLIP[:4])
    assert_equal(session.upscale(CLIP[0]), flat[0])
    nested = session.upscale(CLIP[:4].reshape(2, 2, *LR))
    assert tuple(nested.shape) == (2, 2, 36, 48, 3)
    assert_equal(nested.reshape(4, 36, 48, 3), flat)
    with pytest.raises(ValueError):
        session.upscale(torch.ones((12, 16)))
    with pytest.raises(ValueError):
        session.upscale(torch.ones((2, 12, 16, 4)))


def test_session_serves_mixed_resolutions_and_batches():
    """Three resolutions x two batch sizes: one build per (plan, bucket),
    hits on repeats."""
    session = engine.SRSession.open("abpn_x3", layers=LAYERS, backend="tilted", device="cpu")
    resolutions = [(12, 16, 3), (24, 16, 3), (36, 8, 3)]
    for _ in range(2):
        for h, w, c in resolutions:
            for bs in (1, 3):
                hr = session.upscale(torch.ones((bs, h, w, c)))
                assert tuple(hr.shape) == (bs, 3 * h, 3 * w, c)
    s = session.cache_stats()
    assert s["misses"] == 6 and s["hits"] == 6 and s["evictions"] == 0 and s["size"] == 6
    assert s["recompiles"] == 0
    assert session.stats()["frames"] == 2 * 4 * 3


# ----------------------------------------------------------------------
# Pipelined vs blocking serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend,precision", [
    (b, p) for b in ("reference", "tilted", "kernel") for p in ("fp32", "bf16", "int8")])
def test_async_vs_sync_bit_exact(backend, precision):
    """pipeline_depth >= 2 serves the same executor over the same prepared
    stack as depth 1: outputs are bit-identical, and both equal the
    one-shot ``engine.run`` (weights prepared inside the call)."""
    clip = CLIP[:5] if backend == "kernel" else CLIP
    sync = small_session(backend=backend, precision=precision, pipeline_depth=1)
    deep = small_session(backend=backend, precision=precision, pipeline_depth=3)
    out_sync = sync.upscale(clip)
    assert_equal(out_sync, deep.upscale(clip))
    assert_equal(out_sync, engine.run(sync.plan_for(LR), LAYERS, clip, device="cpu"))
    assert sync.stats()["peak_inflight"] == 1


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depth_bounds_inflight(depth):
    session = small_session(pipeline_depth=depth)
    out = session.upscale(CLIP)
    assert_equal(out, run(session, CLIP))
    assert session.stats()["peak_inflight"] == min(depth, 4)  # 4 chunks of <= 2


def test_host_float64_served_by_the_float32_executor():
    """numpy's default float64 serves through the SAME executor as float32:
    one cache entry, labelled with the dtype served, and a later float32
    request is a pure hit."""
    session = small_session()
    out64 = session.upscale(CLIP[:2].double().numpy())
    out32 = session.upscale(CLIP[:2].numpy())
    s = session.cache_stats()
    assert s["misses"] == 1 and s["hits"] == 1 and s["size"] == 1
    assert s["entries"][0]["dtype"] == "float32"
    assert_equal(out64, out32)


# ----------------------------------------------------------------------
# Ragged tails and padding
# ----------------------------------------------------------------------
def test_ragged_tails_never_build_a_new_executor():
    """Clips of 7, 5 and 6 frames through a bucket-4 session: every chunk,
    ragged or not, runs the one bucket-4 executor."""
    session = make_session(max_bucket=4)
    session.upscale(CLIP)  # builds the one bucket-4 executor
    entry = session._cache.entries()[0]
    for t in (5, 6):  # tails of 1 and 2 — same bucket, same executor
        out = session.upscale(CLIP[:t])
        assert tuple(out.shape) == (t, 36, 48, 3)
    s = session.cache_stats()
    assert s["misses"] == 1 and s["size"] == 1 and s["recompiles"] == 0
    assert session._cache.entries()[0] is entry
    assert_equal(session.upscale(CLIP.numpy()), run(session, CLIP))


def test_padding_does_not_leak_into_real_frames():
    session = small_session()
    out = session.upscale(CLIP[:3])  # chunks: 2 + 1 (padded)
    assert_equal(out, run(session, CLIP[:3]))
    # the padded tail frame equals the same frame served in a full bucket
    assert_equal(session.upscale(CLIP[1:3])[1], out[2])


# ----------------------------------------------------------------------
# The prepared weight stack: prepared once, released with its entries
# ----------------------------------------------------------------------
def test_prepare_stack_runs_once_per_session_numerics(monkeypatch):
    """Serving many buckets and resolutions prepares the weights exactly
    once — eager PyTorch's counterpart of the JAX test that weight prep is
    absent from the jitted program."""
    calls = []
    real = session_mod.prepare_stack
    monkeypatch.setattr(session_mod, "prepare_stack",
                        lambda plan, layers: (calls.append(plan.stack_key), real(plan, layers))[1])
    session = make_session(precision="int8")
    for n in (1, 2, 3):  # buckets 1, 2, 4
        session.upscale(CLIP[:n])
    session.upscale(torch.ones((1, 24, 16, 3)))  # second resolution
    assert calls == [("int8", "tilted")]
    stacks = session.cache_stats()["stacks"]
    assert len(stacks) == 1 and stacks[0]["refs"] == 4
    assert stacks[0]["resident_bytes"] > 0 and stacks[0]["prepare_s"] >= 0


def test_eviction_releases_stack_reference():
    session = make_session(precision="int8", cache_capacity=1)
    session.upscale(torch.ones((1, *LR)))
    assert session.cache_stats()["stacks"][0]["refs"] == 1
    session.upscale(torch.ones((1, 24, 16, 3)))  # evicts the (12, 16) entry
    s = session.cache_stats()
    assert s["evictions"] == 1 and s["size"] == 1
    assert s["stacks"][0]["refs"] == 1
    assert session._stacks[("int8", "tilted")].refs == 1


def test_clear_cache_frees_the_prepared_weights():
    session = make_session(precision="int8")
    session.upscale(torch.ones((2, *LR)))
    stack = weakref.ref(session._stacks[("int8", "tilted")].stack)
    session.clear_cache()
    gc.collect()
    assert session._stacks == {} and stack() is None
    assert session.cache_stats()["size"] == 0
    out = session.upscale(torch.ones((2, *LR)))  # re-prepares and re-warms
    assert tuple(out.shape) == (2, 36, 48, 3)


def test_donate_frames_changes_no_output():
    """Eager PyTorch has no buffer donation: ``donate_frames`` is accepted
    for interface parity, changes no output, and never consumes the
    caller's frames."""
    plan = engine.make_plan(LAYERS, LR, band_rows=12, backend="tilted")
    stack = engine.prepare_stack(plan, LAYERS)
    frames = CLIP[:2].clone()
    out = engine.build_stack_executor(plan, stack, donate_frames=True)(frames)
    assert torch.equal(frames, CLIP[:2])
    assert_equal(out, engine.run(plan, LAYERS, CLIP[:2], device="cpu"))
    forced = small_session(donate_frames=True)
    first = forced.upscale(frames)
    assert_equal(forced.upscale(frames), first)
    assert_equal(first, make_session().upscale(CLIP[:2]))


# ----------------------------------------------------------------------
# Dispatch vs complete latency
# ----------------------------------------------------------------------
def test_sync_caller_sees_identical_dispatch_and_complete():
    session = small_session()
    plan = session.plan_for(LR)
    session.serve_batch(plan, torch.ones((2, *LR)))
    session.serve_batch(plan, torch.ones((2, *LR)))
    assert session._dispatch_ms == session._complete_ms
    s = session.stats()
    assert s["dispatch_mean_ms"] == s["mean_ms"]
    assert s["batches"] == 2 and s["peak_inflight"] == 1


def test_latency_stats_p99_total_span_and_empty():
    empty = session_mod.latency_stats([], 0)
    assert empty["fps"] == 0.0 and empty["p99_ms"] == 0.0
    s = session_mod.latency_stats([1.0, 2.0, 3.0, 100.0], 4,
                                  dispatch_ms=[0.1] * 4, total_s=0.05)
    assert s["p99_ms"] >= s["p95_ms"] >= s["p50_ms"] > 0
    assert s["fps"] == pytest.approx(4 / 0.05)
    assert s["dispatch_mean_ms"] == pytest.approx(0.1)
    z = session_mod.latency_stats([0.0], 2, total_s=0.0)
    assert z["fps"] == 0.0 and np.isfinite(z["fps"])


# ----------------------------------------------------------------------
# VideoStream: the deprecated fixed-batch shim
# ----------------------------------------------------------------------
def test_video_stream_is_deprecated():
    plan = engine.make_plan(LAYERS, (60, 32, 3), band_rows=30)
    with pytest.warns(DeprecationWarning):
        engine.VideoStream(plan, LAYERS, batch_size=1, device="cpu")


def test_session_matches_video_stream_on_identical_input():
    plan = engine.make_plan(LAYERS, (60, 32, 3), band_rows=30, backend="tilted")
    stream = make_stream(plan, batch_size=2)
    session = make_session(band_rows=30)
    frames = torch.rand((5, 60, 32, 3), generator=torch.Generator().manual_seed(7))
    assert_equal(session.upscale(frames), stream.run(frames))


def test_video_stream_empty_clip_dtype_matches_served_output():
    plan = engine.make_plan(LAYERS, (60, 32, 3), band_rows=30, backend="tilted")
    stream = make_stream(plan, batch_size=2)
    for dtype in (torch.float32, torch.bfloat16):
        full = stream.process(torch.ones((2, 60, 32, 3), dtype=dtype))
        empty = stream.run(torch.zeros((0, 60, 32, 3), dtype=dtype))
        assert empty.dtype == full.dtype
        assert tuple(empty.shape) == (0, 180, 96, 3)


def test_video_stream_warmup_builds_the_serving_dtype():
    """Warming up in the serving dtype makes the first real batch a cache
    hit; a batch in another dtype builds its own entry."""
    plan = engine.make_plan(LAYERS, (60, 32, 3), band_rows=30, backend="tilted")
    stream = make_stream(plan, batch_size=2, dtype=torch.bfloat16)
    assert stream.warmup() > 0
    stream.process(torch.ones((2, 60, 32, 3), dtype=torch.bfloat16))
    s = stream.cache_stats()
    assert s["misses"] == 1 and s["hits"] == 1
    assert s["entries"][0]["dtype"] == "bfloat16"
    stream.process(torch.ones((2, 60, 32, 3)))
    s = stream.cache_stats()
    assert s["misses"] == 2 and s["size"] == 2
    assert s["entries"][-1]["dtype"] == "float32"


def test_video_stream_pins_blocking_depth():
    plan = engine.make_plan(LAYERS, LR, band_rows=12, backend="tilted")
    stream = make_stream(plan, batch_size=2)
    assert stream.session.pipeline_depth == 1
    hr = stream.run(CLIP[:5])
    assert tuple(hr.shape) == (5, 36, 48, 3)
    assert stream.session.stats()["peak_inflight"] == 1
    assert stream.stats()["frames"] == 5
    with pytest.raises(ValueError, match="batch 2"):
        stream.process(CLIP[:3])
