"""The PyTorch port's temporal delta serving vs the JAX package's.

Twins of ``tests/test_temporal.py`` (the mesh subprocess test runs
in-process, on a mesh of cpu positions), plus parity with the JAX
package: band digests byte for byte, slab/bounds marshalling array for
array, the ``verify_delta_cover`` findings rule for rule, and the
delta-served clip within the fp32 tolerance (5e-4) of the JAX full-frame
``session.upscale``.

The splice is held to the PORT's own full re-upscale with ``torch.equal``
(``tilted`` for every boundary policy, ``kernel`` through K1's plain version
for ``zero`` and ``halo``).  JAX delta output is no oracle here: under
``zero``/``replicate`` it is not bit-identical to JAX's own full re-upscale
on a CPU.  Everything runs with ``device="cpu"``; weights are the JAX
package's ``init_abpn`` stack, carried across through numpy.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.analysis.plan_check import verify_delta_cover as jverify_delta_cover
from repro.engine.temporal import band_diff as jband_diff
from repro.models.abpn import ABPNConfig, init_abpn

from repro_torch import engine
from repro_torch.analysis.plan_check import verify_delta_cover
from repro_torch.core.fusion import halo_slabs
from repro_torch.engine.server import RequestCancelledError, SRServer
from repro_torch.engine.temporal import (
    BAND_DIGEST_ALGO,
    DeltaSession,
    OutputBandCache,
    band_bounds,
    band_digest,
    band_digests,
    band_input_rows,
    band_slabs,
    changed_bands,
    dilate_dirty,
    halo_reach,
    window_digest,
    window_rows,
)
from repro_torch.models.abpn import layers_from_numpy
from repro_torch.models.registry import get_sr_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_tuning_db(tmp_path, monkeypatch):
    """Sessions default to ``autotune="cached"``: point the port's tuning DB
    at this test's ``tmp_path``, so no DB outside the test steers a
    schedule and no test writes one."""
    monkeypatch.setenv("REPRO_SR_TORCH_TUNING_DB", str(tmp_path / "tuning.json"))


CFG = ABPNConfig()
JLAYERS = init_abpn(jax.random.PRNGKey(2), CFG)
LAYERS = layers_from_numpy(JLAYERS)
LR = (24, 16, 3)          # band_rows=6 -> 4 bands; halo reach ceil(7/6)=2
BAND_ROWS = 6
L = CFG.num_layers

RNG = np.random.default_rng(7)
FRAME = RNG.random(LR, dtype=np.float32)


def make_session(**kw):
    kw.setdefault("backend", "tilted")
    kw.setdefault("band_rows", BAND_ROWS)
    return engine.SRSession(LAYERS, device="cpu", **kw)


def clip_with_motion(frames: int = 4) -> list:
    """f0, f0 again (static), one-band change, then a fresh frame."""
    clip = [FRAME.copy(), FRAME.copy()]
    f2 = FRAME.copy()
    f2[2 * BAND_ROWS : 2 * BAND_ROWS + 2] += 0.25  # band 2 only
    clip.append(f2)
    clip.append(np.random.default_rng(8).random(LR, dtype=np.float32))
    return clip[:frames]


def assert_equal(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want)


# ----------------------------------------------------------------------
# band_diff: digests, dilation, geometry
# ----------------------------------------------------------------------
def test_halo_reach():
    assert halo_reach(60, 7, "halo") == 1     # the paper's design point
    assert halo_reach(7, 7, "halo") == 1
    assert halo_reach(6, 7, "halo") == 2
    assert halo_reach(3, 7, "halo") == 3
    assert halo_reach(6, 7, "zero") == 0
    assert halo_reach(6, 7, "replicate") == 0


def test_band_digest_localises_changes():
    own = band_digests(FRAME, BAND_ROWS)
    assert len(own) == LR[0] // BAND_ROWS
    bumped = FRAME.copy()
    bumped[BAND_ROWS + 1, 3] += 1.0  # one pixel inside band 1
    assert changed_bands(band_digests(bumped, BAND_ROWS), own) == {1}
    assert changed_bands(own, own) == set()


def test_digest_folds_dtype():
    zeros32 = np.zeros((BAND_ROWS, 4, 1), np.float32)
    zeros_i = np.zeros((BAND_ROWS, 4, 1), np.int32)
    assert zeros32.tobytes() == zeros_i.tobytes()
    assert band_digest(zeros32, BAND_ROWS, 0) != band_digest(zeros_i, BAND_ROWS, 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, np.int32])
def test_digests_equal_the_reference_byte_for_byte(dtype):
    frame = (FRAME * 200).astype(dtype)
    frame[5, 3] += 1  # not a constant frame
    frame = frame[:, ::-1]  # a non-contiguous view is digested as its rows
    assert BAND_DIGEST_ALGO == jband_diff.BAND_DIGEST_ALGO == "blake2b-128"
    assert band_digests(frame, BAND_ROWS) == jband_diff.band_digests(frame, BAND_ROWS)
    for policy in ("zero", "halo", "replicate"):
        for b in range(LR[0] // BAND_ROWS):
            assert window_digest(frame, BAND_ROWS, L, b, policy) == \
                jband_diff.window_digest(frame, BAND_ROWS, L, b, policy)
            assert window_rows(LR[0], BAND_ROWS, L, b, policy) == \
                jband_diff.window_rows(LR[0], BAND_ROWS, L, b, policy)


def test_band_digests_rejects_ragged_height():
    with pytest.raises(ValueError, match="not a multiple"):
        band_digests(FRAME, 7)


def test_changed_bands_rejects_band_count_change():
    with pytest.raises(ValueError, match="digest count changed"):
        changed_bands(band_digests(FRAME, BAND_ROWS), band_digests(FRAME, 12))


def test_dilate_dirty_clips_and_validates():
    # reach 2 at R=6, L=7: band 1 dirties [0, 3]; band 3 dirties [1, 3]
    assert dilate_dirty({1}, 4, BAND_ROWS, L, "halo") == {0, 1, 2, 3}
    assert dilate_dirty({3}, 4, BAND_ROWS, L, "halo") == {1, 2, 3}
    assert dilate_dirty({2}, 4, BAND_ROWS, L, "zero") == {2}
    assert dilate_dirty(set(), 4, BAND_ROWS, L, "halo") == set()
    with pytest.raises(ValueError, match="out of range"):
        dilate_dirty({4}, 4, BAND_ROWS, L, "halo")


def test_dilation_invariant_protects_clean_windows():
    """A band OUTSIDE the dilated dirty set has a byte-identical
    receptive-field window."""
    num_bands = LR[0] // BAND_ROWS
    for policy in ("zero", "halo", "replicate"):
        for changed in range(num_bands):
            bumped = FRAME.copy()
            bumped[changed * BAND_ROWS] += 1.0
            dirty = dilate_dirty({changed}, num_bands, BAND_ROWS, L, policy)
            for b in range(num_bands):
                if b in dirty:
                    continue
                assert window_digest(FRAME, BAND_ROWS, L, b, policy) == \
                    window_digest(bumped, BAND_ROWS, L, b, policy), (policy, changed, b)


def test_window_rows_halo_widens_and_clips():
    assert window_rows(24, 6, 7, 0, "halo") == (0, 13)
    assert window_rows(24, 6, 7, 2, "halo") == (5, 24)
    assert window_rows(24, 6, 7, 1, "zero") == (6, 12)


def test_band_slabs_and_bounds_mirror_halo_slabs():
    """The host marshalling is byte-identical to the port's own
    ``core.fusion.halo_slabs`` — the bit-exact splice starts here."""
    ref_slabs, ref_bounds = halo_slabs(torch.from_numpy(FRAME[None]), BAND_ROWS, L)
    all_bands = list(range(LR[0] // BAND_ROWS))
    mine = band_slabs(FRAME, BAND_ROWS, L, all_bands, "halo")
    np.testing.assert_array_equal(mine, ref_slabs.numpy())
    bounds = band_bounds(LR[0], BAND_ROWS, L, all_bands)
    np.testing.assert_array_equal(bounds, ref_bounds.numpy())
    subset = [0, 2]
    np.testing.assert_array_equal(band_slabs(FRAME, BAND_ROWS, L, subset, "halo"),
                                  ref_slabs.numpy()[subset])
    padded = band_bounds(LR[0], BAND_ROWS, L, subset, slots=4)
    assert padded.shape == (4, 2)
    np.testing.assert_array_equal(padded[2:], 0)
    assert band_input_rows(BAND_ROWS, L, "zero") == BAND_ROWS
    np.testing.assert_array_equal(band_slabs(FRAME, BAND_ROWS, L, [1], "zero")[0],
                                  FRAME[BAND_ROWS : 2 * BAND_ROWS])


@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
def test_band_slabs_and_bounds_equal_the_reference(policy):
    for subset in ([0], [1, 3], [0, 1, 2, 3]):
        mine = band_slabs(FRAME, BAND_ROWS, L, subset, policy)
        ref = jband_diff.band_slabs(FRAME, BAND_ROWS, L, subset, policy)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
        for slots in (0, 4, 8):
            mb = band_bounds(LR[0], BAND_ROWS, L, subset, slots=slots)
            rb = jband_diff.band_bounds(LR[0], BAND_ROWS, L, subset, slots=slots)
            assert mb.dtype == rb.dtype
            np.testing.assert_array_equal(mb, rb)
        assert band_input_rows(BAND_ROWS, L, policy) == \
            jband_diff.band_input_rows(BAND_ROWS, L, policy)


# ----------------------------------------------------------------------
# OutputBandCache (values are tensors)
# ----------------------------------------------------------------------
def band_value(seed: int, nbytes: int = 1024) -> torch.Tensor:
    return torch.full((nbytes // 4,), float(seed), dtype=torch.float32)


def test_cache_lru_eviction_bound():
    cache = OutputBandCache(max_bytes=2048)
    cache.put("a", band_value(1))
    cache.put("b", band_value(2))
    assert cache.get("a") is not None  # refresh: "b" is now LRU
    cache.put("c", band_value(3))
    s = cache.stats()
    assert s["bytes"] <= 2048 and s["evictions"] == 1
    assert cache.peek("b") is None and cache.peek("a") is not None


def test_cache_put_copies_and_dedupes():
    cache = OutputBandCache(max_bytes=1 << 20)
    src = band_value(1)
    cache.put("k", src)
    src[:] = -1.0  # mutating the source must not reach the cache
    assert torch.equal(cache.get("k"), band_value(1))
    cache.put("k", band_value(9))  # same key: no-op, same bytes by contract
    assert cache.stats()["puts"] == 1
    assert torch.equal(cache.peek("k"), band_value(1))
    # a slice is stored as its own contiguous copy, not a view of its parent
    parent = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    cache.put("view", parent[2:4, ::2])
    stored = cache.peek("view")
    assert stored.is_contiguous() and stored.untyped_storage().nbytes() == 8 * 4
    assert cache.stats()["bytes"] == band_value(1).numel() * 4 + 8 * 4


def test_cache_pins_block_eviction():
    cache = OutputBandCache(max_bytes=1024)
    cache.put("a", band_value(1))
    cache.pin("a")
    cache.put("b", band_value(2))  # over budget: the unpinned "b" goes
    assert cache.peek("a") is not None and cache.peek("b") is None
    cache.put("b", band_value(2), pin=True)
    cache.put("c", band_value(3))
    s = cache.stats()
    assert cache.peek("a") is not None and cache.peek("b") is not None
    assert s["bytes"] > s["max_bytes"] and s["pinned"] == 2  # visible overrun
    cache.unpin("a")
    cache.unpin("b")
    assert cache.stats()["bytes"] <= 1024
    assert cache.pinned == 0


def test_cache_pin_errors():
    cache = OutputBandCache(max_bytes=1024)
    with pytest.raises(KeyError):
        cache.pin("missing")
    cache.put("a", band_value(1))
    with pytest.raises(ValueError, match="unbalanced"):
        cache.unpin("a")
    with pytest.raises(ValueError, match="positive"):
        OutputBandCache(max_bytes=0)


def test_cache_counters():
    cache = OutputBandCache(max_bytes=1 << 20)
    assert cache.get("a") is None
    cache.put("a", band_value(1))
    cache.get("a")
    cache.peek("a")  # peek is uncounted
    s = cache.stats()
    assert (s["hits"], s["misses"]) == (1, 1)
    assert s["hit_rate"] == 0.5
    assert s["bytes_saved"] == band_value(1).numel() * 4
    assert cache.get("a", pin=True) is not None
    assert cache.pinned == 1
    assert cache.get("missing", pin=True) is None
    cache.unpin("a")
    assert cache.pinned == 0


# ----------------------------------------------------------------------
# plan_check: the splice invariant rule
# ----------------------------------------------------------------------
def delta_plan(policy="halo"):
    return engine.make_plan(LAYERS, LR, band_rows=BAND_ROWS, backend="tilted",
                            vertical_policy=policy)


def jdelta_plan(policy="halo"):
    return jengine.make_plan(JLAYERS, LR, band_rows=BAND_ROWS, backend="tilted",
                             vertical_policy=policy)


def test_verify_delta_cover_accepts_valid_partition():
    assert verify_delta_cover(delta_plan(), [1, 2, 3], changed_bands=[3]) == []
    assert verify_delta_cover(delta_plan("zero"), [2], changed_bands=[2]) == []
    assert verify_delta_cover(delta_plan(), []) == []


def test_verify_delta_cover_flags_bad_sets():
    dup = verify_delta_cover(delta_plan(), [1, 1, 2])
    assert [f.rule for f in dup] == ["delta_cover"]
    oob = verify_delta_cover(delta_plan(), [4])
    assert [f.rule for f in oob] == ["delta_cover"]
    assert all(f.severity == "error" for f in dup + oob)


def test_verify_delta_cover_flags_missing_dilation():
    stale = verify_delta_cover(delta_plan(), [3], changed_bands=[3])
    assert "delta_dilation" in [f.rule for f in stale]
    assert verify_delta_cover(delta_plan("zero"), [3], changed_bands=[3]) == []


@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
def test_verify_delta_cover_matches_the_reference(policy):
    cases = [([1, 2, 3], [3]), ([2], [2]), ([], None), ([1, 1, 2], None), ([4], None),
             ([-1, 0], [0]), ([3], [3]), ([0], [1]), ([0, 1, 2, 3], [0, 1, 2, 3])]
    for dirty, changed in cases:
        mine = [(f.checker, f.rule, f.severity, f.message)
                for f in verify_delta_cover(delta_plan(policy), dirty, changed_bands=changed)]
        ref = [(f.checker, f.rule, f.severity, f.message)
               for f in jverify_delta_cover(jdelta_plan(policy), dirty, changed_bands=changed)]
        assert mine == ref, (dirty, changed)


# ----------------------------------------------------------------------
# submit_bands: partial dispatches through the scheduler
# ----------------------------------------------------------------------
def test_submit_bands_matches_full_upscale_rows():
    session = make_session(vertical_policy="halo")
    with SRServer({"abpn": session}) as server:
        full = session.upscale(FRAME)
        plan = session.plan_for(LR)
        subset = [0, 2]
        slabs = band_slabs(FRAME, BAND_ROWS, L, subset, "halo")
        out = server.submit_bands(slabs, subset, plan=plan).result()
        hr = BAND_ROWS * plan.scale
        for i, b in enumerate(subset):
            assert_equal(out[i], full[b * hr : (b + 1) * hr])
        recent = server.scheduler_stats()["recent_dispatches"]
        assert recent[-1]["bands"] == list(subset)


def test_submit_bands_validation():
    session = make_session(vertical_policy="halo")
    with SRServer({"abpn": session}) as server:
        plan = session.plan_for(LR)
        slabs = band_slabs(FRAME, BAND_ROWS, L, [0, 1], "halo")
        with pytest.raises(ValueError, match="strictly increasing"):
            server.submit_bands(slabs, [1, 0], plan=plan)
        with pytest.raises(ValueError, match="range"):
            server.submit_bands(slabs, [3, 4], plan=plan)
        with pytest.raises(ValueError):
            server.submit_bands(slabs[:, :-1], [0, 1], plan=plan)


def test_cancel_fails_future_and_releases_queue():
    session = make_session()
    with SRServer({"abpn": session}) as server:
        fut = server.submit(FRAME[None])
        assert server.cancel(fut) is True
        assert isinstance(fut.exception(), RequestCancelledError)
        g = server.scheduler_stats()
        assert g["pending_frames"] == 0 and g["carry_buckets"] == 0
        done = server.submit(FRAME[None])
        done.result()
        assert server.cancel(done) is False


# ----------------------------------------------------------------------
# DeltaSession: parity + reuse
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["zero", "halo", "replicate"])
def test_delta_session_bit_exact_and_reuses(policy):
    session = make_session(vertical_policy=policy)
    clip = clip_with_motion()
    with DeltaSession(session) as ds:
        for frame in clip:
            out = ds.serve(frame)
            assert out.device.type == "cpu"
            assert_equal(out, session.upscale(frame))
    t = session.temporal_stats()
    assert t["frames"] == len(clip)
    assert t["bands_skipped"] > 0 and 0 < t["reuse_ratio"] < 1
    assert t["band_rows_served"] < t["band_rows_total"]
    assert t["band_rows_dispatched"] == t["band_rows_served"]
    assert t["cover_violations"] == 0
    assert t["cache"]["hits"] == t["bands_skipped"]
    num_bands = LR[0] // BAND_ROWS
    assert t["bands_skipped"] >= num_bands
    assert session.stats()["temporal"]["frames"] == len(clip)


@pytest.mark.parametrize("policy", ["zero", "halo"])
def test_delta_session_kernel_backend_bit_exact(policy):
    """The kernel backend (K1's plain version on the CPU): partial-band
    dispatches of 1 and 3 dirty bands (buckets 1 and 4, a padded slot)
    splice bit-exactly."""
    session = engine.SRSession(LAYERS, backend="kernel", band_rows=BAND_ROWS,
                               vertical_policy=policy, device="cpu")
    clip = [FRAME.copy(), FRAME.copy(), clip_with_motion(3)[2]]
    with DeltaSession(session) as ds:
        for frame in clip:
            assert_equal(ds.serve(frame), session.upscale(frame))
    assert session.temporal_stats()["bands_skipped"] > 0
    bands = [d["bands"] for d in session._server.scheduler_stats()["recent_dispatches"]
             if d["bands"] is not None]
    assert bands[-1] == ([2] if policy == "zero" else [0, 1, 2, 3])


@pytest.mark.parametrize("backend,policy", [("tilted", "zero"), ("tilted", "halo"),
                                            ("tilted", "replicate"), ("kernel", "halo")])
def test_delta_clip_matches_the_jax_full_frame_upscale(backend, policy):
    """Delta-served frames against the JAX package's full-frame
    ``session.upscale`` on the same weights (fp32 tolerance)."""
    jsession = jengine.SRSession(JLAYERS, backend="tilted", band_rows=BAND_ROWS,
                                 vertical_policy=policy, autotune="off")
    session = engine.SRSession(LAYERS, backend=backend, band_rows=BAND_ROWS,
                               vertical_policy=policy, device="cpu")
    clip = clip_with_motion()
    with DeltaSession(session) as ds:
        for frame in clip:
            out = ds.serve(frame).numpy()
            want = np.asarray(jsession.upscale(frame))
            assert out.shape == want.shape
            np.testing.assert_allclose(out, want, atol=5e-4, rtol=0)
    assert session.temporal_stats()["bands_skipped"] > 0


def test_delta_session_serves_tensors_and_other_dtypes():
    """A tensor frame digests like its numpy twin (one host copy); float64
    serves as float32, and bfloat16 keeps its own cache keys."""
    session = make_session()
    clip = clip_with_motion(3)
    with DeltaSession(session) as ds:
        for frame in clip:
            assert_equal(ds.serve(torch.from_numpy(frame)), session.upscale(frame))
        skipped = session.temporal_stats()["bands_skipped"]
        assert_equal(ds.serve(clip[-1].astype(np.float64)), session.upscale(clip[-1]))
        assert session.temporal_stats()["bands_skipped"] == skipped + 4  # same bytes
        bf = torch.from_numpy(clip[-1]).to(torch.bfloat16)
        out = ds.serve(bf)  # a new dtype: nothing of the float32 frames splices
        assert out.dtype == torch.bfloat16
        assert_equal(out, session.upscale(bf))
        assert session.temporal_stats()["bands_skipped"] == skipped + 4
        assert_equal(ds.serve(bf), out)
        assert session.temporal_stats()["bands_skipped"] == skipped + 8


def test_delta_session_rejects_reference_backend():
    session = engine.SRSession(LAYERS, backend="reference", device="cpu")
    with pytest.raises(ValueError, match="banded backend"):
        DeltaSession(session)
    ref_plan = engine.make_plan(LAYERS, LR, band_rows=BAND_ROWS, backend="reference")
    with pytest.raises(ValueError, match="reference"):
        make_session().band_executor_for(ref_plan, 1, torch.float32)


def test_delta_session_plan_switch_resets_state():
    session = make_session(vertical_policy="halo")
    small = RNG.random((12, 16, 3), dtype=np.float32)
    with DeltaSession(session) as ds:
        ds.serve(FRAME)
        out = ds.serve(small)  # resolution switch mid-stream
        assert_equal(out, session.upscale(small))
        assert session.output_cache().pinned == 12 // BAND_ROWS
        assert_equal(ds.serve(FRAME), session.upscale(FRAME))
    assert session.output_cache().pinned == 0


def test_delta_session_close_semantics():
    session = make_session()
    ds = DeltaSession(session)
    ds.serve(FRAME)
    ds.close()
    ds.close()  # idempotent
    assert session.output_cache().pinned == 0
    with pytest.raises(RuntimeError, match="closed"):
        ds.serve(FRAME)


def test_delta_session_survives_external_cache_eviction():
    # a cache too small to hold even one frame's bands: every "clean" band
    # misses residency and is re-served — pure cost, still exact
    session = make_session(vertical_policy="zero")
    with DeltaSession(session, cache_bytes=1024) as ds:
        for frame in clip_with_motion(3):
            assert_equal(ds.serve(frame), session.upscale(frame))
    assert session.temporal_stats()["cover_violations"] == 0


# ----------------------------------------------------------------------
# stream(delta=True) + abandoned-stream cleanup
# ----------------------------------------------------------------------
def test_stream_delta_end_to_end():
    session = make_session(vertical_policy="halo")
    clip = clip_with_motion()
    with SRServer({"abpn": session}) as server:
        async def run():
            return [hr async for hr in server.stream(clip, delta=True)]

        outs = asyncio.run(run())
    refs = session.upscale(np.stack(clip))
    assert len(outs) == len(clip)
    for out, ref in zip(outs, refs):
        assert_equal(out, ref)
    t = session.temporal_stats()
    assert t["frames"] == len(clip) and t["bands_skipped"] > 0


@pytest.mark.parametrize("delta", [False, True])
def test_abandoned_stream_releases_resources(delta):
    """aclose() after one frame leaves no queued frames, no pinned carry
    buckets, and (delta) no pinned cache entries behind."""
    session = make_session(vertical_policy="halo")
    clip = [FRAME.copy() for _ in range(6)]
    with SRServer({"abpn": session}) as server:
        async def run():
            gen = server.stream(clip, delta=delta, lookahead=4)
            async for _ in gen:
                break  # abandon after the first frame
            await gen.aclose()

        asyncio.run(run())
        g = server.scheduler_stats()
        assert g["pending_frames"] == 0
        assert g["carry_buckets"] == 0
        assert g["inflight_dispatches"] == 0
    if delta:
        assert session.output_cache().pinned == 0


def test_cancel_of_an_in_flight_band_dispatch_discards_its_rows():
    """A band dispatch already launched completes; cancelling its request
    fails the future and the rows are discarded (pins released by close)."""
    session = make_session(vertical_policy="zero", pipeline_depth=2)
    with SRServer({"abpn": session}) as server:
        plan = session.plan_for(LR)
        slabs = band_slabs(FRAME, BAND_ROWS, L, [1], "zero")
        fut = server.submit_bands(slabs, [1], plan=plan)
        server._step()  # launched, not yet completed
        assert server.scheduler_stats()["inflight_dispatches"] == 1
        assert server.cancel(fut) is True
        server.flush()
        assert isinstance(fut.exception(), RequestCancelledError)
        s = server.scheduler_stats()
        assert s["inflight_dispatches"] == 0 and s["pending_frames"] == 0
        assert session.temporal_stats()["band_dispatches"] == 1


# ----------------------------------------------------------------------
# satellite: registry error
# ----------------------------------------------------------------------
def test_registry_unknown_model_lists_names_and_suggests():
    with pytest.raises(ValueError) as exc:
        get_sr_model("abpn-3x")
    msg = str(exc.value)
    assert "abpn_x3" in msg
    assert "abpn-x3" in msg
    assert "did you mean 'abpn-x3'" in msg
    with pytest.raises(ValueError) as exc2:
        get_sr_model("totally_unknown")
    assert "registered" in str(exc2.value)


def test_concurrent_delta_streams_share_one_session():
    """Twelve threads (more than the cores) each run a DeltaSession over one
    shared session, server and output cache, with a short switch interval:
    every frame equals its full re-upscale, the shared counters lose no
    update, and no pin is left behind."""
    import sys
    import threading

    session = make_session(vertical_policy="halo")
    server = SRServer({"abpn": session})
    clip = clip_with_motion()
    refs = [session.upscale(f) for f in clip]
    workers, rounds, errors = 12, 3, []

    def stream():
        try:
            for _ in range(rounds):
                with DeltaSession(session, server=server) as ds:
                    for frame, ref in zip(clip, refs):
                        assert torch.equal(ds.serve(frame), ref)
        except Exception as e:  # pragma: no cover - diagnostics
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=stream) for _ in range(workers)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
            assert not t.is_alive(), "delta stream hung"
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    t = session.temporal_stats()
    assert t["frames"] == workers * rounds * len(clip)
    assert t["bands_total"] == t["frames"] * (LR[0] // BAND_ROWS)
    assert t["cache"]["pinned"] == 0 and t["cover_violations"] == 0
    s = server.scheduler_stats()
    assert s["pending_frames"] == 0 and s["inflight_dispatches"] == 0


def test_delta_parity_on_mesh_session():
    """The twin of the JAX package's mesh subprocess test, in-process on a
    (2, 2) mesh of cpu positions: partial-band dispatches run locally,
    unsharded, on the session's device, and the splice is bit-exact vs the
    SHARDED full re-upscale (itself bit-exact vs single-device)."""
    session = make_session(vertical_policy="halo", mesh=(2, 2), autotune="off")
    rng = np.random.default_rng(7)
    base = rng.random(LR, dtype=np.float32)
    moved = base.copy()
    moved[12:14] += 0.25
    clip = [base, base.copy(), moved]
    with DeltaSession(session) as ds:
        for f in clip:
            assert torch.equal(ds.serve(f), session.upscale(f))
    t = session.temporal_stats()
    assert t["bands_skipped"] > 0, t
    stats = session.sharding_stats()
    assert stats["mesh"] == "2x2" and sum(r["dispatches"] for r in stats["replicas"]) == 3
