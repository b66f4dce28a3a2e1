"""Serve super-resolution through the SRServer front door of the PyTorch
package (``repro_torch.engine``) — the twin of ``examples/serve_sr.py``.

One server = one or more models behind a micro-batching scheduler: callers
``submit(frames)`` and get an ``SRFuture`` back; concurrent requests that
share a ``(model, plan, dtype)`` key are coalesced into single bucket-sized
dispatches (real frames fill the power-of-two buckets instead of padding),
and ``server.stream(...)`` serves frame-at-a-time live video.  This demo:

1. submits a burst of concurrent small requests and resolves them together
   (the scheduler packs the burst into full buckets),
2. streams single frames through the async generator,
3. sends a second resolution through the SAME server (a new plan-cache
   entry, no new object graph),

then prints the coalescing counters next to the serving latency stats.

When more than one CUDA card is visible the server runs MESH-SHARDED:
frame rows are band-sharded over a ``bands`` device axis (halo exchange at
shard edges keeps outputs bit-exact) and dispatches are routed across
replicas.  ``--mesh auto`` (the default) picks the largest topology every
demo resolution can shard across; on a single device (one card, or
``--device cpu``) it falls back to ordinary serving.

``--delta`` demos TEMPORAL DELTA SERVING instead: a synthetic
static-camera clip (identical frames after the first, then a few frames
with one moving patch) streams through ``server.stream(delta=True)`` —
only changed bands (dilated by the halo reach) are dispatched, clean
bands splice from the output cache bit-exact, and the reuse counters
print at the end.

Runs on the CUDA card(s) unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_serve_sr.py --frames 16 --batch 4
    PYTHONPATH=src python examples/torch_serve_sr.py --backend tilted --precision bf16
    PYTHONPATH=src python examples/torch_serve_sr.py --delta --frames 8
    PYTHONPATH=src python examples/torch_serve_sr.py --frames 4 --batch 2 --device cpu
"""

import argparse
import asyncio
import sys

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.data.synthetic import sr_pair_batch
from repro_torch.engine import SRServer
from repro_torch.engine.plan import shardable_band_rows


async def stream_clip(server, clip):
    outs = []
    async for hr in server.stream(list(clip), lookahead=4):
        outs.append(hr)
    return outs


async def stream_delta(server, clip):
    outs = []
    async for hr in server.stream(list(clip), delta=True):
        outs.append(hr)
    return outs


def run_delta_demo(server, session, args):
    """Static-camera clip through the delta path; prints reuse counters."""
    base, _ = sr_pair_batch(
        args.seed, 1, lr_shape=(args.height, args.width), scale=session.scale
    )
    base = base[0].numpy()
    clip = [base.copy() for _ in range(max(2, args.frames))]
    # a small "moving object" crosses one band in the last two frames —
    # everything else is a static camera
    patch = args.height // 6
    clip[-2][:patch, :patch] += 0.25
    clip[-1][patch : 2 * patch, :patch] += 0.25
    outs = asyncio.run(stream_delta(server, clip))
    ref = session.upscale(np.stack(clip))
    exact = all(torch.equal(o, r) for o, r in zip(outs, ref))
    t = session.temporal_stats()
    cache = t["cache"]
    print(f"delta serving: {t['frames']} frames, "
          f"{t['bands_skipped']}/{t['bands_total']} bands spliced from "
          f"cache (reuse {t['reuse_ratio']:.2f}), "
          f"{t['band_rows_served']}/{t['band_rows_total']} band-rows computed")
    print(f"output cache: {cache['hits']} hits / {cache['misses']} misses, "
          f"{cache['bytes_saved'] / 1e6:.2f} MB recompute avoided, "
          f"{cache['entries']} entries ({cache['bytes'] / 1e6:.2f} MB), "
          f"{cache['evictions']} evictions")
    print(f"effective HBM traffic {t['effective_hbm_bytes_per_frame'] / 1e6:.2f} "
          f"MB/frame vs {t['full_hbm_bytes_per_frame'] / 1e6:.2f} MB/frame full "
          f"re-upscale; splice bit-exact vs full: {exact}")


def pick_mesh(heights, devices):
    """The largest (replicas, band_shards) serving mesh that fits the
    visible devices AND can band-shard every resolution the demo serves;
    None when only single-device serving is possible."""
    for shards in range(min(devices, 8), 1, -1):
        if all(shardable_band_rows(h, shards) is not None for h in heights):
            return (max(1, devices // shards), shards)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="abpn_x3",
                    help="registered SR model (weights via models.registry)")
    ap.add_argument("--frames", type=int, default=8, help="total frames to serve")
    ap.add_argument("--batch", type=int, default=4,
                    help="frames per submitted request")
    ap.add_argument("--height", type=int, default=120)  # paper: 360
    ap.add_argument("--width", type=int, default=64)    # paper: 640
    ap.add_argument("--backend", default="kernel",
                    choices=["reference", "tilted", "kernel"])
    ap.add_argument("--precision", default="int8",
                    choices=["fp32", "bf16", "int8"],
                    help="int8 = the accelerator's weight storage numerics")
    ap.add_argument("--policy", default="zero",
                    choices=["zero", "halo", "replicate"],
                    help="vertical band boundary policy (all backends)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="dispatches in flight per session (1 = blocking, "
                         "2 = double-buffered)")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="queue bound in frames (backpressure); default unbounded")
    ap.add_argument("--mesh", default="auto",
                    help='serving mesh "RxS" (replicas x band shards), '
                         '"auto" to derive one from the visible devices, '
                         '"off" to force single-device serving')
    ap.add_argument("--route", default="least_loaded",
                    choices=["round_robin", "least_loaded"],
                    help="replica routing policy (multi-replica meshes)")
    ap.add_argument("--delta", action="store_true",
                    help="demo temporal delta serving on a synthetic "
                         "static-camera clip (reuse counters, bit-exact "
                         "splice)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.mesh == "auto":
        heights = (args.height, args.height // 2)
        mesh = pick_mesh(heights, devices)
        # say what auto decided and WHY — a silent fallback reads as the
        # sharded path running when it is not
        if mesh is None:
            print(f"auto mesh: no topology can band-shard heights {heights} "
                  f"across the {devices} visible device(s) -> falling back "
                  "to single-device serving")
        else:
            print(f"auto mesh: picked {mesh[0]}x{mesh[1]} (replicas x band "
                  f"shards) from the {devices} visible device(s)")
    elif args.mesh == "off":
        mesh = None
    else:
        r, s = (int(x) for x in args.mesh.split("x"))
        mesh = (r, s)
    if mesh is not None and mesh[0] * mesh[1] <= 1:
        mesh = None
    if mesh is None:
        print(f"single-device serving on {device} ({devices} device(s) visible; "
              "more than one CUDA card demos the sharded path)")
    else:
        print(f"mesh serving: {mesh[0]} replica(s) x {mesh[1]} band "
              f"shard(s) over {mesh[0] * mesh[1]} of {devices} visible "
              f"device(s), route={args.route}")
    mesh_kw = {} if mesh is None else {"mesh": mesh, "route": args.route}

    server = SRServer.open(
        args.model,
        backend=args.backend,
        precision=args.precision,
        vertical_policy=args.policy,
        pipeline_depth=args.pipeline_depth,
        max_inflight_frames=args.max_inflight,
        seed=args.seed,
        device=device,
        **mesh_kw,
    )
    session = server.session()

    try:
        if args.delta:
            run_delta_demo(server, session, args)
        else:
            run_demo(server, session, args)
    finally:
        server.close()
    return 0


def run_demo(server, session, args):
    """The burst, the stream and the second resolution; prints the
    counters."""
    # 1) A burst of concurrent requests: submit them ALL, then resolve —
    # the first request per (resolution, bucket) compiles on a dummy,
    # outside the latency stats; the scheduler coalesces the queued burst
    # into shared bucket-sized dispatches.
    if args.frames > 0:
        lr_frames, _ = sr_pair_batch(
            0, args.frames, lr_shape=(args.height, args.width),
            scale=session.scale
        )
        futures = [
            server.submit(lr_frames[i : i + args.batch])
            for i in range(0, args.frames, args.batch)
        ]
        for f in futures:
            f.result()

    # 2) Frame-at-a-time live video through the async generator (the
    # lookahead keeps the coalescer's queue full even for one stream).
    stream_frames, _ = sr_pair_batch(
        3, 4, lr_shape=(args.height, args.width), scale=session.scale
    )
    asyncio.run(stream_clip(server, stream_frames))

    s = session.stats()  # main-resolution stats (snapshot before lr2)

    # 3) Same server, different resolution: just a new plan-cache entry
    # (shape-agnostic serving is the point of the API).
    h2, w2 = args.height // 2, args.width
    if h2 > 0:
        lr2, _ = sr_pair_batch(1, 2, lr_shape=(h2, w2), scale=session.scale)
        server.submit(lr2).result()

    plan = session.plan_for((args.height, args.width, session.layers[0].ci))
    c = session.cache_stats()
    g = server.scheduler_stats()
    print(f"server: {server.models[0]} {plan.backend}/{plan.precision}, "
          f"{plan.num_bands} bands x {plan.schedule.num_tiles} tiles")
    print(f"served {s['frames']} frames over {s['batches']} dispatches "
          f"({args.height}x{args.width} -> {plan.hr_shape[0]}x{plan.hr_shape[1]}, "
          f"plus a {h2}x{w2} request)")
    print(f"throughput {s['fps']:.1f} frames/s  complete p50 {s['p50_ms']:.1f} ms  "
          f"p99 {s['p99_ms']:.1f} ms  dispatch p50 {s['dispatch_p50_ms']:.2f} ms  "
          f"(depth {args.pipeline_depth}, peak in-flight {s['peak_inflight']}, "
          f"{session.device})")
    print(f"scheduler: {g['submitted_requests']} requests -> "
          f"{g['dispatches']} dispatches ({g['coalesced_dispatches']} coalesced), "
          f"mean bucket fill {g['mean_fill_ratio']:.2f}, "
          f"{g['padded_frames']} padded frames, peak queue "
          f"{g['peak_pending_frames']} frames")
    print(f"plan cache: {c['misses']} compiles, {c['hits']} hits, "
          f"hit rate {c['hit_rate']:.2f}; buckets "
          f"{[(tuple(e['lr_shape'][:2]), e['bucket'], round(e['compile_s'], 2)) for e in c['entries']]}")
    sh = session.sharding_stats()
    if sh is not None:
        print(f"sharding: mesh {sh['mesh']} ({sh['policy']}), replica fill "
              f"{sh['replica_fill']:.2f}, halo "
              f"{sh['halo_bytes_per_frame'] / 1e3:.1f} kB/frame, "
              f"dispatches per replica "
              f"{[r['dispatches'] for r in sh['replicas']]}")
    pix = args.height * args.width * session.scale ** 2
    print(f"modeled accelerator: {pix/1e6:.2f} Mpix/frame at 124.4 Mpix/s -> "
          f"{pix/124.4e6*1e3:.2f} ms/frame @600 MHz")


if __name__ == "__main__":
    sys.exit(main())
