"""k1_seg_roofline: K1's share of its roofline for a staged model's
segments, in percent: the least time the card could take for the K1 work
of the frames K1 computed (every real frame the window dispatched: a
staged model's dispatch computes no bucket padding), over K1's device time
in the trace.  The work is the family's ``k1_work(cfg,
precision)`` for one frame, FLOPs and bytes (each segment's input, its own
residual and its output moved once); the least time is the larger of the
FLOPs at the cell's peak and the bytes at the HBM rate."""

from harness import peaks
from harness.kernels import is_k1


def read(run):
    work = getattr(run.family, "k1_work", None)
    if run.trace is None or work is None:
        return None
    k1_s = run.trace.device_seconds(is_k1)
    frames = run.sched["frames_dispatched"]
    if k1_s <= 0 or not frames:
        return None
    flops, nbytes = work(run.config, run.precision)
    least = max(flops / run.peak_flops, nbytes / peaks.HBM_BYTES) * frames
    return 100.0 * least / k1_s
