"""esa_roofline: the whole-frame stages' share of their roofline, in
percent: the least time the card could take for the family's ``esa_work(cfg,
precision)`` (one frame's FLOPs and bytes: each stage's input and output
moved once) on every real frame the window dispatched, the larger of the
FLOPs at the cell's peak and the bytes at the HBM rate, over the stages'
device time (``SRSession.stats()["esa_device_ms"]``, CUDA events)."""

from harness import peaks


def read(run):
    work = getattr(run.family, "esa_work", None)
    ms = run.session.get("esa_device_ms")
    frames = run.sched["frames_dispatched"]
    if work is None or not ms or not frames:
        return None
    flops, nbytes = work(run.config, run.precision)
    least = max(flops / run.peak_flops, nbytes / peaks.HBM_BYTES) * frames
    return 100.0 * least / (ms / 1e3)
