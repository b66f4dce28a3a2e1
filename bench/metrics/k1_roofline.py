"""k1_roofline: K1's share of its roofline, in percent: the least time
the card could take for ABPN's own work on the frames K1 computed (every
bucket slot the window dispatched), over K1's device time in the trace.
The least time is the larger of the FLOPs at the cell's peak and the bytes
at the HBM rate, each LR byte read once and each feature byte K1 writes
written once."""

from harness import inputs, peaks
from harness.kernels import is_k1


def read(run):
    if run.trace is None:
        return None
    k1_s = run.trace.device_seconds(is_k1)
    slots = run.sched["slots_dispatched"]
    if k1_s <= 0 or not slots:
        return None
    h, w, c0 = inputs.lr_shape(run.config)
    esize = peaks.element_bytes(run.precision)
    nbytes = h * w * (c0 + int(run.config["out_channels"])) * esize
    least = max(run.flops_per_frame / run.peak_flops, nbytes / peaks.HBM_BYTES) * slots
    return 100.0 * least / k1_s
