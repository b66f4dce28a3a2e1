"""mfu: the whole serving path's share of the card's peak, in percent:
ABPN's own FLOPs for the frames finished in the window, over the window's
seconds (host clock) times the cell's peak (fp32 served as 3xTF32: TF32's
over 3; bf16: bf16's)."""


def read(run):
    if run.window.seconds <= 0 or not run.frames_done:
        return None
    return 100.0 * run.flops_per_frame * run.frames_done / (run.window.seconds * run.peak_flops)
