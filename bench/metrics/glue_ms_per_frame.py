"""glue_ms_per_frame: device milliseconds of every kernel, copy and memset
in the traced window that is not K1's, per frame finished in it."""

from harness.kernels import is_k1


def read(run):
    if run.trace is None or not run.frames_done or not run.trace.count(is_k1):
        return None
    glue = run.trace.device_seconds(lambda name: not is_k1(name))
    return glue * 1e3 / run.frames_done
