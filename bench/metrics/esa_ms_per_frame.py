"""esa_ms_per_frame: device milliseconds of a staged model's whole-frame
stages (RLFN's c5 and ESA), over the real frames dispatched
(``SRSession.stats()["esa_device_ms"]`` and ``["esa_frames"]``, timed by
CUDA events on the dispatch's stream); nothing where the program has no
such stage."""


def read(run):
    frames = run.session.get("esa_frames")
    return run.session["esa_device_ms"] / frames if frames else None
