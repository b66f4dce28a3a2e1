"""epilogue_ms_per_frame: device milliseconds of ``executor.sr_epilogue``
(anchor add, pixel shuffle, clamp, cast), over the real frames dispatched
(``SRSession.stats()["epilogue_device_ms"]`` and ``["epilogue_frames"]``,
timed by CUDA events on the dispatch's stream)."""


def read(run):
    frames = run.session.get("epilogue_frames")
    return run.session["epilogue_device_ms"] / frames if frames else None
