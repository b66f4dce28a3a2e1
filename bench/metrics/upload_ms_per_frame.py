"""upload_ms_per_frame: device milliseconds of what each dispatch runs
before K1 (the copies of its frames to the card, their ``cat``, the zero
pad, the cast to the compute dtype), over the real frames dispatched
(``SRSession.stats()["upload_device_ms"]`` and ``["upload_frames"]``, timed
by CUDA events on the dispatch's stream)."""


def read(run):
    frames = run.session.get("upload_frames")
    return run.session["upload_device_ms"] / frames if frames else None
