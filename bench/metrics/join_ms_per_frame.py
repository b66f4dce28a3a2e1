"""join_ms_per_frame: device milliseconds of the ``cat`` that joins a
request's pieces from its dispatches (``SRServer._finish_request``), over
the frames of the requests it joined (``SRSession.stats()["join_device_ms"]``
and ``["join_frames"]``, timed by CUDA events on the stream of the ``cat``)."""


def read(run):
    frames = run.session.get("join_frames")
    return run.session["join_device_ms"] / frames if frames else None
