"""pin_ms_per_frame: host milliseconds the window's submits spent copying
requests' frames into pinned memory (``SRServer._pinned_for``), over the
frames they pinned (``SRSession.stats()["pin_ms"]`` and ``["pin_frames"]``)."""


def read(run):
    frames = run.session.get("pin_frames")
    return run.session["pin_ms"] / frames if frames else None
