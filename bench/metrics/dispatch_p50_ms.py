"""dispatch_p50_ms: the median of the session's own launch-to-ready
latencies of the window's dispatches (``SRSession.stats()["p50_ms"]``,
reset when the window opened)."""


def read(run):
    return run.session["p50_ms"] if run.session.get("batches") else None
