"""queue_wait_p50_ms: the median, over the requests finished in the window,
of each request's wait from entering ``SRServer.submit`` to the launch of
the dispatch holding its first frames (the session's own counter,
``SRSession.stats()["queue_wait_p50_ms"]``, reset when the window opened)."""


def read(run):
    return run.session["queue_wait_p50_ms"] if run.session.get("requests") else None
