"""submit_max_ms: the longest ``SRServer.submit`` call of the window, host
milliseconds (the session's own counter, ``SRSession.stats()
["submit_max_ms"]``): pinning a request's frames and waiting for the
server lock, where a stall of the submit path shows."""


def read(run):
    return run.session["submit_max_ms"] if run.session.get("submits") else None
