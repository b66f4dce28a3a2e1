"""frames_per_s: HR frames of every request sent in the window, over the
window's seconds, from its opening to when the last of those requests was
ready (host clock): a rate over all the window's work and all its time."""


def read(run):
    if run.traffic["kind"] != "closed" or run.window.seconds <= 0:
        return None
    return run.frames_done / run.window.seconds
