"""sched_fill: real frames over bucket slots of the dispatches the
scheduler formed in the window (its own counters, moved over the window)."""


def read(run):
    slots = run.sched["slots_dispatched"]
    return run.sched["frames_dispatched"] / slots if slots else None
