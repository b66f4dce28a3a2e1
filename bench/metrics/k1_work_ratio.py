"""k1_work_ratio: the FLOPs K1 executed for the window's dispatches, as the
program counts them for each dispatch's bucket (``tilted_fusion.
launch_cost`` at the card's segment plan), over ABPN's own FLOPs for the
real frames: the bucket padding, warm-up tiles and tile slack K1 computes
beyond ABPN."""


def read(run):
    if not run.buckets or not run.k1_executed_flops or not run.sched["frames_dispatched"]:
        return None
    executed = sum(run.k1_executed_flops[b] for b in run.buckets)
    if not executed:
        return None
    return executed / (run.flops_per_frame * run.sched["frames_dispatched"])
