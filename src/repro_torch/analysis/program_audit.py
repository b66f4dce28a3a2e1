"""Program audit: scan what one serving call ACTUALLY runs.

The serving guarantees — weight prep hoisted out of the hot path, no host
round-trips inside a dispatch, the plan's precision on the card — are
properties of what the executor runs, not of the Python source.  This pass
takes :func:`~repro_torch.engine.executor.executor_artifacts` of every
executor a session's :class:`~repro_torch.engine.session.PlanCache` holds
and applies the JAX package's rules (``analysis/program_audit.py``) to
them:

* ``quant_in_hot_path`` — ``aten.round`` in the call's ops.  The int8
  policy rounds weights exactly once in ``prepare_stack``; a round inside
  the call means the quantise round-trip moved into the hot path.
* ``host_transfer`` — data crosses to the host inside the call: a
  device-to-host copy in the profiler's trace, ``aten._local_scalar_dense``
  (``.item()``), or an op that takes a tensor on the card and returns one
  on the CPU.
* ``host_callback`` — the host waits for the card inside the call: a
  stream, event or device synchronize (or a synchronous ``cudaMemcpy``)
  among the runtime calls the profiler records in the call's own span, or
  an op that copies host data to the device (torch synchronizes the
  stream after a copy from pageable host memory).  The profiler's own
  calls, and the synchronize that closes its window, lie outside that
  span and do not count.
* ``fp32_upcast`` — a bf16 plan whose computation runs in fp32 throughout:
  no op after the first convolution (or matmul) emits bf16, so no feature
  map is rounded to bf16; or, on the card, every K1/K2 instance the
  profiler names is the fp32 one.  Products accumulate in fp32 by design
  (the ops widen bf16 maps before a convolution), so the rule looks at
  what is stored, not at the products.  int8 plans compute in fp32
  (dequant-on-read), so the rule applies to ``bf16`` only.
* ``hot_path_build`` — a kernel library loaded (or compiled by ``nvcc``)
  inside the call.  A warmed executor never builds; this is the port's
  counterpart of the JAX package's compile inside the serving call, and
  its one new rule name.
* ``donation_ignored`` (info) — the entry was built with
  ``donate_frames``.  Eager PyTorch has no buffer donation (the frame slab
  is freed when its last reference goes), so the option is a no-op and the
  JAX package's ``missing_donation`` / ``donation_bookkeeping`` rules have
  nothing to compare: the entry's one flag is the session's option.
* ``recompile`` — a cache key built more than once (evicted and re-missed).

:func:`audit_server` applies ``host_callback`` to the server's launch on
the card: the upload of a request's frames, the executor call and the
recording of its completion event, all run under the server lock.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.findings import Finding

__all__ = [
    "audit_ops",
    "audit_kernels",
    "audit_entry",
    "audit_session",
    "audit_server",
    "QUANT_OPS",
    "HOST_READ_OPS",
    "MATMUL_OPS",
]

# The quantise round-trip's fingerprint: ``core.quant`` rounds with
# ``torch.round`` and nothing else in the datapath does (clipping is
# ``clamp``, casts are ``_to_copy``).
QUANT_OPS = frozenset({"aten.round"})

# Ops that read a device value back to the host.
HOST_READ_OPS = frozenset({"aten._local_scalar_dense"})

# The products of a convolution layer, in the plain paths.
MATMUL_OPS = frozenset({"aten.convolution", "aten.mm", "aten.bmm", "aten.addmm",
                        "aten.baddbmm", "aten.matmul"})

# Names of the Hopper kernels in the profiler's trace.
_KERNEL_NAMES = ("tilted_fusion_kernel", "conv3x3_kernel", "sr_epilogue_kernel")


def audit_ops(ops, *, precision: Optional[str] = None, where: str = "") -> List[Finding]:
    """Scan the aten ops of one call (``executor_artifacts(...)["ops"]``)."""
    findings: List[Finding] = []
    names = [o["op"] for o in ops]
    if any(n in QUANT_OPS for n in names):
        findings.append(Finding(
            checker="program",
            rule="quant_in_hot_path",
            severity="error",
            message=(
                "quantise rounding (aten.round) in the per-batch call — "
                "weight prep must happen once in prepare_stack, never "
                "inside the serving call"
            ),
            where=where,
        ))
    reads = sorted({o["op"] for o in ops if o["op"] in HOST_READ_OPS or o["to_host"]})
    if reads:
        findings.append(Finding(
            checker="program",
            rule="host_transfer",
            severity="error",
            message=(
                f"device-to-host reads in the serving call: {reads} — every "
                "dispatch would wait for the card and copy to the host"
            ),
            where=where,
        ))
    uploads = sorted({o["op"] for o in ops if o["from_host"]})
    if uploads:
        findings.append(Finding(
            checker="program",
            rule="host_callback",
            severity="error",
            message=(
                f"host-to-device copies made inside the serving call: {uploads} "
                "— torch synchronizes the stream after a pageable copy, so every "
                "dispatch would wait for the card"
            ),
            where=where,
        ))
    if precision == "bf16":
        first = next((i for i, n in enumerate(names) if n in MATMUL_OPS), None)
        if first is not None and not any("bfloat16" in o["dtypes"] for o in ops[first:]):
            findings.append(Finding(
                checker="program",
                rule="fp32_upcast",
                severity="warning",
                message=(
                    "bf16 plan, but no op from the first convolution on emits "
                    "bfloat16 — the feature maps silently stayed in fp32"
                ),
                where=where,
            ))
    return findings


def audit_kernels(kernels: dict, *, precision: Optional[str] = None,
                  where: str = "") -> List[Finding]:
    """Scan what the profiler recorded for one call on the card
    (``executor_artifacts(...)["kernels"]``)."""
    findings: List[Finding] = []
    to_host = sorted({m for m in kernels["memcpy"] if "DtoH" in m})
    if to_host:
        findings.append(Finding(
            checker="program",
            rule="host_transfer",
            severity="error",
            message=(
                f"device-to-host copies in the serving call: {to_host} — the "
                "dispatch would stall on a copy to the host"
            ),
            where=where,
        ))
    if kernels["syncs"]:
        findings.append(Finding(
            checker="program",
            rule="host_callback",
            severity="error",
            message=(
                f"the serving call waits for the card: {sorted(set(kernels['syncs']))} "
                "— every dispatch would serialize with the host"
            ),
            where=where,
        ))
    if precision == "bf16":
        ours = [k for k in kernels["kernels"] if any(n in k for n in _KERNEL_NAMES)]
        if ours and not any("bfloat16" in k for k in ours):
            findings.append(Finding(
                checker="program",
                rule="fp32_upcast",
                severity="warning",
                message=(
                    f"bf16 plan, but every Hopper kernel instance it launched is "
                    f"the fp32 one: {sorted(set(ours))}"
                ),
                where=where,
            ))
    return findings


def _entry_where(entry) -> str:
    p = entry.plan
    return (
        f"executor {p.backend}/{p.precision} {p.height}x{p.width} "
        f"bucket={entry.bucket} {entry.dtype}"
    )


def audit_entry(session, entry, *, compiled: bool = True) -> List[Finding]:
    """Audit ONE cached executor: the ops of one call, on the card what the
    profiler records for another call, the builds the call triggered, and
    whether it was built with the (no-op) ``donate_frames``."""
    import torch

    from repro_torch.engine.executor import executor_artifacts

    plan = entry.plan
    where = _entry_where(entry)
    rec = session._stacks.get(entry.stack_key)
    stack = rec.stack if rec is not None else None
    arts = executor_artifacts(
        plan, stack, entry.bucket, getattr(torch, entry.dtype),
        layers=session.layers, compiled=compiled,
    )
    findings = audit_ops(arts["ops"], precision=plan.precision, where=where)
    if arts["kernels"] is not None:
        findings.extend(audit_kernels(arts["kernels"], precision=plan.precision, where=where))
    if arts["builds"]:
        findings.append(Finding(
            checker="program",
            rule="hot_path_build",
            severity="error",
            message=(
                f"the serving call loaded kernel libraries {arts['builds']} "
                "((kernel, compiled by nvcc)) — the first request of this key "
                "would pay the build; the executor was not warmed"
            ),
            where=where,
        ))

    if entry.donates:
        findings.append(Finding(
            checker="program",
            rule="donation_ignored",
            severity="info",
            message=(
                "executor donates its frame batch, but eager PyTorch has no "
                "buffer donation — the slab is freed when its last reference "
                "goes (harmless)"
            ),
            where=where,
        ))
    return findings


def audit_session(session, *, compiled: bool = True) -> List[Finding]:
    """Audit EVERY executor the session's PlanCache currently holds, plus
    the per-key build counters (recompile detection)."""
    findings: List[Finding] = []
    for entry in session._cache.entries():
        findings.extend(audit_entry(session, entry, compiled=compiled))
    for key, count in session._compile_counts.items():
        if count > 1:
            plan, bucket, dtype = key[:3]
            findings.append(Finding(
                checker="program",
                rule="recompile",
                severity="warning",
                message=(
                    f"cache key built {count} times (evicted and re-missed) "
                    "— steady-state traffic paid a hidden rebuild and warm-up; "
                    "consider a larger cache_capacity"
                ),
                where=(
                    f"executor {plan.backend}/{plan.precision} "
                    f"{plan.height}x{plan.width} bucket={bucket} {dtype}"
                ),
            ))
    return findings


def audit_server(server, submit) -> List[Finding]:
    """Audit an :class:`~repro_torch.engine.server.SRServer`'s launch path
    on the card.  ``submit()`` queues a request on ``server`` (host frames,
    as a client sends them) and returns its future.  It runs once to warm
    the plan, executor and kernels, then once under ``torch.profiler``,
    which records every launch in the server's own ``sr.dispatch`` span.  A
    synchronizing runtime call inside a launch is ``host_callback``: the launch holds the
    server lock, so each dispatch would wait for the one before it and the
    session's ``pipeline_depth`` would buy nothing.  The completion's event
    wait runs outside the launch, with the lock released, and does not
    count.  On a mesh session every replica builds its own executor on its
    first dispatch, so the warm-up runs once per replica.  On the CPU
    nothing is asynchronous and nothing is found."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.executor import SYNC_CALLS

    replicas = max(s.mesh_spec.replicas if s.mesh_spec is not None else 1
                   for s in server._sessions.values())
    for _ in range(replicas):  # warm: plan, executor, kernel build
        submit().result()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        submit().result()
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "sr.dispatch" and e.device_type == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the profiler recorded no server launch")
    syncs = sorted({e.name for e in events
                    if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS
                    and any(lo <= e.time_range.start and e.time_range.end <= hi
                            for lo, hi in spans)})
    if not syncs:
        return []
    return [Finding(
        checker="program",
        rule="host_callback",
        severity="error",
        message=(
            f"the server's launch waits for the card: {syncs} — it holds the "
            "server lock, so every dispatch would wait for the one before it"
        ),
        where=f"server launch ({len(spans)} dispatches)",
    )]
