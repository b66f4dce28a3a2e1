"""Dry-run engine: resolve and trace every (arch x shape x mesh) cell — the
port of ``repro.launch.dryrun_lib``.

Proves the distribution config is coherent without hardware.  The
reference lowers and compiles each cell on 512 placeholder devices and
reads XLA's ``memory_analysis()``, ``cost_analysis()`` and its own HLO
parser.  PyTorch has no compiler to ask, so for each cell the port:

* builds the step's state, cache and batch as ``meta`` tensors (zero
  allocation: ``train_state_shapes``, ``param_shapes``,
  ``cache_axes_and_shapes``, ``configs.shapes.input_specs``) and resolves
  every sharding with ``make_shardings`` under the cell's rules on the
  production mesh (positions that resolve rules and hold nothing);
* sums the per-device argument bytes exactly from those shardings;
* traces the step (``make_train_step``, ``make_prefill_step``, or
  ``make_decode_step`` at ``pos = seq_len - 1``) on ``meta`` tensors at one
  device's batch through ``roofline.trace_cost``: its FLOPs, the bytes its
  operators move, its peak of live bytes;
* models the collective bytes (``roofline.analytic.analytic_collective_bytes``).

Two things a compiled HLO module would give are estimates here:

* **FLOPs per device** are the trace's FLOPs at one device's batch, scaled
  to the global batch, over the device count: every operator is taken to
  split evenly over the mesh.  Compute a mesh would replicate (heads that
  do not divide the ``model`` axis) is not seen.
* **Temporary bytes** are the trace's peak of live bytes at one device's
  batch, with nothing split over ``model``: an upper bound, since a
  tensor-parallel program holds a ``1/model`` slice of most activations.

**Depth.**  A layer stack repeats one block, and an eager trace pays for
every operator in Python (the flash loop of a 32k-token prefill runs 2,048
chunk pairs a layer: a full-depth trace of qwen2-0.5b's took minutes), so
a cell is traced at two depths one unit apart (a unit is a layer;
zamba2's period of Mamba layers with its shared block; one encoder plus
one decoder layer) and extrapolated along the line through them to the
full depth (:func:`traced_cost`).  FLOPs, operator bytes and the operator
count are exactly affine in the number of identical units.  The peak of
live bytes is too where the peak falls in the same phase at every depth
(dense, vlm, ssm and hybrid stacks; every serving step but encdec's);
for MoE and MLA training and encdec serving the shallowest trace peaks
elsewhere, and the extrapolated peak is an estimate.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.config import TrainConfig
from repro_torch.configs import LM_ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable
from repro_torch.distributed import partitioning as pt
from repro_torch.distributed.steps import (
    batch_axes,
    cache_axes_and_shapes,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    train_state_axes,
    train_state_shapes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.layers.params import param_axes, param_shapes, tree_leaves
from repro_torch.models.registry import get_model
from repro_torch.roofline.analytic import _mesh_sizes, _shards, analytic_collective_bytes
from repro_torch.roofline.trace_cost import trace_cost

__all__ = ["run_cell", "run_all", "pick_rules", "DEFAULT_OUT_DIR"]

DEFAULT_OUT_DIR = os.path.join("build", "dryrun")


def _train_tcfg(cfg) -> TrainConfig:
    # bf16 moments for the >=200B archs so state fits (DESIGN.md §6);
    # gradient accumulation halves per-microbatch activation memory.
    mdt = "bfloat16" if cfg.fsdp else "float32"
    mb = int(os.environ.get("REPRO_MICROBATCHES", "1"))  # §Perf: mb=1 minimises
    # FSDP weight-gather traffic (measured 1340 vs 2148 GB/step at mb=4)
    return TrainConfig(optimizer_dtype=mdt, microbatches=mb)


def pick_rules(cfg, shape_name: str):
    rules = dict(pt.BASE_RULES)
    # ZeRO-3 weight sharding pays a per-microbatch all-gather; it is only
    # warranted while optimizer state exists. Serve cells shard weights via
    # TP axes (expert/heads/head_dim/mlp) instead. (§Perf iteration 2)
    if SHAPES[shape_name].kind != "train":
        rules = pt.serve_rules(rules)
    if cfg.fsdp and SHAPES[shape_name].kind == "train":
        rules = pt.fsdp_rules(rules)
    if shape_name == "long_500k":
        rules = pt.long_context_rules(rules)
    return rules


def step_call(cfg, shape_name: str, batch: int, seq: int):
    """``(step, args, arg_axes)``: the step of the shape's kind and its
    arguments as ``meta`` tensors at ``batch`` x ``seq`` (a decode step's
    position is ``seq - 1``), with their logical axes (``None`` for the
    position)."""
    kind = SHAPES[shape_name].kind
    if kind == "train":
        tcfg = _train_tcfg(cfg)
        b = input_specs(cfg, shape_name, override_batch=batch, override_seq=seq)
        b_axes = {k: v for k, v in batch_axes(cfg, "train").items() if k in b}
        return (make_train_step(cfg, tcfg), (train_state_shapes(cfg, tcfg), b),
                (train_state_axes(cfg), b_axes))
    schema = get_model(cfg).schema(cfg)
    p, p_axes = param_shapes(schema, cfg.weight_dtype), param_axes(schema)
    c_axes, c = cache_axes_and_shapes(cfg, batch, seq)
    if kind == "prefill":
        b = input_specs(cfg, shape_name, override_batch=batch, override_seq=seq)
        b_axes = {k: v for k, v in batch_axes(cfg, "prefill").items() if k in b}
        return make_prefill_step(cfg), (p, b, c), (p_axes, b_axes, c_axes)
    tokens = input_specs(cfg, shape_name, override_batch=batch)["tokens"]
    return (make_decode_step(cfg), (p, tokens, c, seq - 1),
            (p_axes, batch_axes(cfg, "decode")["tokens"], c_axes, None))


def argument_bytes(args, arg_axes, mesh, rules) -> int:
    """Per-device bytes of a step's arguments under the shardings the
    rules resolve on ``mesh`` (each leaf's bytes over its shard count)."""
    sizes = dict(mesh.axis_sizes)
    total = 0
    for a, axes in zip(args, arg_axes):
        if axes is None:
            continue
        shardings = pt.make_shardings(axes, a, mesh, rules)
        for t, sh in zip(tree_leaves(a), tree_leaves(shardings)):
            total += t.numel() * t.element_size() // _shards(sh.spec, sizes)
    return total


def depth_units(cfg) -> int:
    """How many identical units of depth the config's stack repeats."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    if cfg.family == "encdec":
        return math.gcd(cfg.encoder_layers, cfg.num_layers)
    return cfg.num_layers - cfg.first_k_dense


def at_depth(cfg, units: int):
    """The config with ``units`` units of depth (see :func:`depth_units`)."""
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        return dataclasses.replace(cfg, num_layers=units * p + cfg.num_layers % p)
    if cfg.family == "encdec":
        g = math.gcd(cfg.encoder_layers, cfg.num_layers)
        return dataclasses.replace(cfg, encoder_layers=units * cfg.encoder_layers // g,
                                   num_layers=units * cfg.num_layers // g)
    return dataclasses.replace(cfg, num_layers=cfg.first_k_dense + units)


_TRACED = ("flops", "bytes_accessed", "op_count", "peak_live_bytes")


def traced_cost(cfg, shape_name: str, batch: int, seq: int, full_depth: bool = False):
    """The step's trace counts at the config's full depth: traced at ``k``
    and ``k + 1`` units of depth and extrapolated along the line through
    them (or traced whole with ``full_depth``, or where the stack is no
    deeper than that).  ``k`` is 1, or zamba2's number of shared blocks, so
    that every shared block is used (an unused one gets a zero gradient of
    its own).  Returns ``(counts, depths)``: ``counts`` has ``flops``,
    ``bytes_accessed``, ``op_count``, ``peak_live_bytes`` and
    ``flops_by_op``, and what the traces cost: ``traced_ops``, the
    operators they dispatched, and ``memo_hits``, those of them that
    :class:`~repro_torch.roofline.trace_cost.LiveBytesMode` answered without
    running a ``meta`` kernel."""
    n = depth_units(cfg)
    k = cfg.num_shared_blocks if cfg.family == "hybrid" else 1
    depths = (n,) if full_depth or n <= k + 1 else (k, k + 1)
    runs = []
    for u in depths:
        c = cfg if u == n else at_depth(cfg, u)
        step, args, _ = step_call(c, shape_name, batch, seq)
        runs.append(trace_cost(step, *args))
    spent = {"traced_ops": sum(r.op_count for r in runs),
             "memo_hits": sum(r.memo_hits for r in runs)}
    if len(runs) == 1:
        r = runs[0]
        counts = {key: getattr(r, key) for key in _TRACED}
        counts["flops_by_op"] = dict(r.flops_by_op)
        return {**counts, **spent}, list(depths)
    r1, r2 = runs

    def line(a, b):  # the value at n units on the line through units k and k + 1
        return a + (n - k) * (b - a)

    counts = {key: line(getattr(r1, key), getattr(r2, key)) for key in _TRACED}
    ops = set(r1.flops_by_op) | set(r2.flops_by_op)
    counts["flops_by_op"] = {op: line(r1.flops_by_op.get(op, 0), r2.flops_by_op.get(op, 0))
                             for op in sorted(ops)}
    return {**counts, **spent}, list(depths)


def record_config(rec: Dict[str, Any]):
    """The (full-width) config a record's cell ran, its depth cut included."""
    cfg = get_config(rec["arch"])
    return at_depth(cfg, rec["depth"]) if "depth" in rec else cfg


def _mesh_name(multi_pod: bool, mesh) -> str:
    name = "multi_pod" if multi_pod else "single_pod"
    if mesh is None or dict(mesh.axis_sizes) == _mesh_sizes(name):
        return name
    return ",".join(f"{a}={n}" for a, n in mesh.axis_sizes.items())


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    reduced: bool = False,
    mesh=None,
    compile_cell: bool = True,
    *,
    batch: Optional[int] = None,
    depth: Optional[int] = None,
) -> Dict[str, Any]:
    """Resolve and trace one cell; returns a JSON-serialisable record.

    ``mesh`` defaults to the production mesh on CPU positions (it only
    resolves rules: every tensor is ``meta``).  ``batch`` replaces the
    shape's global batch (the record's ``global_batch`` says so), and
    ``depth`` cuts the stack to that many units (:func:`at_depth`; the
    record's ``depth`` says so, and :func:`record_config` rebuilds the
    config).  ``compile_cell=False`` stops once the shardings
    resolve, with status ``"resolved"``: the reference's ``"lowered"`` names
    a stage (lowering to HLO) that the port does not have."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod, mesh),
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": batch or shape.global_batch,
    }
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if reduced:
        cfg = cfg.reduced()
    if depth is not None:
        rec["depth"] = depth
        cfg = at_depth(cfg, depth)

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                              devices=["cpu"])
    rec["devices"] = int(mesh.size)
    rec["mesh_sizes"] = dict(mesh.axis_sizes)
    rules = pick_rules(cfg, shape_name)
    seq = min(shape.seq_len, 128) if reduced else shape.seq_len
    bsz = min(shape.global_batch, 8) if reduced else shape.global_batch
    bsz = batch or bsz
    if shape.kind == "train":  # the FSDP gathers of analytic_collective_bytes
        rec["microbatches"] = _train_tcfg(cfg).microbatches

    try:
        with pt.axis_rules(mesh, rules):
            t0 = time.time()
            _, args, arg_axes = step_call(cfg, shape_name, bsz, seq)
            arg_bytes = argument_bytes(args, arg_axes, mesh, rules)
            if not compile_cell:
                rec["status"] = "resolved"
                return rec
            # one device's share of the batch: the data-parallel shards of
            # its 'batch' axis (a batch they do not divide is replicated)
            b_spec = pt.shape_aware_spec(("batch",), (bsz,), mesh, rules)
            b_dev = bsz // _shards(b_spec, rec["mesh_sizes"])
            counts, depths = traced_cost(cfg, shape_name, b_dev, seq)
            rec["trace_seconds"] = round(time.time() - t0, 2)
        scale = bsz // b_dev
        coll = analytic_collective_bytes(dict(rec, global_batch=bsz, seq_len=seq), cfg, rules,
                                         mesh_sizes=rec["mesh_sizes"])
        temp = counts["peak_live_bytes"]
        rec["memory"] = {
            "argument_bytes": arg_bytes,
            "temp_bytes": temp,
            "peak_estimate_bytes": arg_bytes + temp,
        }
        rec["counted"] = {
            "flops": counts["flops"] * scale / rec["devices"],
            "hbm_bytes": counts["bytes_accessed"] * scale / rec["devices"],
            "collective_bytes": sum(coll.values()),
            "collective_by_type": coll,
            "op_count": counts["op_count"],
            "flops_by_op": counts["flops_by_op"],
            "traced_batch": b_dev,
            "traced_depths": depths,
            "traced_ops": counts["traced_ops"],
            "memo_hits": counts["memo_hits"],
        }
        rec["status"] = "ok"
    except Exception as e:  # record failures as data, not crashes
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def _cell_job(job) -> Dict[str, Any]:
    arch, shape_name, multi, reduced = job
    return run_cell(arch, shape_name, multi_pod=multi, reduced=reduced)


def _done(rec, path) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = f" trace={rec['trace_seconds']}s"
    elif status == "error":
        extra = " " + rec["error"][:120]
    print(f"[done]   {rec['mesh']} {rec['arch']} {rec['shape']}: {status}{extra}", flush=True)


def run_all(
    archs=None,
    shapes=None,
    meshes=("single_pod", "multi_pod"),
    out_dir: str = DEFAULT_OUT_DIR,
    reduced: bool = False,
    skip_existing: bool = True,
) -> list:
    """Every (mesh x arch x shape) cell, each record cached as
    ``<out_dir>/<mesh>__<arch>__<shape>.json`` (an ``ok`` or ``skipped``
    record is reused unless ``skip_existing`` is False).  The cells left to
    trace run in one process each, as many at a time as this process may
    use CPUs."""
    archs = archs or LM_ARCH_IDS
    shapes = shapes or list(SHAPES)
    os.makedirs(out_dir, exist_ok=True)
    results, todo = {}, []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                key = (mesh_name, arch, shape_name)
                path = os.path.join(out_dir, f"{mesh_name}__{arch}__{shape_name}.json")
                if skip_existing and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("ok", "skipped"):
                        results[key] = rec
                        print(f"[cached] {mesh_name} {arch} {shape_name}: {rec['status']}")
                        continue
                todo.append((key, path))
    jobs = [(arch, shape_name, mesh_name == "multi_pod", reduced)
            for (mesh_name, arch, shape_name), _ in todo]
    if len(todo) == 1:
        (key, path), job = todo[0], jobs[0]
        results[key] = _cell_job(job)
        _done(results[key], path)
    elif todo:
        workers = min(len(todo), len(os.sched_getaffinity(0)))
        ctx = multiprocessing.get_context("spawn")
        # a prefill cell's flash loop takes longest to trace: start those first
        order = sorted(range(len(todo)), key=lambda i: SHAPES[jobs[i][1]].kind != "prefill")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            futures = {pool.submit(_cell_job, jobs[i]): todo[i] for i in order}
            for fut in concurrent.futures.as_completed(futures):
                key, path = futures[fut]
                results[key] = fut.result()
                _done(results[key], path)
    return [results[k] for k in sorted(results, key=lambda k: (meshes.index(k[0]),
                                                              archs.index(k[1]),
                                                              shapes.index(k[2])))]
