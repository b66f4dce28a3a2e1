"""§Roofline report from the dry-run records — the port of
``repro.roofline.report``.

Reads ``build/dryrun/*.json`` (``launch.dryrun``) and emits the tables:

  compute    = counted FLOPs / peak FLOP/s     (per device, the step's dtype)
  memory     = analytic bytes / memory rate    (per device)
  collective = collective bytes / link rate    (per device, NVLink each way)

The peaks are a card's published ones (:data:`PEAKS`, keyed by the name
``torch.cuda.get_device_name`` gives); :func:`roofline_row` takes them as
an argument.  The compute peak follows the step's dtype: bf16 on the
tensor cores, fp32 on the CUDA cores (the port keeps TF32 off).  The
collective term uses one card's NVLink rate, 450 GB/s each way to the
other cards of its host: for a 256-card mesh, which spans many hosts, that
is optimistic, and no figure is assumed here for links between hosts.
The roofline table is single-pod (256 positions); the multi-pod pass
appears in the dry-run table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.roofline.model_flops import model_flops

__all__ = ["PEAKS", "DEFAULT_CARD", "peaks_for", "load_records", "roofline_row",
           "dryrun_table", "roofline_table"]

# Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet and the
# Hopper white paper; dense, without sparsity): fp32 on the CUDA cores,
# TF32 and bf16 on the tensor cores in FLOP/s; device memory in bytes/s
# and its size in bytes; NVLink in bytes/s each way.  The rates assume the
# card's full 700 W power limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": dict(fp32=67e12, tf32=495e12, bf16=989e12, bytes=3.35e12,
                           memory=80e9, link_bytes=450e9),
}
DEFAULT_CARD = "H100 80GB HBM3"

_COMPUTE_PEAK = {"bfloat16": "bf16", "float32": "fp32"}


def peaks_for(name: str):
    """``(key, peaks)`` of the :data:`PEAKS` entry whose key ``name``
    contains; raises where the card has none recorded."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks recorded for {name!r}")


# one-sentence improvement notes keyed by (dominant term, predicate)
def _note(arch: str, shape: str, dom: str, ratio: float) -> str:
    cfg = get_config(arch)
    heads_div = cfg.num_heads and cfg.num_heads % 16 == 0
    if dom == "collective":
        if cfg.is_moe:
            return ("MoE dispatch/combine dominates the wire; a sorted all-to-all "
                    "(dropless) dispatch would cut collective bytes several-fold.")
        return ("gradient/activation all-reduces dominate; int8-EF gradient "
                "compression (distributed.grad_sync), overlapping them with the "
                "backward, or wider microbatching amortises them.")
    if dom == "memory":
        if shape.startswith("decode") or shape.startswith("long"):
            return ("decode is KV/state-cache bandwidth bound (as expected at batch "
                    "1-128); reading the bf16 cache without an fp32 copy of it, a "
                    "quantised (fp8/int8) cache or more model-axis cache sharding "
                    "moves it down.")
        return ("memory-bound: fuse the fp32 up-casts and elementwise passes and "
                "raise the arithmetic intensity per pass (a larger microbatch per "
                "card).")
    # compute
    if not heads_div and cfg.uses_attention and cfg.attention != "mla":
        return (f"compute-bound with {cfg.num_heads} q-heads not divisible by the "
                "16-way model axis -> attention runs replicated across it (the "
                "trace cannot see it); padding heads to a multiple of 16 removes "
                "the replicated FLOPs.")
    if ratio < 0.5:
        return ("compute-bound with low useful-FLOP ratio: remat recompute + the "
                "flash loop's fully masked causal chunks; skipping them and a "
                "lighter remat policy raise the ratio.")
    return ("compute-bound near the useful-FLOP budget; next wins are tensor-core "
            "tiles (bf16 products, dims padded to multiples of 64) and "
            "collectives overlapped with compute.")


def load_records(out_dir: Optional[str] = None) -> List[Dict]:
    if out_dir is None:
        from repro_torch.launch.dryrun_lib import DEFAULT_OUT_DIR

        out_dir = DEFAULT_OUT_DIR
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_row(rec: Dict, peaks: Optional[Dict[str, float]] = None) -> Optional[Dict]:
    """One cell's roofline terms against ``peaks`` (default the
    :data:`DEFAULT_CARD`'s; a dict with ``bf16`` and ``fp32`` FLOP/s,
    ``bytes`` and ``link_bytes`` in bytes/s, optionally ``memory`` in
    bytes for ``fits``).  None for a record that is not ``ok``."""
    if rec.get("status") != "ok":
        return None
    from repro_torch.launch.dryrun_lib import pick_rules, record_config
    from repro_torch.roofline.analytic import analytic_hbm_bytes

    peaks = peaks if peaks is not None else PEAKS[DEFAULT_CARD]
    counted = rec["counted"]
    devices = rec["devices"]
    cfg = record_config(rec)
    peak_flops = peaks[_COMPUTE_PEAK[cfg.dtype]]
    t_compute = counted["flops"] / peak_flops
    # the eager trace materialises every up-cast and elementwise output
    # that a fused program keeps on chip; report its bytes as an upper
    # bound but judge the bottleneck on the analytic traffic model.
    hbm_analytic = analytic_hbm_bytes(rec, cfg, pick_rules(cfg, rec["shape"]),
                                      mesh_sizes=rec.get("mesh_sizes"))
    t_memory = hbm_analytic / peaks["bytes"]
    t_memory_upper = counted["hbm_bytes"] / peaks["bytes"]
    t_coll = counted["collective_bytes"] / peaks["link_bytes"]
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf_global = model_flops(cfg, rec["kind"], rec["global_batch"], rec["seq_len"])
    mf_dev = mf_global / devices
    ratio = mf_dev / counted["flops"] if counted["flops"] else 0.0
    bound = max(terms.values())
    # roofline fraction: useful model time over the bound the card actually hits
    frac = (mf_dev / peak_flops) / bound if bound else 0.0
    fits = None
    if "memory" in peaks and "memory" in rec:
        fits = rec["memory"]["peak_estimate_bytes"] <= peaks["memory"]
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "kind")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_upper_s": t_memory_upper,
        "t_collective_s": t_coll,
        "dominant": dom,
        "model_flops_per_dev": mf_dev,
        "counted_flops_per_dev": counted["flops"],
        "useful_ratio": ratio,
        "roofline_fraction": frac,
        "fits": fits,
        "note": _note(rec["arch"], rec["shape"], dom, ratio),
    }


def _fmt_bytes(b: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if b >= div:
            return f"{b / div:.2f} {unit}"
    return f"{b:.0f} B"


def _fmt_t(t: float) -> str:
    if t >= 1:
        return f"{t:.2f} s"
    if t >= 1e-3:
        return f"{t * 1e3:.2f} ms"
    return f"{t * 1e6:.1f} us"


def dryrun_table(recs: List[Dict], peaks: Optional[Dict[str, float]] = None) -> str:
    """One line a record; ``fits`` is :func:`roofline_row`'s under ``peaks``."""
    fits = {True: "yes", False: "no", None: "-"}
    lines = [
        "| mesh | arch | shape | status | trace | peak mem/dev | fits | "
        "counted flops/dev | coll bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "ok":
            mem = _fmt_bytes(r["memory"]["peak_estimate_bytes"])
            lines.append(
                f"| {r['mesh']} | {r['arch']} | {r['shape']} | ok | "
                f"{r['trace_seconds']}s | {mem} | {fits[roofline_row(r, peaks)['fits']]} | "
                f"{r['counted']['flops']:.3g} | "
                f"{_fmt_bytes(r['counted']['collective_bytes'])} |"
            )
        elif r["status"] == "skipped":
            lines.append(
                f"| {r['mesh']} | {r['arch']} | {r['shape']} | SKIP | - | - | - | - | - |"
            )
        else:
            lines.append(
                f"| {r['mesh']} | {r['arch']} | {r['shape']} | ERROR | - | - | - |"
                f" - | {r.get('error', '')[:60]} |"
            )
    return "\n".join(lines)


def roofline_table(recs: List[Dict], mesh: str = "single_pod",
                   peaks: Optional[Dict[str, float]] = None) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MODEL/counted flops | roofline frac | fits | what would move it |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        row = roofline_row(r, peaks)
        if row is None:
            continue
        fits = {True: "yes", False: "no", None: "-"}[row["fits"]]
        lines.append(
            f"| {row['arch']} | {row['shape']} | {_fmt_t(row['t_compute_s'])} | "
            f"{_fmt_t(row['t_memory_s'])} | {_fmt_t(row['t_collective_s'])} | "
            f"**{row['dominant']}** | {row['useful_ratio']:.3f} | "
            f"{row['roofline_fraction']:.3f} | {fits} | {row['note']} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Print the dry-run and roofline tables of the records in a "
                    f"directory, against the {DEFAULT_CARD}'s published peaks.")
    ap.add_argument("--records", default=None, help="dry-run records (default build/dryrun)")
    args = ap.parse_args(argv)
    recs = load_records(args.records)
    print(dryrun_table(recs))
    print()
    print(roofline_table(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
