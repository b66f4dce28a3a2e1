"""Write the port's §Dry-run and §Roofline tables from the dry-run records —
the port of ``repro.roofline.experiments_md``.

Run:  PYTHONPATH=src python -m repro_torch.roofline.experiments_md --out build/EXPERIMENTS_torch.md

With ``--opt-records DIR`` it appends the reference's baseline-versus-
optimized section: the single-pod roofline of a second sweep beside the
first (:func:`compare_table`).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.roofline.report import (
    DEFAULT_CARD,
    _fmt_t,
    dryrun_table,
    load_records,
    roofline_row,
    roofline_table,
)

HEADER = """\
# Dry-run and roofline of the PyTorch port

Every LM (architecture x input shape x mesh) cell, resolved and traced by
the PyTorch port (`src/repro_torch`) on `meta` tensors: nothing is
allocated and no card is touched.  The tables regenerate with:

```
PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
PYTHONPATH=src python -m repro_torch.roofline.experiments_md --out build/EXPERIMENTS_torch.md
```

"""

DRYRUN_INTRO = """\
## §Dry-run

Every (architecture x input-shape) cell's shardings resolved on the
production meshes (single-pod `(data=16, model=16)` = 256 positions and
multi-pod `(pod=2, data=16, model=16)` = 512 positions, CPU positions that
resolve the rules and hold nothing), and its step traced on `meta`
tensors at one device's batch (`roofline/trace_cost.py`).
`decode_*`/`long_*` cells trace the decode step (a single new token
against a full-length cache); `long_500k` runs only for the sub-quadratic
archs (ssm/hybrid) and is recorded as SKIP for the eight pure-attention
archs.

Columns: trace wall time on the host; peak memory per device = the
arguments' bytes, exact from the shardings, + the trace's peak of live
bytes at one device's batch (an upper bound: nothing is split over
`model`); `fits` against the card's memory; per-device FLOPs counted by
`FlopCounterMode` (the global count over the device count: replicated
compute is not seen); collective bytes from the analytic model
(`roofline/analytic.py`; the port has no HLO to read them from).

"""

ROOFLINE_INTRO = """\
## §Roofline

Per (arch x shape) on the single-pod mesh (256 positions), per device,
against the card's published peaks:

    compute    = counted FLOPs / the peak FLOP/s of the step's dtype
    memory     = HBM bytes / the device-memory rate  (analytic model*)
    collective = collective bytes / the NVLink rate each way

*The HBM bytes use the analytic traffic model (`roofline/analytic.py`:
weights/optimizer/cache/carries per step, each divided by its true shard
count), because the eager trace's operator bytes count every unfused
up-cast and elementwise pass; that upper bound stays in the records.

`MODEL/counted flops` = 6·N_active·D (train) or 2·N_active·D (serve)
divided by the counted per-device FLOPs — the useful-work fraction; it
exposes remat recompute, the flash loop's fully masked causal chunks and
MoE dispatch overhead. `roofline frac` = useful-model-time /
dominant-term-time.

"""


def _counts(recs) -> tuple:
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    return n_ok, n_skip, len(recs) - n_ok - n_skip


def compare_table(base, opt, peaks=None) -> str:
    """Baseline vs optimized roofline terms per single-pod cell that both
    sweeps have ``ok``, under ``peaks`` (``report.roofline_row``'s
    default: the H100's): the dominant term and its time in each, each
    roofline fraction, and the speed-up of the dominant time."""
    def rows_by_key(recs):
        out = {}
        for r in recs:
            if r.get("mesh") != "single_pod":
                continue
            row = roofline_row(r, peaks)
            if row:
                out[(r["arch"], r["shape"])] = row
        return out

    b, o = rows_by_key(base), rows_by_key(opt)
    lines = [
        "| arch | shape | dominant (base→opt) | t_dominant base | t_dominant opt"
        " | roofline frac base | opt | Δ |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(set(b) & set(o)):
        rb, ro = b[key], o[key]
        tb = max(rb["t_compute_s"], rb["t_memory_s"], rb["t_collective_s"])
        to = max(ro["t_compute_s"], ro["t_memory_s"], ro["t_collective_s"])
        speedup = tb / to if to else float("inf")
        lines.append(
            f"| {key[0]} | {key[1]} | {rb['dominant']}→{ro['dominant']} | "
            f"{_fmt_t(tb)} | {_fmt_t(to)} | {rb['roofline_fraction']:.3f} | "
            f"{ro['roofline_fraction']:.3f} | ×{speedup:.2f} faster |"
        )
    return "\n".join(lines)


def render(recs, opt=None) -> str:
    """The markdown of the records ``recs``; with ``opt`` (a second sweep's
    records, non-empty) the baseline-vs-optimized section as well."""
    n_ok, n_skip, n_err = _counts(recs)
    parts = [
        HEADER, DRYRUN_INTRO, dryrun_table(recs), "\n",
        ROOFLINE_INTRO, roofline_table(recs), "\n",
        f"\nCells: {n_ok} ok, {n_skip} policy skips, {n_err} errors out of {len(recs)}.\n",
    ]
    if opt:
        o_ok, o_skip, o_err = _counts(opt)
        parts += ["### Optimized vs baseline — single pod\n", compare_table(recs, opt),
                  f"\nOptimized cells: {o_ok} ok, {o_skip} skips, {o_err} errors out of "
                  f"{len(opt)}.\n"]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the dry-run and roofline tables.")
    ap.add_argument("--out", required=True, help="the markdown file to write")
    ap.add_argument("--records", default=None, help="dry-run records (default build/dryrun)")
    ap.add_argument("--opt-records", default=None,
                    help="a second sweep's records, compared with the first (default none)")
    args = ap.parse_args(argv)
    recs = load_records(args.records)
    opt = load_records(args.opt_records) if args.opt_records else []
    with open(args.out, "w") as f:
        f.write(render(recs, opt))
    print(f"wrote {args.out} ({_counts(recs)[0]} ok / {len(recs)} cells; {len(opt)} optimized; "
          f"peaks of {DEFAULT_CARD})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
