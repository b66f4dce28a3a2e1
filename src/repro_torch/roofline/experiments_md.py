"""Write the port's §Dry-run and §Roofline tables from the dry-run records —
the port of ``repro.roofline.experiments_md``.

Run:  PYTHONPATH=src python -m repro_torch.roofline.experiments_md --out build/EXPERIMENTS_torch.md
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.roofline.report import (
    DEFAULT_CARD,
    dryrun_table,
    load_records,
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


def render(recs) -> str:
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    return "\n".join([
        HEADER, DRYRUN_INTRO, dryrun_table(recs), "\n",
        ROOFLINE_INTRO, roofline_table(recs), "\n",
        f"\nCells: {n_ok} ok, {n_skip} policy skips, "
        f"{len(recs) - n_ok - n_skip} errors out of {len(recs)}.\n",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the dry-run and roofline tables.")
    ap.add_argument("--out", required=True, help="the markdown file to write")
    ap.add_argument("--records", default=None, help="dry-run records (default build/dryrun)")
    args = ap.parse_args(argv)
    recs = load_records(args.records)
    with open(args.out, "w") as f:
        f.write(render(recs))
    n_ok = sum(r["status"] == "ok" for r in recs)
    print(f"wrote {args.out} ({n_ok} ok / {len(recs)} cells; peaks of {DEFAULT_CARD})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
