#!/usr/bin/env python3
"""One LM cell of the dry-run on one CUDA card, beside its roofline bound.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 tools/roofline_cell.py --arch qwen2-0.5b --shape prefill_32k --batch 1

This is ``chip_smoke.py``'s phase 4j for a single cell, at any batch and
depth (``--layers``, default the config's full depth).  The dry-run's
record on a ``(1, 1)`` mesh gives the ``meta`` trace's FLOPs (traced at two
depths and extrapolated), the predicted argument bytes and peak, and the
bound from ``roofline.report.roofline_row`` at the card's published peaks.
Then the step runs on the card with random weights from seed 0: once under
``roofline.trace_cost`` (the card's FLOPs, which must equal the ``meta``
trace's) and then timed with CUDA events (the median of ``--reps``).  It
holds the same checks as the phase (FLOPs equal, argument bytes equal,
measured peak at least the argument bytes, bound / measured <= 1.05) and
prints the card's name and power limit, one line for the cell and one JSON
line.

Exits 2 without a CUDA device, 1 when a check fails.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--batch", type=int, default=1, help="global batch (default 1)")
    ap.add_argument("--layers", type=int, default=None,
                    help="units of depth (default the config's full depth)")
    ap.add_argument("--reps", type=int, default=3, help="timed steps after the traced one")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("roofline_cell: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, peaks = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    chip_smoke.ROOFLINE_REPS = args.reps
    depth = "full depth" if args.layers is None else f"{args.layers} units of depth"
    try:
        out = chip_smoke.roofline_cell(torch, torch.device("cuda"), smi, peaks, args.arch,
                                       args.shape, args.batch, args.layers,
                                       f"batch {args.batch}, {depth}")
    except RuntimeError as e:
        print(f"roofline_cell: {e}", file=sys.stderr)
        return 1
    print(f"roofline_cell: {json.dumps(out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
