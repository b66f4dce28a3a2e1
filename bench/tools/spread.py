#!/usr/bin/env python3
"""Medians and spreads of end-to-end metrics over sets of runs, as a bound
is set from them.

    python3 bench/tools/spread.py SET1_RECORDS... -- SET2_RECORDS...

Each argument is a record ``bench/run.py --record`` wrote; ``--`` separates
the two sets (run with the same seeds).  For each metric and set it prints
the values, the median and the spread (interquartile distance over the
median, ``statistics.quantiles`` as ``harness.stats.spread``), then the
wider of the two sets' spreads and five times it, the bound it suggests
(never under 1 %).  The first record of each set is left out of
``setup_s``: a checkout's first run builds the kernels.
"""

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import stats  # noqa: E402


def load(paths):
    return [json.loads(Path(p).read_text())["result"] for p in paths]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    cut = argv.index("--")
    sets = [load(argv[:cut]), load(argv[cut + 1:])]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        widest = 0.0
        for i, runs in enumerate(sets, 1):
            vals = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if name == "setup_s":
                vals = vals[1:]
            if len(vals) < 2:
                continue
            sp = stats.spread(vals)
            widest = max(widest, sp)
            print(f"{name} set {i}: median {statistics.median(vals)!r} spread {sp:.5f} "
                  f"values {vals}")
        print(f"{name}: widest spread {widest:.5f}, five times it {max(5 * widest, 0.01):.4f}")
    print("correct:", [r["correct"] for s in sets for r in s])
    return 0


if __name__ == "__main__":
    sys.exit(main())
