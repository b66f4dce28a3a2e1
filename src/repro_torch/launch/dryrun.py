"""The dry-run entry point — the port of ``repro.launch.dryrun``:

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

Resolves the shardings of every (arch x shape x mesh) cell on the
production meshes and traces its step on ``meta`` tensors
(``launch.dryrun_lib``).  It allocates nothing and never touches a card:
the meshes are made of CPU positions that only resolve the rules, and
every tensor is a ``meta`` tensor.  (The reference pins 512 placeholder
host devices with ``XLA_FLAGS`` before JAX starts; nothing here needs
that.)
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import LM_ARCH_IDS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun_lib import DEFAULT_OUT_DIR, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run: resolve the shardings of every (arch x shape x "
                    "mesh) cell and trace its step on meta tensors. Allocates nothing "
                    "and never touches a card (CPU mesh positions, meta tensors).")
    ap.add_argument("--arch", default="all",
                    help=f"arch id or 'all' ({', '.join(LM_ARCH_IDS)})")
    ap.add_argument("--shape", default="all",
                    help=f"shape or 'all' ({', '.join(SHAPES)})")
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT_DIR)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs + tiny shapes (CI smoke)")
    ap.add_argument("--force", action="store_true", help="ignore cached cells")
    args = ap.parse_args(argv)

    archs = LM_ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ("single_pod", "multi_pod") if args.mesh == "both" else (args.mesh,)

    results = run_all(archs=archs, shapes=shapes, meshes=meshes,
                      out_dir=args.out, reduced=args.reduced,
                      skip_existing=not args.force)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(results)} cells")
    for r in results:
        if r["status"] == "error":
            print(f"  ERROR {r['mesh']} {r['arch']} {r['shape']}: {r['error']}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
