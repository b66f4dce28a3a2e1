"""The one general traffic generator: what a traffic file's parameters mean.

A traffic file (``bench/traffic/<name>.json``) holds parameters only:

* ``"kind": "closed"`` — ``clients`` threads, each submitting requests of
  ``frames_per_request`` consecutive frames of the input pool back to back,
  the next one when the last one's result is in (video-on-demand workers,
  a request a segment).

Requests draw their frames from a pool of ``pool_frames`` seeded LR frames.
``sample_requests`` is how many finished requests a run keeps for the
correctness check and ``sample_frames`` how many frames of each (all of
them where a request is shorter), ``warm_seconds`` how long set-up runs the
same traffic (other frames, same sizes) before the window, and
``warm_max_bucket`` the largest bucket whose executor set-up builds (every
power of two up to it: all the traffic can form).  Other keys (a source, a
note) are for the reader and are not read.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

KINDS = ("closed",)
NEEDED = ("clients", "frames_per_request", "pool_frames", "sample_requests", "sample_frames",
          "warm_max_bucket")

# separate seeded streams for the parts a seed decides
_WINDOW, _WARM = 0, 1


def check(tr: dict) -> None:
    if tr.get("kind") not in KINDS:
        raise ValueError(f"traffic {tr.get('name')!r}: kind must be one of {KINDS}")
    for key in NEEDED:
        if not isinstance(tr.get(key), int) or tr[key] <= 0:
            raise ValueError(f"traffic {tr.get('name')!r}: {key} must be a positive integer")
    if tr["frames_per_request"] > tr["pool_frames"]:
        raise ValueError(f"traffic {tr.get('name')!r}: a request is longer than the pool")


def frames_per_request(tr: dict) -> int:
    return int(tr["frames_per_request"])


def closed_starts(tr: dict, seed: int, client: int, pool_frames: int,
                  warm: bool = False) -> Iterator[int]:
    """Pool index of the first frame of each request ``client`` sends."""
    n = frames_per_request(tr)
    rng = np.random.default_rng([int(seed), _WARM if warm else _WINDOW, 1, int(client)])
    while True:
        yield int(rng.integers(0, pool_frames - n + 1))
