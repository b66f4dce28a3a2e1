"""The benchmark's own inputs that every model family shares, made from
``--seed``: the LR frame pool the traffic draws from.  Frames are float32
in ``[0, 1)``, drawn on the host with numpy, as a client hands them to the
server.  A family's weights are its own (``bench/families/<family>.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def lr_shape(cfg: dict) -> Tuple[int, int, int]:
    return int(cfg["lr_height"]), int(cfg["lr_width"]), int(cfg["in_channels"])


def make_pool(cfg: dict, pool_frames: int, seed: int) -> np.ndarray:
    """``(pool_frames, H, W, C)`` float32 LR frames in ``[0, 1)``."""
    rng = np.random.default_rng([int(seed), 7])
    return rng.random((int(pool_frames), *lr_shape(cfg)), dtype=np.float32)
