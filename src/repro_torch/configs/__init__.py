"""Architecture config registry (``--arch <id>``), a copy of the JAX
package's ``repro.configs``.

The ten LM-family architectures plus the paper's own ABPN model.
``get_config(name)`` returns the full published configuration;
``get_config(name).reduced()`` is the CPU smoke-test variant.  The
dry-run's four assigned input shapes are in ``configs/shapes.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

__all__ = ["ARCH_IDS", "LM_ARCH_IDS", "get_config"]

# arch id -> module name
_REGISTRY: Dict[str, str] = {
    "arctic-480b": "arctic_480b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-1.7b": "qwen3_1_7b",
    "internvl2-1b": "internvl2_1b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-130m": "mamba2_130m",
    "abpn-x3": "abpn_x3",
}

ARCH_IDS: List[str] = list(_REGISTRY)
LM_ARCH_IDS: List[str] = [a for a in ARCH_IDS if a != "abpn-x3"]


def get_config(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG
