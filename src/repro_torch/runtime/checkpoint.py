"""Atomic, async checkpointing with retention — the port of
``repro.runtime.checkpoint``, on nested dicts of tensors.

Layout (one directory per step), the reference's::

    <dir>/step_000000120/
        manifest.json      {step, keys, fingerprint, complete: true}
        arrays.npz         one entry per leaf

A leaf's key is the reference's: its ``jax.tree_util`` key path, each dict
key written ``['name']`` and joined by ``/`` (``['params']/['blocks']/
['attn']/['wq']``).  Dict keys are walked in sorted order on both sides, so
a checkpoint written by the JAX package restores into the port's tree of
the same structure, and the other way round.  bfloat16 leaves are written
as float32 (numpy has no bfloat16; the widening is exact), and
:func:`restore` casts every leaf to the reference state's dtype.

Guarantees:
  * atomicity — written to ``<dir>/.tmp_<step>`` then ``os.replace``d; a
    crash mid-write never corrupts the latest checkpoint (the restart loop
    in ``runtime.resilience`` relies on this);
  * async — ``save(..., blocking=False)`` copies the state to host memory
    before it returns (so the next in-place step cannot change what is
    written) and writes on a worker thread;
  * retention — the ``keep`` newest checkpoints survive;
  * fingerprint — a hash of ``repr(cfg)``, checked on restore.  The port's
    configs are field-for-field copies of the reference's, so a config has
    the same fingerprint in both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.layers.params import tree_leaves_with_path, tree_unflatten

__all__ = ["save", "restore", "latest_step", "fingerprint", "wait_pending", "leaf_key"]

_PENDING: list = []


def fingerprint(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def leaf_key(path) -> str:
    """A leaf's key in ``arrays.npz``: ``jax.tree_util``'s key strings of
    its path, joined by ``/``."""
    return "/".join(f"[{k!r}]" for k in path)


def _host_array(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a copy even of a CPU tensor: the state may be
    updated in place while a threaded write is still reading it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {leaf_key(path): _host_array(leaf) for path, leaf in tree_leaves_with_path(tree)}


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            manifest = os.path.join(ckpt_dir, name, "manifest.json")
            try:
                with open(manifest) as f:
                    if json.load(f).get("complete"):
                        steps.append(int(name[5:]))
            except (OSError, ValueError, json.JSONDecodeError):
                continue
    return max(steps) if steps else None


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray], fp: str, keep: int):
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat), "fingerprint": fp, "complete": True}, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # retention
    done = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_"))
    for name in done[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def save(ckpt_dir: str, step: int, state, cfg=None, keep: int = 3,
         blocking: bool = True) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)  # synchronous host snapshot
    fp = fingerprint(cfg) if cfg is not None else ""
    if blocking:
        _write(ckpt_dir, step, flat, fp, keep)
        return
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, fp, keep), daemon=True)
    t.start()
    _PENDING.append(t)


def wait_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def restore(ckpt_dir: str, reference_state, cfg=None,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``reference_state``: a new tree whose
    every leaf lies on the reference leaf's device, in its dtype."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if cfg is not None and manifest["fingerprint"] not in ("", fingerprint(cfg)):
        raise ValueError(
            f"checkpoint fingerprint {manifest['fingerprint']} does not match "
            f"config {fingerprint(cfg)} — wrong architecture?"
        )
    paths, refs = zip(*tree_leaves_with_path(reference_state))
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for path_keys, ref in zip(paths, refs):
            key = leaf_key(path_keys)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            leaves.append(torch.from_numpy(np.array(data[key])).to(device=ref.device,
                                                                   dtype=ref.dtype))
    return step, tree_unflatten(paths, leaves)
