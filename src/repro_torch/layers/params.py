"""Declarative parameter schemas (the port of ``repro.layers.params``).

Models describe parameters once — shape, *logical* sharding axes, and
initialiser — as a nested dict of :class:`ParamSpec`.  From that single
schema we derive:

* ``init_params``     — materialised tensors, drawn from a ``torch.Generator``
* ``param_shapes``    — shapes and dtypes without storage (``meta`` tensors,
                        the reference's ``ShapeDtypeStruct`` tree)
* ``param_axes``      — the logical-axis tree (same structure as the params)
* ``count_params``    — the parameter count of a schema

``params_from_numpy`` carries a parameter or cache tree made elsewhere (the
JAX package's, as numpy arrays) into the port, so both compute on the same
weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import torch_dtype

__all__ = [
    "ParamSpec",
    "init_params",
    "param_shapes",
    "param_axes",
    "count_params",
    "stack_schema",
    "params_from_numpy",
    "tree_map",
    "tree_leaves",
    "tree_leaves_with_path",
    "tree_unflatten",
]

Schema = Dict[str, Any]  # nested dict of ParamSpec


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None  # overrides the default fan-in scale
    dtype: Optional[str] = None  # overrides the model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def initializer(self, generator: torch.Generator, dtype, device) -> torch.Tensor:
        """One tensor on ``device``; normals are drawn from ``generator``,
        which must live on ``device`` (fp32 draws, then cast)."""
        dtype = torch_dtype(self.dtype) if self.dtype else torch_dtype(dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "embed":
            scale = self.scale if self.scale is not None else 1.0
        elif self.init == "normal":
            # fan-in scaled: contract dims = all but the last, excluding
            # stacking dims ('layers' for the layer loop, 'expert' for MoE)
            # which are batch-like, not contracting.
            fan_in = 1
            for dim, ax in zip(self.shape[:-1], self.axes[:-1]):
                if ax not in ("layers", "expert"):
                    fan_in *= dim
            fan_in = fan_in or 1
            scale = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(f"unknown init {self.init!r}")
        out = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return out.mul_(scale).to(dtype)


def _is_leaf(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf: Callable = _is_leaf):
    """``fn`` over every leaf of a nested dict (keys in sorted order, as
    ``jax.tree_util`` walks them); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    return fn(tree)


def tree_leaves_with_path(tree, prefix: Tuple = ()):
    """``(path, leaf)`` for every leaf of a nested dict of tensors (any
    non-dict value is a leaf), keys in sorted order as ``jax.tree_util``
    walks them; ``path`` is the tuple of keys from the root."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, leaves) -> Dict:
    """The nested dict whose leaf at each ``path`` (a tuple of keys, as
    :func:`tree_leaves_with_path` gives) is the matching one of ``leaves``."""
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in :func:`tree_leaves_with_path` order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def init_params(schema: Schema, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cpu"):
    """Materialise a schema into tensors on ``device``, drawing the leaves
    in sorted-key order from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when None).  The numbers differ from the JAX
    package's ``jax.random`` draws: carry those across with
    :func:`params_from_numpy`."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return tree_map(lambda s: s.initializer(generator, dtype, device), schema)


def param_shapes(schema: Schema, dtype=torch.float32):
    """The schema's tensors on the ``meta`` device: shapes and dtypes (a
    leaf's own ``dtype`` over ``dtype``), no storage allocated."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype or dtype),
                                          device="meta"), schema)


def param_axes(schema: Schema):
    """Logical-axis tree (tuples), same structure as the params."""
    return tree_map(lambda s: s.axes, schema)


def count_params(schema: Schema) -> int:
    total = []
    tree_map(lambda s: total.append(math.prod(s.shape)), schema)
    return sum(total)


def stack_schema(schema: Schema, num: int, axis_name: str = "layers") -> Schema:
    """Prepend a stacking dim to every leaf (the layer loop indexes it)."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(num,) + s.shape, axes=(axis_name,) + s.axes),
        schema,
    )


def _tensor_from_array(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: numpy-readable, not torch-readable
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=torch_dtype(dtype) if dtype is not None else t.dtype)


def params_from_numpy(tree, device="cpu", dtype=None):
    """The port's tensor tree from a nested dict of array-valued leaves
    (anything ``np.asarray`` reads: numpy arrays, the JAX package's
    parameter and cache trees).  ``dtype`` None keeps each leaf's dtype
    (bfloat16 included); else every leaf is cast to it.  This is how
    weights made by another framework cross into the port without the port
    importing that framework — the LM counterpart of
    ``models.abpn.layers_from_numpy``."""
    return tree_map(lambda a: _tensor_from_array(a, device, dtype), tree,
                    is_leaf=lambda x: not isinstance(x, dict))
