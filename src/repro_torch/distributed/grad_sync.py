"""Data-parallel gradient synchronisation with int8 error-feedback
compression — the port of ``repro.distributed.grad_sync``.

Each position of the mesh's data axis holds its local gradient.  The
compressed all-reduce:

  1. adds the carried error-feedback residual to the local gradient,
  2. agrees on a shared scale through the maximum of the positions' max-abs
     values (one scalar per leaf),
  3. quantises to int8 and sums the int8 payloads as int32,
  4. dequantises the mean and keeps the local quantisation error as the
     position's next residual.

How it runs.  The reference runs this inside ``shard_map`` with ``psum`` /
``pmax`` over the data axis.  The port's mesh is one process
(``launch.mesh``), so the collectives are sums and maxima over the
per-position tensors, taken on the first position's device: each position
computes on its own stream (forked from the caller's), the first
position's stream joins the others before it reduces, and every tensor
that crosses streams is recorded on the stream that reads it, as
``engine.sharding.shard_exec`` does.  The caller's stream joins every
position's before the result is returned.  The quantisation is the
reference's op for op (``round`` half to even, clip to +-127, the int8
payload summed as int32, ``scale / n``), so on the CPU the mean equals the
JAX package's to the bit.  The residual ``gf - q * scale`` may differ in
its last bits: XLA's CPU backend fuses it into one multiply-add (one
rounding), where the port rounds the product and the difference apart.

Error feedback is per position.  The reference returns its residuals with
a replicated ``out_specs`` and ``check_rep=False``: each device keeps its
own residual buffer, which the next call reads back in place.  The port
makes that explicit: the residual state is one tree per data position, and
a single tree (``init_ef_state``) is given to every position.

``TrainConfig.grad_compression`` is not wired into ``make_train_step``, as
in the reference: ``make_dp_grad_fn`` is the entry point.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from repro_torch.layers.params import tree_leaves_with_path, tree_map, tree_unflatten

__all__ = ["int8_ef_allreduce", "make_dp_grad_fn", "init_ef_state", "data_positions"]


def _is_tensor(x) -> bool:
    return not isinstance(x, dict)


def init_ef_state(params):
    """Zero fp32 residuals shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params, is_leaf=_is_tensor)


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _join(home_stream, streams, tensors_per_position):
    """``home_stream`` waits for every position's stream; each tensor a
    position made on its own stream of the home device is recorded on
    ``home_stream``, which reads it next."""
    if home_stream is None:
        return
    for st, tensors in zip(streams, tensors_per_position):
        if st is None or st is home_stream:
            continue
        home_stream.wait_stream(st)
        for t in tensors:
            if t.device == home_stream.device:
                t.record_stream(home_stream)


def _hand_back(caller, streams, trees) -> None:
    """The caller's stream waits for every position's stream, and each
    tensor of ``trees`` made on one of them is recorded on the caller's
    stream, which reads it next."""
    if caller is None:
        return
    for st in streams:
        caller.wait_stream(st)
    for tree in trees:
        for _, t in tree_leaves_with_path(tree):
            if t.device == caller.device:
                t.record_stream(caller)


def _to(t: torch.Tensor, device: torch.device, stream) -> torch.Tensor:
    """``t`` on ``device``; the copy (if any) runs on the current stream,
    and a same-device tensor read on ``stream`` is recorded there."""
    if t.device != device:
        return t.to(device, non_blocking=True)
    if stream is not None:
        t.record_stream(stream)
    return t


def int8_ef_allreduce(grads: Sequence, ef: Sequence, streams: Optional[Sequence] = None):
    """Per-leaf int8 error-feedback mean-all-reduce over the positions of a
    data axis.

    ``grads`` and ``ef`` hold one tree per position (on that position's
    device); ``streams`` the positions' CUDA streams (None: each runs on
    the current stream, as on the CPU).  Returns ``(mean, new_ef)``: the
    dequantised mean tree in the gradients' dtypes on the first position's
    device, and one residual tree per position.
    """
    n = len(grads)
    streams = list(streams) if streams is not None else [None] * n
    home = streams[0]
    paths = [p for p, _ in tree_leaves_with_path(grads[0])]
    flat_g = [[g for _, g in tree_leaves_with_path(t)] for t in grads]
    flat_e = [[e for _, e in tree_leaves_with_path(t)] for t in ef]
    home_dev = flat_g[0][0].device

    caller = torch.cuda.current_stream(home.device) if home is not None else None
    gf, amax = [], []
    for i in range(n):
        if streams[i] is not None:
            streams[i].wait_stream(caller)
        with _on(streams[i]):
            gf.append([g.float() + e for g, e in zip(flat_g[i], flat_e[i])])
            amax.append(torch.stack([x.abs().amax() for x in gf[i]]))
    _join(home, streams, [[a] for a in amax])
    with _on(home):
        amax_home = [_to(a, home_dev, None) for a in amax]
        scale = torch.clamp_min(torch.stack(amax_home).amax(0), 1e-12) / 127.0

    q, new_e = [], []
    for i in range(n):
        st = streams[i]
        if st is not None and st is not home:
            st.wait_stream(home)
        with _on(st):
            s = _to(scale, flat_g[i][0].device, st if st is not home else None)
            qi, ei = [], []
            for j, x in enumerate(gf[i]):
                qj = torch.clamp(torch.round(x / s[j]), -127, 127).to(torch.int8)
                ei.append(x - qj.float() * s[j])
                qi.append(qj)
            q.append(qi)
            new_e.append(tree_unflatten(paths, ei))
    _join(home, streams, q)
    with _on(home):
        out = []
        for j, g in enumerate(flat_g[0]):
            total = _to(q[0][j], home_dev, None).to(torch.int32)
            for i in range(1, n):
                total = total + _to(q[i][j], home_dev, None).to(torch.int32)
            out.append((total.float() * (scale[j] / n)).to(g.dtype))
    out = tree_unflatten(paths, out)
    _hand_back(caller, streams, [out, *new_e])
    return out, new_e


def data_positions(mesh, data_axis: str = "data") -> List[int]:
    """The flat positions of ``mesh`` along ``data_axis`` (index 0 on every
    other axis), in order."""
    if data_axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {data_axis!r} axis")
    return [p for p in range(mesh.size)
            if all(v == 0 for k, v in mesh.coords(p).items() if k != data_axis)]


def make_dp_grad_fn(loss_fn, mesh, data_axis: str = "data", compression: str = "int8_ef"):
    """Build ``grads(params, batch, ef) -> (loss, grads, ef')`` with explicit
    data-parallel synchronisation over ``mesh``'s ``data_axis``.

    ``loss_fn(params, batch) -> scalar`` is evaluated per data position
    (params replicated, every batch entry split on dim 0), each on its own
    stream; gradients cross the data axis compressed (``"int8_ef"``) or raw
    (``"none"``: the mean).  ``ef`` is one residual tree for every position
    or a list with one per position; ``ef'`` is a list with one per
    position (``ef`` itself under ``"none"``).  ``loss`` and ``grads`` are
    on the first position's device.
    """
    if compression not in ("int8_ef", "none"):
        raise ValueError(compression)
    positions = data_positions(mesh, data_axis)
    devices = [mesh.devices[p] for p in positions]
    streams = [mesh.streams[p] for p in positions]
    n = len(positions)

    def local(params, batch, device):
        paths, leaves = zip(*tree_leaves_with_path(params))
        xs = [p.detach().to(device).requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(paths, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree_unflatten(paths, grads)

    def fn(params, batch, ef):
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch entry {k!r} of {v.shape[0]} rows does not split "
                                 f"over {n} data positions")
        home = streams[0]
        caller = torch.cuda.current_stream(devices[0]) if home is not None else None
        losses, grads = [], []
        for i in range(n):
            if streams[i] is not None:
                streams[i].wait_stream(caller)
            with _on(streams[i]):
                part = {k: v.chunk(n)[i].to(devices[i], non_blocking=True)
                        for k, v in batch.items()}
                loss, g = local(params, part, devices[i])
            losses.append(loss)
            grads.append(g)
        if compression == "int8_ef":
            efs = ef if isinstance(ef, (list, tuple)) else [ef] * n
            efs = [tree_map(lambda e, d=d: e.to(d), t, is_leaf=_is_tensor)
                   for t, d in zip(efs, devices)]
            out, ef = int8_ef_allreduce(grads, efs, streams)
        else:
            _join(home, streams, [[t for _, t in tree_leaves_with_path(g)] for g in grads])
            with _on(home):
                paths = [p for p, _ in tree_leaves_with_path(grads[0])]
                flat = [[_to(t, devices[0], None) for _, t in tree_leaves_with_path(g)]
                        for g in grads]
                out = tree_unflatten(paths, [sum(ts[1:], ts[0]) / n for ts in zip(*flat)])
        _join(home, streams, [[l] for l in losses])
        with _on(home):
            loss = torch.stack([_to(l, devices[0], None) for l in losses]).sum() / n
        _hand_back(caller, streams, [{"loss": loss}, out])
        return loss, out, ef

    return fn
