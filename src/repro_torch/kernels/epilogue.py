"""ABPN's residual epilogue on an NVIDIA Hopper card: wrapper and plain
version.

The epilogue turns the conv stack's output features ``(N, H, W, C*s*s)``
and the LR input ``(N, H, W, C)`` into the HR frame ``(N, H*s, W*s, C)``:
the anchor (each LR channel repeated ``s*s`` times) added to the features,
the pixel shuffle (``models.abpn.depth_to_space``), an optional clip to
``[0, 1]`` and the cast to the requested dtype.  With ``anchor=False`` (a
model without an anchor, RLFN) the LR input is not read: shuffle, clip and
cast alone.  It replaces no TPU kernel:
the JAX package's epilogue is plain ``jnp``, fused by XLA.  The kernel
(``csrc/sr_epilogue.cu``) does it in one pass over the features, which it
reads through their strides (K1's output is a view with Chp channels a
pixel), so the HR frame is written once and nothing else is.

* :func:`sr_epilogue_call` — the wrapper.  A CUDA tensor launches the
  kernel (or raises on what it does not take); a CPU or ``meta`` tensor
  runs :func:`sr_epilogue_plain` (on ``meta`` a traced call counts its
  operators).  On the card autograd records the kernel with the plain
  chain's gradient (training through ``engine.run``), and an HR dtype the
  kernel does not write (an integer frame's) is its compute-dtype output
  cast, as the chain casts.  ``sr_epilogue_call.launches`` counts kernel
  launches.
* :func:`sr_epilogue_plain` — the plain PyTorch chain: anchor, add,
  shuffle, clamp, cast.  The kernel's output is bit for bit its output.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.abpn import depth_to_space, make_anchor

__all__ = [
    "COMPUTE_DTYPES",
    "OUT_DTYPES",
    "sr_epilogue_call",
    "sr_epilogue_plain",
]

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)  # features and LR input
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # the HR frames it writes
_COMPUTE_CODE = {dt: i for i, dt in enumerate(COMPUTE_DTYPES)}  # the launcher's codes
_OUT_CODE = {dt: i for i, dt in enumerate(OUT_DTYPES)}


def sr_epilogue_plain(feats: torch.Tensor, x: Optional[torch.Tensor], *, scale: int,
                      clip: bool, out_dtype, anchor: bool = True) -> torch.Tensor:
    """The plain version: ``feats + make_anchor(x, scale)`` (``feats``
    alone without ``anchor``), then ``depth_to_space``, then
    ``torch.clamp(0, 1)`` when ``clip``, then the cast to ``out_dtype``.
    Row-block local: LR row ``y`` gives HR rows ``[y*s, y*s+s)``."""
    out = feats + make_anchor(x, scale) if anchor else feats
    hr = depth_to_space(out, scale)
    if clip:
        hr = torch.clamp(hr, 0.0, 1.0)
    return hr.to(out_dtype)


def _check_args(feats, x, scale, anchor=True):
    s = int(scale)
    if s < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    if not anchor:
        if feats.ndim != 4 or feats.shape[3] % (s * s):
            raise ValueError(f"feats must be (N, H, W, C*s*s) at scale {s}, got shape "
                             f"{tuple(feats.shape)}")
        return
    if x is None or feats.ndim != 4 or x.ndim != 4:
        raise ValueError(f"feats and x must be (N, H, W, C), got shapes {tuple(feats.shape)} "
                         f"and {None if x is None else tuple(x.shape)}")
    if tuple(feats.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"feats {tuple(feats.shape)} and x {tuple(x.shape)} differ in (N, H, W)")
    if feats.shape[3] != x.shape[3] * s * s:
        raise ValueError(f"feats carry {feats.shape[3]} channels; x's {x.shape[3]} at scale {s} "
                         f"take {x.shape[3] * s * s}")


_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("sr_epilogue")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sr_epilogue_launch.argtypes = [ci, ci] + [vp] * 4 + [ci] * 7 + [vp]
        lib.sr_epilogue_launch.restype = ci
        lib.sr_epilogue_error_string.argtypes = [ci]
        lib.sr_epilogue_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _launch(feats, x, scale, clip, out_dtype, anchor=True):
    """``x`` is not read without ``anchor`` (pass ``feats``)."""
    if feats.dtype not in COMPUTE_DTYPES or x.dtype != feats.dtype:
        raise ValueError(f"the epilogue kernel takes float32 or bfloat16 feats and x of one "
                         f"dtype, got {feats.dtype} and {x.dtype}")
    if x.device != feats.device:
        raise ValueError(f"feats and x must be on one device, got {feats.device}, {x.device}")
    s = int(scale)
    N, H, W, CF = feats.shape
    C = CF // (s * s)
    out = torch.empty((N, H * s, W * s, C), dtype=out_dtype, device=feats.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 8)(*feats.stride(), *(x.stride() if anchor else (0,) * 4))
    lib = _lib()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.sr_epilogue_launch(
            _COMPUTE_CODE[feats.dtype], _OUT_CODE[out_dtype], feats.data_ptr(), x.data_ptr(),
            out.data_ptr(), ctypes.addressof(strides), N, H, W, C, s, int(bool(clip)),
            int(bool(anchor)), stream,
        )
    if err != 0:
        msg = lib.sr_epilogue_error_string(err).decode()
        raise RuntimeError(f"sr_epilogue kernel launch failed: CUDA error {err} ({msg})")
    sr_epilogue_call.launches += 1
    return out


def _chain_grads(feats, x, grad, scale, clip, anchor=True):
    """The plain chain's gradients for ``feats`` and ``x`` from the HR
    frame's ``grad``: the clip passes it where ``0 <= v <= 1``
    (``torch.clamp``'s rule, so not at a NaN), the inverse pixel shuffle
    takes it to the features, and each LR channel gets the sum over its
    ``s*s`` anchored copies (none without ``anchor``)."""
    s = scale
    g = grad.to(feats.dtype)
    if clip:
        v = depth_to_space(feats + make_anchor(x, s) if anchor else feats, s)
        g = torch.where((v >= 0) & (v <= 1), g, torch.zeros((), dtype=g.dtype, device=g.device))
    N, H, W, CF = feats.shape
    C = CF // (s * s)
    gf = g.reshape(N, H, s, W, s, C).permute(0, 1, 3, 5, 2, 4).reshape(N, H, W, C * s * s)
    return gf, (gf.reshape(N, H, W, C, s * s).sum(-1) if anchor else None)


class _Kernel(torch.autograd.Function):
    """The kernel forward, the plain chain's gradient backward
    (:func:`_chain_grads`)."""

    @staticmethod
    def forward(ctx, feats, x, scale, clip, out_dtype, anchor):
        ctx.save_for_backward(feats, x)
        ctx.scale, ctx.clip, ctx.anchor = scale, clip, anchor
        return _launch(feats, x, scale, clip, out_dtype, anchor)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        feats, x = ctx.saved_tensors
        gf, gx = _chain_grads(feats, x, grad, ctx.scale, ctx.clip, ctx.anchor)
        return gf, gx, None, None, None, None


def sr_epilogue_call(feats: torch.Tensor, x: Optional[torch.Tensor], *, scale: int,
                     clip: bool, out_dtype, clock=None, anchor: bool = True) -> torch.Tensor:
    """ABPN's epilogue -> ``(N, H*s, W*s, C)`` in ``out_dtype``.

    ``feats`` ``(N, H, W, C*s*s)`` and ``x`` ``(N, H, W, C)`` may be
    strided views.  A CUDA tensor launches the kernel on the current stream
    (no synchronisation) or raises: feats and x must share one dtype,
    float32 or bfloat16, and one device.  The kernel writes a float32,
    bfloat16 or float16 ``out_dtype`` itself; any other is its output in
    the compute dtype, cast (the chain clamps before it casts, so the bits
    are the chain's).  ``clock`` (a stage clock,
    ``engine.spans.StageClock``) gets the ``epilogue`` stage noted in its
    ``kernels`` when the kernel launches.  A CPU or ``meta`` tensor runs
    :func:`sr_epilogue_plain`.  ``anchor=False`` adds nothing: ``x`` may be
    ``None`` and is not read.
    """
    _check_args(feats, x, scale, anchor)
    if feats.device.type in ("cpu", "meta"):
        return sr_epilogue_plain(feats, x, scale=scale, clip=clip, out_dtype=out_dtype,
                                 anchor=anchor)
    if feats.device.type != "cuda":
        raise ValueError(f"sr_epilogue_call runs on cuda, cpu or meta, not {feats.device}")
    hr_dtype = out_dtype if out_dtype in OUT_DTYPES else feats.dtype
    hr = _Kernel.apply(feats, x if anchor else feats, int(scale), bool(clip), hr_dtype,
                       bool(anchor))
    if clock is not None:
        clock.kernels.add("epilogue")
    return hr if hr_dtype == out_dtype else hr.to(out_dtype)


sr_epilogue_call.launches = 0  # kernel launches since import (or reset)

