"""RLFN's residual block tail on an NVIDIA Hopper card: wrapper and plain
version.

Each RLFB ends in ``u = c5(h)`` and ``u * ESA(u)``: ESA (Kong et al.,
CVPRW 2022) gates ``u`` with ``sigmoid(conv4(up(c3) + conv_f(c1_)))``,
where ``c1_ = conv1(u)`` and ``c3 = conv3(max_pool(conv2(c1_), 7, 3))``
with ``conv2`` at stride 2 and ``up`` the bilinear resize back to the
frame.  It replaces no TPU kernel: the JAX package has no RLFN.  The
kernels (``csrc/esa.cu``) run it in :data:`ESA_PASSES` launches over whole
NHWC frames: two full-resolution passes around two on the pooled map, so
``u`` never reaches device memory and the maps that do carry 16 channels.

* :func:`esa_call` — the wrapper.  A CUDA tensor launches the kernels (or
  raises on what they do not take); a CPU or ``meta`` tensor runs
  :func:`esa_plain` (on ``meta`` a traced call counts its operators).
  ``esa_call.launches`` counts kernel launches.
* :func:`esa_plain` — the plain PyTorch chain, a dozen passes: the
  convolutions (cuDNN on the card, TF32 off in fp32), max-pool, bilinear
  resize, sum, sigmoid, gate.  The kernels sum in another order and round
  where the chain's maps round: fp32 within ~1e-5 of it, bf16 as close to
  the fp32 chain as the bf16 chain is.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import exact_fp32
from repro_torch.kernels import _build

__all__ = ["ESA_PASSES", "FEATURES", "ESA_CHANNELS", "SHAPES", "DTYPES", "esa_call",
           "esa_plain"]

ESA_PASSES = 4  # launches a call: full resolution, conv2 + pool, conv3, full resolution
FEATURES, ESA_CHANNELS = 52, 16  # the widths the kernels are built for (RLFN's)
# each convolution's weight (Co, Ci, k, k): c5, conv1, conv_f, conv2, conv3, conv4
SHAPES = ((FEATURES, FEATURES, 1, 1), (ESA_CHANNELS, FEATURES, 1, 1),
          (ESA_CHANNELS, ESA_CHANNELS, 1, 1), (ESA_CHANNELS, ESA_CHANNELS, 3, 3),
          (ESA_CHANNELS, ESA_CHANNELS, 3, 3), (FEATURES, ESA_CHANNELS, 1, 1))
DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {dt: i for i, dt in enumerate(DTYPES)}  # the launcher's codes
MIN_SIDE = 15  # conv2 (3x3, stride 2, no padding) then the 7x7 pool need 15 rows and columns
MAX_PIXELS = 2**31 - 1  # the kernels index pixels in 32 bits (9,320 frames of 360x640)

WB = Tuple[torch.Tensor, torch.Tensor]


def esa_plain(x: torch.Tensor, c5: WB, conv1: WB, conv_f: WB, conv2: WB, conv3: WB,
              conv4: WB) -> torch.Tensor:
    """The plain chain on NHWC frames ``x`` ``(N, H, W, F)`` -> ``u *
    ESA(u)``, ``(N, H, W, F)`` contiguous, in ``x``'s dtype (fp32 with TF32
    off).  Weights are ``(w, b)`` pairs in ``(Co, Ci, kh, kw)`` layout, cast
    to ``x``'s dtype."""
    if x.dtype == torch.float32:
        with exact_fp32():
            return _chain(x, c5, conv1, conv_f, conv2, conv3, conv4)
    return _chain(x, c5, conv1, conv_f, conv2, conv3, conv4)


def _chain(x, c5, conv1, conv_f, conv2, conv3, conv4):
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC frames (channels last)

    def conv(t, wb, **kw):
        return F.conv2d(t, wb[0].to(dt), wb[1].to(dt), **kw)

    u = conv(h, c5)
    c1_ = conv(u, conv1)
    c3 = conv(F.max_pool2d(conv(c1_, conv2, stride=2), kernel_size=7, stride=3),
              conv3, padding=1)
    c3 = F.interpolate(c3, size=u.shape[2:], mode="bilinear", align_corners=False)
    c3 += conv(c1_, conv_f)
    del c1_
    m = torch.sigmoid_(conv(c3, conv4))
    return u.mul_(m).permute(0, 2, 3, 1).contiguous()


_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("esa")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.esa_launch.argtypes = [ci, vp, vp] + [vp] * 5 + [ci] * 3 + [vp]
        lib.esa_launch.restype = ci
        lib.esa_passes.argtypes = []
        lib.esa_passes.restype = ci
        lib.esa_error_string.argtypes = [ci]
        lib.esa_error_string.restype = ctypes.c_char_p
        if lib.esa_passes() != ESA_PASSES:
            raise RuntimeError(f"the ESA library launches {lib.esa_passes()} passes a call, "
                               f"not {ESA_PASSES}")
        _lib_handle = lib
    return _lib_handle


def _launch(x, pairs):
    if x.dtype not in DTYPES:
        raise ValueError(f"the ESA kernels take float32 or bfloat16 frames, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the ESA kernels take contiguous (N, H, W, C) frames")
    if x.data_ptr() % 16:
        raise ValueError("the ESA kernels take frames aligned to 16 bytes")
    N, H, W, C = x.shape
    got = tuple(tuple(w.shape) for w, _ in pairs)
    if C != FEATURES or got != SHAPES or any(tuple(b.shape) != (s[0],)
                                             for (_, b), s in zip(pairs, SHAPES)):
        raise ValueError(f"the ESA kernels are built for {FEATURES} features and "
                         f"{ESA_CHANNELS} ESA channels: weights {SHAPES} on (N, H, W, "
                         f"{FEATURES}) frames, got {got} on {tuple(x.shape)}")
    if H < MIN_SIDE or W < MIN_SIDE:
        raise ValueError(f"ESA's strided conv and 7x7 pool need frames of at least "
                         f"{MIN_SIDE} x {MIN_SIDE}, got {H} x {W}")
    if N * H * W > MAX_PIXELS:
        raise ValueError(f"the ESA kernels take at most {MAX_PIXELS} pixels a call, got "
                         f"{N} frames of {H} x {W}")
    if any(t.device != x.device for wb in pairs for t in wb):
        raise ValueError(f"ESA's weights must be on the frames' device {x.device}")
    dt, dev = x.dtype, x.device
    params = [t.to(dt).contiguous() for wb in pairs for t in wb]
    h2, w2 = (H - 3) // 2 + 1, (W - 3) // 2 + 1
    h3, w3 = (h2 - 7) // 3 + 1, (w2 - 7) // 3 + 1
    c1 = torch.empty((N, H, W, ESA_CHANNELS), dtype=dt, device=dev)
    cf = torch.empty_like(c1)
    pool = torch.empty((N, h3, w3, ESA_CHANNELS), dtype=dt, device=dev)
    c3 = torch.empty_like(pool)
    out = torch.empty_like(x)
    if N == 0:
        return out
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in params))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.esa_launch(_DTYPE_CODE[dt], x.data_ptr(), ctypes.addressof(ptrs),
                             c1.data_ptr(), cf.data_ptr(), pool.data_ptr(), c3.data_ptr(),
                             out.data_ptr(), N, H, W, stream)
    if err != 0:
        msg = lib.esa_error_string(err).decode()
        raise RuntimeError(f"ESA kernel launch failed: CUDA error {err} ({msg})")
    esa_call.launches += ESA_PASSES
    return out


def esa_call(x: torch.Tensor, c5: WB, conv1: WB, conv_f: WB, conv2: WB, conv3: WB,
             conv4: WB, *, clock=None) -> torch.Tensor:
    """An RLFB's tail ``u * ESA(u)``, ``u = c5(x)``, on NHWC frames ``x``
    ``(N, H, W, F)`` -> ``(N, H, W, F)`` contiguous in ``x``'s dtype.

    A CUDA tensor launches the kernels on the current stream (no
    synchronisation) or raises: ``x`` contiguous float32 or bfloat16 with
    52 channels, frames of at least 15 x 15 (at most ``MAX_PIXELS`` pixels
    in all), weights of RLFN's widths
    (:data:`SHAPES`) on ``x``'s device (cast to its dtype).  ``clock``
    (a stage clock, ``engine.spans.StageClock``) counts the launches under
    its stage ``esa``.  A CPU or ``meta`` tensor runs :func:`esa_plain`.
    """
    pairs = (c5, conv1, conv_f, conv2, conv3, conv4)
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C) frames, got shape {tuple(x.shape)}")
    if x.device.type in ("cpu", "meta"):
        return esa_plain(x, *pairs)
    if x.device.type != "cuda":
        raise ValueError(f"esa_call runs on cuda, cpu or meta, not {x.device}")
    out = _launch(x, pairs)
    if clock is not None:
        clock.note_launches("esa", ESA_PASSES)
    return out


esa_call.launches = 0  # kernel launches since import (or reset)
