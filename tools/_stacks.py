"""What the kernels' timers and checks share (``chip_smoke.py``,
``tools/k1_times.py``, ``tools/k2_times.py``, ``tools/epilogue_times.py``,
``tools/k1_ablation.py``): a seeded conv stack with He weights, cuDNN's conv
stack on the same layers, the bound of a stack's useful work, the
epilogue's byte bound, and a device timer.

Not a script: ``chip_smoke.py`` and the tools import it from this directory.
It imports nothing of the package at import time, so a tool may time
another tree's ``repro_torch`` (``tools/k1_times.py --src``).
"""

import statistics


def he_arrays(np, channels, seed):
    """Seeded ``(w, b, relu)`` arrays of a conv stack over the feature
    widths ``channels`` (F_0..F_L), for ``models.abpn.layers_from_numpy``:
    He-initialised weights (``sqrt(2 / (9 Ci))``, as ``init_abpn``),
    biases from N(0, 0.1) (``init_abpn`` zeroes them), ReLU on every layer
    but the last."""
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(3, 3, channels[i], channels[i + 1]))
              * (2.0 / (9 * channels[i])) ** 0.5).astype(np.float32),
             (rng.normal(size=(channels[i + 1],)) * 0.1).astype(np.float32),
             i < len(channels) - 2)
            for i in range(len(channels) - 1)]


def cudnn_stack(torch, layers, dtype):
    """``run(x)``: cuDNN's conv stack on ``layers`` over ``x`` in NCHW and
    ``dtype``, one ``conv2d`` (and ReLU) a layer, TF32 off: the PyTorch
    calls that compute what K1 computes on these layers.  The weights are
    laid out and cast once, here, not in the timed calls."""
    from repro_torch.core.fusion import exact_fp32

    oihw = [(l.w.permute(3, 2, 0, 1).contiguous().to(dtype), l.b.to(dtype), l.relu)
            for l in layers]

    def run(x):
        with exact_fp32():
            for w, b, relu in oihw:
                x = torch.nn.functional.conv2d(x, w, b, padding=1)
                x = torch.relu(x) if relu else x
        return x

    return run


def useful_bound(layers, pixels, prec, itemsize, peaks):
    """The least time of a stack's useful work over ``pixels`` output
    pixels: 2 FLOP a multiply-add, fp32 as 3xTF32 (three TF32 products
    each) at ``peaks["tf32"]``, bf16 at ``peaks["bf16"]``; and the input,
    the output and the weights and biases in ``itemsize``-byte elements,
    each moved once, at ``peaks["bytes"]``.  Returns ``flops`` (the
    stack's own), ``bytes``, ``bound_ms``, ``bound_by`` ("operations" or
    "bytes") and ``bytes_bound_ms``."""
    flops = 2 * pixels * sum(9 * l.ci * l.co for l in layers)
    nbytes = itemsize * (pixels * (layers[0].ci + layers[-1].co)
                         + sum(l.w.numel() + l.b.numel() for l in layers))
    ops_ms = 1e3 * (3 * flops / peaks["tf32"] if prec == "fp32" else flops / peaks["bf16"])
    bytes_ms = 1e3 * nbytes / peaks["bytes"]
    return dict(flops=flops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bytes_bound_ms=bytes_ms)


def epilogue_bytes(frames, height, width, chp, channels, scale, itemsize, hr_itemsize):
    """The bytes ABPN's epilogue has to move over ``frames`` LR frames of
    ``height x width`` with ``channels`` colour channels, each once: every
    pixel's record of the features as K1 lays it out (``chp`` elements of
    ``itemsize`` bytes), the LR input in the same dtype, and the HR frame
    (``scale**2`` pixels a pixel) in ``hr_itemsize``-byte elements."""
    pixels = frames * height * width
    return pixels * ((chp + channels) * itemsize + scale * scale * channels * hr_itemsize)


def device_ms(torch, fn, calls=5, rounds=5):
    """Device milliseconds a call of ``fn``: ``calls`` calls queued behind
    a ~20 ms device sleep between two CUDA events, the median of
    ``rounds`` rounds (one call first, to warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's ~2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
