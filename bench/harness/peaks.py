"""The peaks the rooflines and ``mfu`` divide by: one NVIDIA H100 SXM5
(80 GB HBM3), NVIDIA's data sheet, dense, at the full 700 W power limit.

fp32 is served on the tensor cores as 3xTF32 (three TF32 products for each
fp32 one, which keeps fp32's accuracy), so its peak is TF32's over 3.
"""

TF32 = 495e12  # FLOP/s
BF16 = 989e12  # FLOP/s
HBM_BYTES = 3.35e12  # bytes/s

_FLOPS = {"fp32": TF32 / 3, "bf16": BF16}
_ELEMENT_BYTES = {"fp32": 4, "bf16": 2}


def flops(precision: str) -> float:
    """The compute peak a cell of ``precision`` is held to."""
    return _FLOPS[precision]


def element_bytes(precision: str) -> int:
    return _ELEMENT_BYTES[precision]
