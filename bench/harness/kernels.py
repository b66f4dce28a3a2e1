"""Which device operations of a trace are K1's.

K1 (``src/repro_torch/kernels/csrc/tilted_fusion.cu``) launches, per call,
a weight-packing kernel (``pack_weights_kernel`` or ``pack_slices_kernel``)
and then its main kernel (``tilted_fusion_kernel``,
``tilted_fusion_kernel_onchip`` or ``tilted_fusion_wide_kernel``, each a
template instance).  Everything else on the device in a served dispatch
(uploads, assembly, the stream layout, the untilt and the epilogue) is the
executor's glue.
"""

import re

_MAIN = re.compile(r"\btilted_fusion_(wide_)?kernel")
_PACK = re.compile(r"\bpack_(weights|slices)_kernel")


def is_k1_main(name: str) -> bool:
    return bool(_MAIN.search(name))


def is_k1(name: str) -> bool:
    return bool(_MAIN.search(name) or _PACK.search(name))
