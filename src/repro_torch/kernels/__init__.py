"""Hand-written kernels for NVIDIA Hopper (sm_90a).

kernels/
  csrc/tilted_fusion.cu — K1, the paper's contribution: the fused L-layer
                          conv stack swept by tilted column tiles (CUDA C++)
  tilted_fusion.py      — its wrapper, launch counter, plain PyTorch
                          version, column-segment plan and buffer
                          accounting
  csrc/conv3x3.cu       — K2, one SAME 3x3 conv layer: the layer-by-layer
                          baseline datapath (CUDA C++)
  conv3x3.py            — its wrapper, launch counter and plain PyTorch
                          version
  csrc/sr_epilogue.cu   — ABPN's epilogue (anchor add, pixel shuffle, clip,
                          cast) in one pass over K1's output (CUDA C++)
  epilogue.py           — its wrapper, launch counter and plain PyTorch
                          version (the chain it replaces)
  csrc/esa.cu           — RLFN's block tail (c5 and ESA) in four passes over
                          whole frames (CUDA C++)
  esa.py                — its wrapper, launch counter and plain PyTorch
                          version (the chain it replaces)
  _build.py             — nvcc build on first use + ctypes loading
  ops.py                — public wrappers (channel padding, stream layout,
                          untilt; ``conv3x3``)
  ref.py                — plain oracles

No module here builds or loads a kernel at import time; the first launch
on a CUDA tensor does.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
