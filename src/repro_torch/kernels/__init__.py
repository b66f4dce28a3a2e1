"""Hand-written kernels for NVIDIA Hopper (sm_90a).

kernels/
  csrc/tilted_fusion.cu — K1, the paper's contribution: the fused L-layer
                          conv stack swept by tilted column tiles (CUDA C++)
  tilted_fusion.py      — its wrapper, launch counter, plain PyTorch
                          version and buffer accounting
  _build.py             — nvcc build on first use + ctypes loading
  ops.py                — public wrappers (channel padding, stream layout,
                          untilt)
  ref.py                — plain oracle

No module here builds or loads a kernel at import time; the first launch
on a CUDA tensor does.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
