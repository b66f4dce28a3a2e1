"""Batched LM serving with the PyTorch package: prefill + decode with KV
caches — the twin of ``examples/serve_lm.py``.

Thin wrapper over ``repro_torch.launch.serve`` showing the serving API on a
reduced config of a ported architecture (the dense and vlm families), on
the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-0.5b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-0.5b --device cpu
"""

import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--arch", "qwen2-0.5b", "--batch", "4", "--prompt-len", "32", "--gen", "16"]

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DEFAULTS))
