"""abpn_x3 — the paper's own model: ABPN x3 super-resolution (ISCAS 2022).

Not an LM: this config routes to the SR pipeline (core.fusion + the
tilted-fusion CUDA kernel).  640x360 -> 1920x1080, 7 conv layers,
28 feature channels, 8-bit quantised deployment.
"""

from repro_torch.models.abpn import ABPNConfig

CONFIG = ABPNConfig(in_channels=3, feature_channels=28, num_layers=7, scale=3)

# The accelerator design point (buffers, PE array) lives in
# repro_torch.core.analysis.HWConfig and defaults to this model.
