"""The paper's ABPN model and the SR model registry (PyTorch)."""
