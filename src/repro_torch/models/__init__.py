"""The paper's ABPN model, the decoder-only LM and the model registry (PyTorch)."""
