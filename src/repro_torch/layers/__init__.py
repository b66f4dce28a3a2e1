"""LM layers (PyTorch): params, norms, rope, MLP, GQA attention."""
