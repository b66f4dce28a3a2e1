"""Deterministic synthetic data and the input pipeline (the port of ``repro.data``)."""
