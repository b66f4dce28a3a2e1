"""repro_torch.distributed — step-function factories (the serving half of
the JAX package's ``repro.distributed``)."""
