"""repro_torch.distributed — step-function factories, the logical-axis
partitioning rules and data-parallel gradient synchronisation (the port of
the JAX package's ``repro.distributed``)."""
