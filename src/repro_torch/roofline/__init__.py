"""repro_torch.roofline — what a step costs and what bounds it on a card:
``trace_cost`` (FLOPs and live bytes of a traced call, the counterpart of
the reference's HLO parser), ``model_flops`` (6ND), ``analytic`` (memory
and collective traffic per device), ``report`` (the published H100 peaks
and the roofline tables) and ``experiments_md`` (the tables as markdown)."""
