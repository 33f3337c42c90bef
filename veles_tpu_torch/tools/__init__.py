"""The port's operator tools, each run as ``python -m
veles_tpu_torch.tools.<name>``: ``obs_report`` (a metrics dir as the run
view, the fleet view or its traces), ``chaos_drill`` (the fault matrix),
``gauntlet`` (one accountable production day of the elastic fleet) and
``trace_cost`` (what a traced fleet request costs the host).
"""
