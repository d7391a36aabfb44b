"""Distribution on ``torch.distributed`` process groups (the counterpart
of ``repro.parallel``): sharding rules (``api``), int8-compressed data
parallelism (``compress``) and GPipe pipelining (``pipeline``)."""
