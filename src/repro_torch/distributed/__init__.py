"""Sharding over `torch.distributed` process groups: the sharded decode's
context and collectives, the training half's parameter specs and meshes,
and EF21-compressed gradient reduction (`compression`)."""
