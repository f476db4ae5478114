"""Block-sharded decode over `torch.distributed` process groups."""
