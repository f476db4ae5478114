"""Kernel B10: stride-1 max-pool of uint8 score bins."""
