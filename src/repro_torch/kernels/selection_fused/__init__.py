"""Kernel B5: fused INT8 binning, max-pool and histogram over paged scores."""
