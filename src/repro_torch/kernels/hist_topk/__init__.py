"""Kernel B11: 256-bin histogram and Top-K threshold of uint8 score bins."""
