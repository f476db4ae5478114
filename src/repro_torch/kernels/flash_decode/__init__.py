"""Kernel package: see ops.py."""
