"""Kernels and attention dispatch; see each module."""
