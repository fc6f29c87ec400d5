"""Utilities: zero-shot classification."""
