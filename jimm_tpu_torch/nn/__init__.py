"""Encoder building blocks: LayerNorm, transformer stack, towers."""
