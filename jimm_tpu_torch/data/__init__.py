"""Data: synthetic datasets."""
