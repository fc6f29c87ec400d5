"""Serving: buckets, admission, the micro-batching engine, HTTP."""
