"""HF checkpoint IO: safetensors reading and writing, checkpoint resolution,
the declarative mapping engine, position-table surgery and HF export."""
