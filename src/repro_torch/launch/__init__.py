"""Entry points of the port: ``serve_lm`` (batched prefill and greedy decode
of an LM with a KV cache)."""
