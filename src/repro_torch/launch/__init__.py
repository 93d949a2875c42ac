"""Entry points of the port: ``serve`` (the multi-tenant query server over
the six prepared queries) and ``serve_lm`` (batched prefill and greedy
decode of an LM with a KV cache)."""
