"""The LM stack of the port: layers, attention with a KV cache, and model
assembly for the dense attention architectures."""
