"""Model configurations the port runs: the attention-only four of the JAX
package's pool (qwen3-0.6b, gemma2-9b, stablelm-3b, starcoder2-15b)."""
