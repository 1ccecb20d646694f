"""Tokenizer and prompts of the port (copies of the JAX package's jax-free
data modules, so the port imports nothing of it)."""
