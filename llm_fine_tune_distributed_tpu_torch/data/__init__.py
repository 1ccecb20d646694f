"""Tokenizer, prompts, dataset and loader of the port (copies of the JAX
package's data modules, so the port imports nothing of it)."""
