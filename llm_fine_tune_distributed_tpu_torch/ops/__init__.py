"""Tensor ops of the port: norms, rope, attention, the int8 KV pool and the
paged decode kernel's wrapper."""
