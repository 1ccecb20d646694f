"""Helpers over the port's flat parameter dicts."""
