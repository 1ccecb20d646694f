"""Model configs, the transformer forward and checkpoint I/O of the port."""
