"""Paged serving of the port: sampling, block bookkeeping, the generator,
the continuous batching engine and the HTTP server."""
