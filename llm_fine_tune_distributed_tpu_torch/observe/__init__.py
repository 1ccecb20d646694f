"""Training metrics."""
