"""Freezing policy and optimizer (single device)."""
