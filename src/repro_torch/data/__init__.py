"""Deterministic synthetic batches."""
