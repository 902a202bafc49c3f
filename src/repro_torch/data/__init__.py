"""Deterministic synthetic data (numpy) and its prefetching pipeline."""
