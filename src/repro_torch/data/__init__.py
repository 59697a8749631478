"""Deterministic synthetic data sources."""
