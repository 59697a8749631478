"""Optimizer, train step and trainer."""
