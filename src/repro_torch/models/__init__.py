"""Model code: config, layers, attention blocks, prefill and decode."""
