"""Attention kernels: the CUDA forward kernel, its wrapper and the oracle."""
