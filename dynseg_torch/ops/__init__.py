"""Kernels and quantization (counterpart of dynseg.ops)."""
