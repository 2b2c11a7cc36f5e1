"""The plain reference: plain PyTorch, no JAX, nothing of dynseg_torch."""
