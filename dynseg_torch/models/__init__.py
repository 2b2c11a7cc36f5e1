"""Dilated segmentation nets (counterpart of dynseg.models)."""
