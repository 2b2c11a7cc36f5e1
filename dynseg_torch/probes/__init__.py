"""Measurement entry points of the port (counterparts of scripts/*_probe.py)."""
