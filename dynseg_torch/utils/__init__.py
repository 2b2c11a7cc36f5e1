"""Host-side utilities (the port's copy of dynseg/utils/logging.py)."""
