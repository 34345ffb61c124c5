"""Utilities of the port above its host layer (``utils/profiling.py``)."""
