"""Synthetic TM data (the port's own copy)."""
