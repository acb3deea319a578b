"""Utilities of the port (collectives so far)."""
