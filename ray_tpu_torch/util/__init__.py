"""Utilities of the port: collectives, metrics and tracing."""
