"""Optimizer of the port (``adamw``)."""
