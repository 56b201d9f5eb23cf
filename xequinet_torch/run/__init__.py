"""Drivers of the port (inference)."""
