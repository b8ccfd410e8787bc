"""Runnable examples of the port's public API."""
