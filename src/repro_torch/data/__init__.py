"""Synthetic training data of the port (``repro.data``)."""
