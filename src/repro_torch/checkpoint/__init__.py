"""Checkpoints of the port (``repro.checkpoint``)."""
