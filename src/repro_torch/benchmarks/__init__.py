"""Benchmarks of the PyTorch port (``python -m repro_torch.benchmarks.<name>``)."""
