"""Attention kernels of the port: hand-written CUDA for Hopper (``csrc/``),
their ctypes wrappers, and the plain PyTorch versions they are held to.

No kernel is built and nothing is loaded when this package is imported;
``_build`` compiles a source at its first launch.
"""
