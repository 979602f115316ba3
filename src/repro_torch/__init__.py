"""PyTorch / CUDA port of the QAFeL reproduction (``repro``).

The package mirrors the JAX package's layout module for module and never
imports JAX or the JAX package. Its entry points run on the CUDA device
unless the caller passes ``device="cpu"``; the kernels of the wire path are
hand-written CUDA C++ for Hopper (``kernels/csrc``), with plain PyTorch
versions that the CPU runs.
"""
__version__ = "0.1.0"
