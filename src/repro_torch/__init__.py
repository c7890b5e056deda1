"""PyTorch + CUDA port of the Scope serving stack for one NVIDIA H100.

``repro`` (JAX) is the reference; this package imports nothing of it and no
JAX.  Entry points take a ``device`` that defaults to ``"cuda"`` and raise
when CUDA is missing; the CPU runs only when asked for (``device="cpu"``).
"""
from .device import resolve_device  # noqa: F401
