"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel is built from ``csrc/`` on its first launch (``build.py``);
importing this package builds and loads nothing.
"""

from .window_sample import deformable_sample, deformable_sample_plain

__all__ = ["deformable_sample", "deformable_sample_plain"]
