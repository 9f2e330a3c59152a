"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel is built from ``csrc/`` on its first launch (``build.py``);
importing this package builds and loads nothing.
"""

from .gather import lane_gather, lane_gather_plain, row_gather, row_gather_plain
from .window_sample import (deformable_sample, deformable_sample_backward_plain,
                            deformable_sample_plain)

__all__ = ["deformable_sample", "deformable_sample_backward_plain", "deformable_sample_plain",
           "lane_gather", "lane_gather_plain", "row_gather", "row_gather_plain"]
