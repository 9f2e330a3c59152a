"""Quality metrics and the benchmark loops (counterpart of ``videoframeinterpolation_tpu/eval``)."""

from .benchmarks import validate_snu, validate_synthetic, validate_ucf101, validate_vimeo90k
from .metrics import psnr, ssim_3d

__all__ = ["psnr", "ssim_3d", "validate_snu", "validate_synthetic", "validate_ucf101",
           "validate_vimeo90k"]
