"""Quality metrics (counterpart of ``videoframeinterpolation_tpu/eval``)."""

from .metrics import psnr, ssim_3d

__all__ = ["psnr", "ssim_3d"]
