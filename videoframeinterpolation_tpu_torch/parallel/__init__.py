"""Spatially tiled HD inference (counterpart of ``videoframeinterpolation_tpu/parallel``, one card)."""
