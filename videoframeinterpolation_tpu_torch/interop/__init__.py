"""Carry parameters across from the JAX package's checkpoints."""

from .flax_params import params_from_flax

__all__ = ["params_from_flax"]
