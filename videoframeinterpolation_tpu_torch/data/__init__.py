"""Input handling of the serving path."""

from .padder import InputPadder

__all__ = ["InputPadder"]
