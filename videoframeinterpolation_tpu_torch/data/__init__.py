"""Input handling of the serving path, and the procedural data of the quality study."""

from .padder import InputPadder
from .synthetic import SyntheticMotion

__all__ = ["InputPadder", "SyntheticMotion"]
