"""Input handling of the serving path, the benchmark datasets and the procedural data of the quality study."""

from .loader import DataLoader
from .padder import InputPadder
from .png import decode_png, encode_png
from .synthetic import SyntheticMotion
from .vimeo90k import Vimeo90K

__all__ = ["DataLoader", "InputPadder", "SyntheticMotion", "Vimeo90K", "decode_png",
           "encode_png"]
