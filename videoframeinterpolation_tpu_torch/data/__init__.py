"""The host data path: readers, the PNG codec, augmentations, the datasets and the loader."""

from .augment import random_augment
from .loader import DataLoader
from .padder import InputPadder
from .png import decode_png, encode_png
from .synthetic import SyntheticMotion
from .vimeo90k import Vimeo90K, Vimeo90KwFlow

DATASET_REGISTRY = {
    "Vimeo90K": Vimeo90K,
    "Vimeo90KwFlow": Vimeo90KwFlow,
    "SyntheticMotion": SyntheticMotion,
}

__all__ = ["DATASET_REGISTRY", "DataLoader", "InputPadder", "SyntheticMotion", "Vimeo90K",
           "Vimeo90KwFlow", "decode_png", "encode_png", "random_augment"]
