"""File readers for images and optical flow (counterpart of ``videoframeinterpolation_tpu/data/readers.py``).

``.flo`` (Middlebury PIEH), ``.pfm``, ``.float3`` and ``.npy`` are read with
numpy as the JAX package reads them; ``.png`` through the port's own codec
(:mod:`.png`), which returns what ``imageio.v2.imread`` returns. JPEG and
the netpbm formats, which the JAX package reads through ``imageio``, are not
ported and raise.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from .png import decode_png


def read_float3(name: str) -> np.ndarray:
    """``.float3`` reader (reference ``data/base.py:12-34``)."""
    with open(name, "rb") as f:
        if f.readline().decode("utf-8") != "float\n":
            raise ValueError(f"float file {name} did not contain <float> keyword")
        dim = int(f.readline())
        dims = []
        count = 1
        for _ in range(dim):
            d = int(f.readline())
            dims.append(d)
            count *= d
        dims = list(reversed(dims))
        data = np.fromfile(f, np.float32, count).reshape(dims)
    if dim > 2:
        data = np.transpose(data, (2, 1, 0))
        data = np.transpose(data, (1, 0, 2))
    return data


def read_pfm(name: str) -> tuple[np.ndarray, float]:
    """PFM reader (reference ``data/base.py:37-73``)."""
    with open(name, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def read_flo(name: str) -> np.ndarray:
    """Middlebury ``.flo`` reader (reference ``data/base.py:76-91``)."""
    with open(name, "rb") as f:
        header = f.read(4)
        if header.decode("utf-8") != "PIEH":
            raise ValueError("Flow file header does not contain PIEH")
        width = int(np.fromfile(f, np.int32, 1).squeeze())
        height = int(np.fromfile(f, np.int32, 1).squeeze())
        flow = np.fromfile(f, np.float32, width * height * 2).reshape((height, width, 2))
    return flow.astype(np.float32)


def write_flo(name: str, flow: np.ndarray) -> None:
    """Middlebury ``.flo`` writer (for tests / dataset preparation)."""
    h, w, c = flow.shape
    assert c == 2
    with open(name, "wb") as f:
        f.write(b"PIEH")
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_image(name: str) -> np.ndarray:
    """A ``.pfm`` (its first three channels) or ``.png`` image; other
    formats raise."""
    if name.endswith((".pfm", ".PFM")):
        data = read_pfm(name)[0]
        if data.ndim == 3:
            return data[:, :, 0:3]
        return data
    if name.lower().endswith(".png"):
        return decode_png(Path(name).read_bytes(), name)
    raise ValueError(f"{name}: only PNG and PFM images are read by the port "
                     "(JPEG and netpbm are not ported)")


def read(file: str) -> np.ndarray:
    """Extension-dispatched reader (reference ``data/base.py:104-113``)."""
    if file.endswith(".float3"):
        return read_float3(file)
    if file.endswith((".flo",)):
        return read_flo(file)
    if file.endswith((".ppm", ".pgm", ".png", ".jpg", ".jpeg")):
        return read_image(file)
    if file.endswith(".npy"):
        return np.load(file)
    if file.endswith((".pfm", ".PFM")):
        return read_pfm(file)[0]
    raise ValueError(f"don't know how to read {file}")
