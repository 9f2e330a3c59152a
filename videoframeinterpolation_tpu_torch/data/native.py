"""ctypes binding of the native host data path, ``native/vfi_data.cc`` (counterpart of ``videoframeinterpolation_tpu/data/native.py``).

``vfi_augment_triplet`` fuses a training item's augmentation (crop,
channel reverse, flips, rot90 with the flow fix-ups, uint8 -> float32
scaling) into one pass over the pixels. The C++ file is built as it stands,
at first use, with ``g++ -O3 -march=native -fPIC -shared -std=c++17`` into
the port's ``_build/`` directory (``.gitignore`` lists it), and rebuilt
only when the hash of the source, the flags and the host changes. Nothing is built
when this module is imported. A build or load that fails raises: the
dataset that asked for the native path does not fall back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vfi_data.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libvfi_data.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _digest() -> str:
    """The hash of the source, the flags and the host: ``-march=native``
    builds for this machine's CPU, so a build directory copied to another
    machine is rebuilt there."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.node().encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless a build of the same source exists."""
    digest = _digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data path cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent reader never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native data path failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the function's types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            f32 = ctypes.POINTER(ctypes.c_float)
            lib.vfi_augment_triplet.restype = ctypes.c_int
            lib.vfi_augment_triplet.argtypes = [
                u8, u8, u8, f32, f32,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, f32,
            ]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray | None, ctype):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctype))
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def augment_triplet_native(x0: np.ndarray, x1: np.ndarray, xt: np.ndarray,
                           f0x: np.ndarray | None, f1x: np.ndarray | None, *,
                           crop_hw: tuple[int, int], h_off: int, w_off: int,
                           chan_reverse: bool, vflip: bool, hflip: bool, rot: int,
                           img_scale: float = 1.0 / 255.0,
                           flow_scale: float = 1.0) -> np.ndarray:
    """The fused augmentation: the HWC float32 stack ``[x0|x1|xt(|f0x|f1x)]``
    of three ``(H, W, 3)`` uint8 images and, optionally, two ``(H, W, 2)``
    flows, with the JAX binding's arguments."""
    h, w, _ = x0.shape
    ch, cw = crop_hw
    for name, img in (("x0", x0), ("x1", x1), ("xt", xt)):
        if img.dtype != np.uint8 or img.shape != (h, w, 3):
            raise ValueError(f"{name}: expected a ({h}, {w}, 3) uint8 image, got "
                             f"{img.shape} {img.dtype}")
    if (f0x is None) != (f1x is None):
        raise ValueError("give both flows or neither")
    if not (0 <= h_off <= h - ch and 0 <= w_off <= w - cw):
        raise ValueError(f"crop {crop_hw} at ({h_off}, {w_off}) leaves the {h}x{w} frame")
    imgs = [np.ascontiguousarray(a) for a in (x0, x1, xt)]
    flows = [None if f is None else np.ascontiguousarray(f, np.float32) for f in (f0x, f1x)]
    for f in flows:
        if f is not None and f.shape != (h, w, 2):
            raise ValueError(f"a flow is {f.shape}, expected {(h, w, 2)}")
    oh, ow = (ch, cw) if rot % 2 == 0 else (cw, ch)
    out = np.empty((oh, ow, 9 + (4 if flows[0] is not None else 0)), np.float32)
    rc = load_library().vfi_augment_triplet(
        *(_ptr(a, ctypes.c_uint8) for a in imgs), *(_ptr(f, ctypes.c_float) for f in flows),
        h, w, ch, cw, h_off, w_off, int(chan_reverse), int(vflip), int(hflip), int(rot) & 3,
        img_scale, flow_scale, _ptr(out, ctypes.c_float))
    if rc != 0:
        raise RuntimeError(f"vfi_augment_triplet failed ({rc})")
    return out
