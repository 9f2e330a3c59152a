"""A PNG codec in the standard library and numpy (``zlib``, ``struct``).

The JAX package reads and writes frames through ``imageio``
(``videoframeinterpolation_tpu/data/readers.py:read_image``); the card's
machine has no ``imageio``, so the port decodes and encodes PNG itself.

:func:`decode_png` reads 8-bit gray, gray with alpha, RGB and RGBA files,
non-interlaced, with any of the five row filters, and returns what
``imageio.v2.imread`` returns for the same file: ``(H, W)`` for gray,
``(H, W, 2)``, ``(H, W, 3)`` or ``(H, W, 4)`` otherwise, uint8. Palette,
16-bit, sub-byte and interlaced files raise ``ValueError`` naming the file
and the feature. Ancillary chunks are skipped.

Unfiltering is vectorised. Rows filtered with None, Sub or Up are undone a
whole row at a time (Sub as a cumulative sum mod 256 per channel along the
pixels). Average and Paeth need the reconstructed left neighbour, so from
the first such row on the rows are undone along anti-diagonals: a pixel
depends only on its left, upper and upper-left neighbours, which all lie
on the two diagonals before its own, so each diagonal is one set of numpy
operations over every row at once (``H + W`` steps in place of ``H * W``).

:func:`encode_png` writes filter 0 (None) on every row and one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, name)
COLOR_TYPES = {0: (1, "gray"), 2: (3, "RGB"), 3: (1, "palette"), 4: (2, "gray with alpha"),
               6: (4, "RGBA")}
_CHANNELS_TO_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes, name: str):
    """``(type, payload)`` of each chunk, CRCs checked, up to ``IEND``."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + payload):
            raise ValueError(f"{name}: CRC mismatch in {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def decode_png(data: bytes, name: str = "<png bytes>") -> np.ndarray:
    """Decode PNG ``data`` to a uint8 array, as ``imageio.v2.imread`` does."""
    header, idat = None, []
    for kind, payload in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in COLOR_TYPES:
        raise ValueError(f"{name}: unknown PNG colour type {color}")
    channels, color_name = COLOR_TYPES[color]
    if color == 3:
        raise ValueError(f"{name}: palette PNG is not supported")
    if depth == 16:
        raise ValueError(f"{name}: 16-bit PNG is not supported")
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit {color_name} PNG is not supported")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if compression or filter_method:
        raise ValueError(f"{name}: unknown compression {compression} or filter method "
                         f"{filter_method}")
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: image data has {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    kinds, filtered = rows[:, 0], rows[:, 1:].reshape(height, width, channels)
    if (kinds > 4).any():
        raise ValueError(f"{name}: unknown row filter {int(kinds.max())}")
    img = _unfilter(kinds, filtered)
    return img[..., 0] if channels == 1 else img


def _unfilter(kinds: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the row filters of ``filtered`` ``(H, W, C)``."""
    H, W, C = filtered.shape
    out = np.empty_like(filtered)
    prior = np.zeros((W, C), np.uint8)
    slow = np.flatnonzero(kinds >= 3)
    first_slow = int(slow[0]) if slow.size else H
    for r in range(first_slow):
        k, row = kinds[r], filtered[r]
        if k == 0:
            out[r] = row
        elif k == 1:
            out[r] = np.cumsum(row, axis=0, dtype=np.uint8)
        else:
            out[r] = row + prior
        prior = out[r]
    if first_slow < H:
        out[first_slow:] = _unfilter_diagonals(kinds[first_slow:], filtered[first_slow:], prior)
    return out


def _unfilter_diagonals(kinds: np.ndarray, filtered: np.ndarray,
                        prior: np.ndarray) -> np.ndarray:
    """Undo the filters of ``filtered`` ``(H, W, C)``, whose first row's
    prior row is ``prior``, one anti-diagonal ``d = r + x`` at a time.

    ``P[d + 2, r + 1]`` holds pixel ``(r, d - r)``, so a diagonal is
    contiguous; ``P[:, 0]`` holds ``prior`` (row -1) and two zero diagonals
    lead, so a pixel's left, upper and upper-left neighbours are
    ``P[d + 1, r + 1]``, ``P[d + 1, r]`` and ``P[d, r]``, and every
    neighbour outside the image reads 0."""
    H, W, C = filtered.shape
    D = H + W - 1
    P = np.zeros((D + 3, H + 1, C), np.int16)
    F = np.zeros((D, H, C), np.int16)
    # Pixel (-1, x) of the prior row lies on diagonal x - 1.
    P[1:W + 1, 0] = prior
    for r in range(H):
        F[r:r + W, r] = filtered[r]
    k = kinds.astype(np.int16)[:, None]
    present = set(kinds.tolist())
    for d in range(D):
        lo, hi = max(0, d - W + 1), min(H - 1, d) + 1
        a = P[d + 1, lo + 1:hi + 1]
        b = P[d + 1, lo:hi]
        c = P[d, lo:hi]
        if 4 in present:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        if present != {4}:
            kk = k[lo:hi]
            pred = np.where(kk == 4, pred, 0) if 4 in present else np.zeros_like(a)
            if 3 in present:
                pred = np.where(kk == 3, (a + b) >> 1, pred)
            if 2 in present:
                pred = np.where(kk == 2, b, pred)
            if 1 in present:
                pred = np.where(kk == 1, a, pred)
        P[d + 2, lo + 1:hi + 1] = (F[d, lo:hi] + pred) & 0xFF
    out = np.empty((H, W, C), np.uint8)
    for r in range(H):
        out[r] = P[r + 2:r + 2 + W, r + 1]
    return out


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 ``(H, W)`` gray or ``(H, W, C)`` image, C in
    1-4 (gray, gray with alpha, RGB, RGBA): filter 0 on every row, one IDAT
    chunk at zlib's default compression."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _CHANNELS_TO_COLOR:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 1-4) images, got {img.shape}")
    H, W, C = img.shape
    rows = np.zeros((H, W * C + 1), np.uint8)
    rows[:, 1:] = img.reshape(H, W * C)
    header = struct.pack(">IIBBBBB", W, H, 8, _CHANNELS_TO_COLOR[C], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
