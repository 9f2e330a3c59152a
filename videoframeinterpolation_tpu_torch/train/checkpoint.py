"""Read flax msgpack checkpoints without flax or msgpack.

Counterpart of the msgpack branch of
``videoframeinterpolation_tpu/train/checkpoint.py:restore_teacher_params``:
a ``.ckpt`` / ``.best.ckpt`` file written by ``flax.serialization.to_bytes``
holds a TrainState ``{"step", "params", "opt_state"}`` as one msgpack map.
Each ndarray is a msgpack ext object of type 1 whose payload is itself the
msgpack array ``(shape, dtype name, raw C-order bytes)``.

The decoder below covers the msgpack types such a file uses: maps, arrays,
str, bin, ints, floats, nil, bool and ext. It uses the standard library and
numpy only.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, dtype_name, raw = r.value()
    if r.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    # Copy: np.frombuffer over bytes is read-only.
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).copy()
    return arr.reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).value()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _check_unchunked(tree) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked arrays (> 1 GiB leaves) are not supported")
        for v in tree.values():
            _check_unchunked(v)


def read_flax_state(path: str | Path) -> dict:
    """Return a flax msgpack TrainState file as a dict: ``step`` (a numpy
    scalar), ``params`` and ``opt_state``, with numpy leaves bit-identical
    to what ``flax.serialization.msgpack_restore`` gives."""
    reader = _Reader(Path(path).read_bytes())
    state = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{path}: not a flax TrainState (no 'params' key)")
    _check_unchunked(state["params"])
    return state


def read_flax_msgpack(path: str | Path) -> dict:
    """Return the ``params`` tree of a flax msgpack TrainState file (see
    :func:`read_flax_state`)."""
    return read_flax_state(path)["params"]
