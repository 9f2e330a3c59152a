"""Read and write flax msgpack checkpoints without flax or msgpack; the trainer's checkpoint manager.

Counterpart of the msgpack branch of
``videoframeinterpolation_tpu/train/checkpoint.py:restore_teacher_params``
and of ``flax.serialization.to_bytes`` as ``tools/quality/head_to_head.py``
writes its checkpoints: a ``.ckpt`` / ``.best.ckpt`` file holds a
TrainState ``{"step", "params", "opt_state"}`` as one msgpack map. Each
ndarray is a msgpack ext object of type 1 whose payload is itself the
msgpack array ``(shape, dtype name, raw C-order bytes)``.

The decoder covers the msgpack types such a file uses: maps, arrays, str,
bin, ints, floats, nil, bool and ext; the encoder writes maps with str
keys, numpy arrays and non-negative ints, in the smallest encoding of
each, as the msgpack package does. Standard library and numpy only.
"""

from __future__ import annotations

import json
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


def _pack_uint(out: bytearray, n: int, codes: tuple) -> None:
    """A length or count after the first of ``codes`` (8-, 16- and 32-bit
    forms; ``None`` where the type has no such form) wide enough."""
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit a msgpack 32-bit field")


def _pack(out: bytearray, v) -> None:
    if isinstance(v, dict):
        n = len(v)
        if n < 16:
            out.append(0x80 | n)
        else:
            _pack_uint(out, n, (None, 0xDE, 0xDF))
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        if len(v) < 16:
            out.append(0x90 | len(v))
        else:
            _pack_uint(out, len(v), (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        if len(b) < 32:
            out.append(0xA0 | len(b))
        else:
            _pack_uint(out, len(b), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, bytes):
        _pack_uint(out, len(v), (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        v = int(v)   # an array's dimension: a TrainState writes no negative int
        if not 0 <= v < 1 << 64:
            raise ValueError(f"int {v} is not a msgpack uint")
        if v < 128:
            out.append(v)
        else:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if v < 1 << (8 * struct.calcsize(fmt)):
                    out += bytes([code]) + struct.pack(fmt, v)
                    return
    elif isinstance(v, np.ndarray):
        arr = np.asarray(v, order="C")   # (ascontiguousarray would make a 0-d array 1-d)
        payload = bytearray()
        _pack(payload, (list(arr.shape), arr.dtype.name, arr.tobytes()))
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _pack_uint(out, n, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot write a {type(v).__name__} to a flax checkpoint")


def flax_msgpack_bytes(state: dict) -> bytes:
    """``state`` (nested dicts with str keys, numpy arrays and ints) as the
    msgpack bytes ``flax.serialization.to_bytes`` gives for the same tree."""
    out = bytearray()
    _pack(out, state)
    return bytes(out)


def write_flax_state(path: str | Path, state: dict) -> None:
    """Write ``state`` (``{"step", "params", "opt_state"}``, as
    :func:`read_flax_state` returns it) to ``path`` atomically: to a
    ``.tmp`` file beside it, then renamed, as ``head_to_head.py`` does."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(flax_msgpack_bytes(state))
    tmp.replace(path)


class CheckpointManager:
    """Cadenced checkpoints of a training run (counterpart of the JAX
    package's Orbax ``CheckpointManager``): ``latest`` every
    ``save_latest_freq`` steps, ``epoch_XXX`` every ``save_every_freq_epoch``
    epochs, ``best_<benchmark>`` when validation improves. Each is
    ``<log_dir>/checkpoints/<name>.ckpt``, the whole TrainState as a flax
    msgpack file (written to a temporary file and renamed into place), and
    ``<name>.meta.json`` holding ``step``, ``epoch`` and ``best_psnr``.
    The JAX package's ``restore_teacher_params`` reads such a file through
    its msgpack branch."""

    SUFFIX = ".ckpt"

    def __init__(self, log_dir: str | Path, create: bool = True):
        self.dir = Path(log_dir).absolute() / "checkpoints"
        if create:
            self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.dir / f"{name}{self.SUFFIX}"

    def _meta_path(self, name: str) -> Path:
        return self.dir / f"{name}.meta.json"

    def save(self, name: str, tree: dict, *, epoch: int, best_psnr: float) -> None:
        """Write ``tree`` (``state_to_flax`` of the TrainState) and its meta."""
        write_flax_state(self.path(name), tree)
        meta = {"step": int(tree["step"]), "epoch": int(epoch), "best_psnr": float(best_psnr)}
        tmp = self._meta_path(name).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(meta))
        tmp.replace(self._meta_path(name))

    def restore(self, name: str) -> tuple[dict, dict]:
        """``(tree, meta)`` of checkpoint ``name``."""
        if not self.exists(name):
            raise FileNotFoundError(f"no checkpoint {name!r} under {self.dir}")
        return read_flax_state(self.path(name)), json.loads(self._meta_path(name).read_text())

    def exists(self, name: str) -> bool:
        return self.path(name).is_file() and self._meta_path(name).is_file()


def resolve_teacher_ckpt(path: str | Path) -> Path:
    """The file a ``teacher_ckpt`` names: a flax msgpack file as given (a
    committed ``.best.ckpt``, a port checkpoint), or a port experiment's
    checkpoint named without its suffix
    (``exps/teacher/checkpoints/best_vimeo90k``, as the two-stage recipe of
    ``configs/DAT_fast_distill.yaml`` writes it). An Orbax checkpoint
    directory of the JAX trainer raises: the port reads no Orbax."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(f"teacher_ckpt {path} is a directory, an Orbax checkpoint of the JAX "
                         "trainer; the port reads flax msgpack files (a .ckpt written by the "
                         "port's trainer or by a quality-study tool)")
    if p.is_file():
        return p
    with_suffix = p.with_name(p.name + CheckpointManager.SUFFIX)
    if with_suffix.is_file():
        return with_suffix
    raise FileNotFoundError(f"teacher_ckpt not found: {path}")


def restore_teacher_params(path: str | Path) -> dict:
    """The ``params`` tree of a teacher checkpoint (see
    :func:`resolve_teacher_ckpt`); its optimizer state is dropped."""
    return read_flax_msgpack(resolve_teacher_ckpt(path))
