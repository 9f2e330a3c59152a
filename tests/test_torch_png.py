"""The port's standard-library PNG codec against ``imageio`` (CPU).

A test-side encoder writes 8-bit PNGs with each of the five row filters
alone and mixed row by row, for gray, gray with alpha, RGB and RGBA, at odd
widths. The port's decoder must give exactly what ``imageio.v2.imread``
gives for the same bytes (values, shape and dtype); ``encode_png`` followed
by ``imageio`` must give the image back exactly; palette, 16-bit, sub-byte
and interlaced files must raise ``ValueError`` naming the file and the
feature. The readers of the port are held to the JAX package's on the
numpy formats (``.flo``, ``.pfm``, ``.float3``, ``.npy``): equal arrays.
"""

import io
import struct
import time
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from videoframeinterpolation_tpu.data import readers as jax_readers
from videoframeinterpolation_tpu_torch.data import png, readers
from videoframeinterpolation_tpu_torch.data.png import decode_png, encode_png

CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # PNG colour type -> channels


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(img: np.ndarray, kinds) -> bytes:
    """The raw scanlines of ``img (H, W, C)``, row ``r`` filtered with
    ``kinds[r]``, written byte by byte from the PNG specification."""
    H, W, C = img.shape
    rows = img.reshape(H, W * C).astype(int)
    out = bytearray()
    for r in range(H):
        k = kinds[r]
        out.append(k)
        for i in range(W * C):
            x = rows[r, i]
            a = rows[r, i - C] if i >= C else 0
            b = rows[r - 1, i] if r > 0 else 0
            c = rows[r - 1, i - C] if r > 0 and i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[k]
            out.append((x - pred) % 256)
    return bytes(out)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def _png(width, height, depth, color, raw: bytes, interlace=0, extra=b"") -> bytes:
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    # Two IDAT chunks, as encoders that split their data write them.
    data = zlib.compress(raw)
    half = len(data) // 2
    return (png.SIGNATURE + _chunk(b"IHDR", header) + extra + _chunk(b"IDAT", data[:half])
            + _chunk(b"IDAT", data[half:]) + _chunk(b"IEND", b""))


def _image(rng, h, w, c):
    # A smooth ramp plus noise, so that every predictor and both wrap-arounds occur.
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 37 + xx * 11)[..., None] + np.arange(c) * 60
    return ((base + rng.integers(0, 256, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("color", sorted(CHANNELS))
@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
def test_decode_equals_imageio(color, filters):
    rng = np.random.default_rng(color * 10 + len(filters))
    h, w = 9, 13
    img = _image(rng, h, w, CHANNELS[color])
    kinds = (list(rng.integers(0, 5, h)) if filters == "mixed" else [int(filters)] * h)
    data = _png(w, h, 8, color, _filter_rows(img, kinds))
    ours = decode_png(data)
    ref = np.asarray(imageio.imread(io.BytesIO(data), format="png"))
    assert ours.dtype == ref.dtype == np.uint8
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours.reshape(h, w, -1), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_equals_imageio_on_pillow_files(mode):
    """Pillow writes its own filter choice per row (adaptive filtering)."""
    rng = np.random.default_rng(5)
    img = _image(rng, 31, 45, len(mode))
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(buf, format="png")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), np.asarray(imageio.imread(data)))


@pytest.mark.parametrize("shape", [(7, 11), (7, 11, 1), (5, 13, 2), (9, 15, 3), (3, 17, 4)])
def test_encode_round_trips_through_imageio(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    ref = np.asarray(imageio.imread(io.BytesIO(data), format="png"))
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    assert ref.shape == want.shape
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("depth,color,interlace,feature", [
    (8, 3, 0, "palette"), (16, 2, 0, "16-bit"), (16, 0, 0, "16-bit"),
    (4, 0, 0, "4-bit gray"), (8, 2, 1, "interlaced")])
def test_unsupported_forms_raise(tmp_path, depth, color, interlace, feature):
    path = tmp_path / "x.png"
    path.write_bytes(_png(4, 3, depth, color, b"\x00" * 64, interlace))
    with pytest.raises(ValueError, match=f"{path}.*{feature}"):
        readers.read_image(str(path))


def test_corrupt_and_other_formats_raise(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    data = bytearray(encode_png(img))
    data[-20] ^= 1   # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(20))
    for name in ("a.jpg", "a.jpeg", "a.ppm"):
        with pytest.raises(ValueError, match="not ported"):
            readers.read(str(tmp_path / name))


def test_numpy_formats_read_as_the_jax_readers_read_them(tmp_path):
    rng = np.random.default_rng(3)
    flow = rng.standard_normal((6, 7, 2)).astype(np.float32)
    readers.write_flo(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(readers.read(str(tmp_path / "a.flo")),
                                  jax_readers.read(str(tmp_path / "a.flo")))
    np.testing.assert_array_equal(readers.read_flo(str(tmp_path / "a.flo")), flow)
    for header, shape in ((b"PF", (5, 4, 3)), (b"Pf", (5, 4))):
        data = rng.standard_normal(shape).astype("<f4")
        p = tmp_path / f"{header.decode()}.pfm"
        p.write_bytes(header + b"\n4 5\n-1.0\n" + data.tobytes())
        ours, scale = readers.read_pfm(str(p))
        ref, ref_scale = jax_readers.read_pfm(str(p))
        np.testing.assert_array_equal(ours, ref)
        assert scale == ref_scale == 1.0
        np.testing.assert_array_equal(readers.read_image(str(p)), jax_readers.read_image(str(p)))
    vol = rng.standard_normal((2, 3, 4)).astype(np.float32)
    p = tmp_path / "v.float3"
    p.write_bytes(b"float\n3\n4\n3\n2\n" + vol.tobytes())
    np.testing.assert_array_equal(readers.read(str(p)), jax_readers.read(str(p)))
    np.save(tmp_path / "a.npy", flow)
    np.testing.assert_array_equal(readers.read(str(tmp_path / "a.npy")), flow)


def test_png_reads_as_the_jax_reader_reads_it(tmp_path):
    img = _image(np.random.default_rng(4), 11, 19, 3)
    p = tmp_path / "a.png"
    imageio.imwrite(str(p), img)
    np.testing.assert_array_equal(readers.read(str(p)), jax_readers.read(str(p)))


@pytest.mark.parametrize("hw", [(256, 448), (720, 1280)])
def test_decode_time(hw):
    """Prints ms per decode of an RGB frame: the port's own encoding (filter
    0) and Pillow's (adaptive filters, mostly Paeth on photos). Not a
    limit; the host's speed varies."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    img = np.stack([(yy + xx) % 256, (yy * 2) % 256, (xx * 3) % 256], -1).astype(np.uint8)
    img = (img + rng.integers(0, 8, img.shape)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="png")
    for name, data in (("encode_png", encode_png(img)), ("pillow", buf.getvalue())):
        start = time.perf_counter()
        out = decode_png(data)
        ms = (time.perf_counter() - start) * 1e3
        print(f"decode_png {hw[1]}x{hw[0]} RGB, {name} file: {ms:.1f} ms")
        np.testing.assert_array_equal(out, img)
