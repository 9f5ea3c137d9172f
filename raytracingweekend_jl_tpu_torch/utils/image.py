"""Image I/O on numpy: ``[H, W, 3]`` floats in [0, 1], row 0 at the top.

Plain numpy and the standard library: the port has no native writer and
needs no PIL."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """[H,W,3] float [0,1] -> uint8, rounding ties to even (np.rint)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img, dtype=np.float64)
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)


def _encoded(img, gamma2: bool) -> np.ndarray:
    """uint8 pixels of ``img``; ``gamma2=True`` applies the reference's sqrt
    encoding (src/vec.jl:22) to linear input first."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return to_uint8(np.sqrt(np.clip(img, 0, None)) if gamma2 else img)


def write_png(img, path: str, gamma2: bool = False) -> None:
    """Write an 8-bit RGB PNG. ``gamma2=True`` applies the reference's sqrt
    encoding (src/vec.jl:22) to linear input first."""
    arr = _encoded(img, gamma2)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_ppm(img, path: str, gamma2: bool = False) -> None:
    """Write a binary PPM (P6); ``gamma2`` as in :func:`write_png`."""
    arr = _encoded(img, gamma2)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4}  # colour type -> channels (RGB, RGBA)


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of
    ``h`` rows of ``w * bpp`` bytes, each led by its filter byte."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int16)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int16)
        if kind == 0:
            cur = line
        elif kind == 1:
            # Each byte adds the reconstructed one bpp before it: a running
            # sum per channel, modulo 256.
            cur = (np.cumsum(line.reshape(w, bpp), axis=0) & 0xFF).ravel()
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # Each byte depends on the reconstructed one bpp before it.
            cur = np.zeros(stride, dtype=np.int16)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if kind == 3:
                    p = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + p) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG, not interlaced, to float ``[H, W, 3]``
    in [0, 1] (alpha dropped). A stdlib decoder (zlib and the five row
    filters); any other PNG raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit RGB or RGBA PNGs without interlacing are "
            f"read (bit depth {depth}, colour type {colour}, interlace "
            f"{interlace})")
    bpp = _PNG_CHANNELS[colour]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return pix.reshape(h, w, bpp)[..., :3].astype(np.float64) / 255.0
