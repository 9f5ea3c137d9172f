"""Image output on numpy: ``[H, W, 3]`` floats in [0, 1], row 0 at the top."""

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


def write_png(img, path: str, gamma2: bool = False) -> None:
    """Write an 8-bit RGB PNG. ``gamma2=True`` applies the reference's sqrt
    encoding (src/vec.jl:22) to linear input first."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    arr = to_uint8(np.sqrt(np.clip(img, 0, None)) if gamma2 else img)
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
