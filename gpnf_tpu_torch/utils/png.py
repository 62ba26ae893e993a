"""Minimal pure-numpy PNG writer (8-bit RGB, filter 0).

Counterpart of `write_png` in gpnf_tpu/utils/png.py.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img (H, W, 3) uint8."""
    h, w, c = img.shape
    if c != 3 or img.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        payload = tag + data
        return (struct.pack(">I", len(data)) + payload
                + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
