"""Minimal pure-numpy PNG codec: an 8-bit RGB(A) reader with all five
scanline filters (for the ImageNet image-folder reader) and an 8-bit RGB
writer (filter 0, for sample grids).

Counterpart of gpnf_tpu/utils/png.py.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a: int, b: int, c: int) -> int:
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB or RGBA PNG (alpha dropped); raises
    ValueError on any other kind."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, b""
    w = h = ch = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype not in (2, 6):
                raise ValueError(f"{path}: only 8-bit RGB(A) PNG is read")
            if payload[12] != 0:
                raise ValueError(f"{path}: interlaced PNG is not read")
            ch = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if w is None:
        raise ValueError(f"{path}: no IHDR chunk")
    raw = zlib.decompress(idat)
    stride = w * ch
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1: pos + 1 + stride],
                            np.uint8).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            out = row
        elif ft == 1:  # sub
            out = row.copy()
            for x in range(ch, stride):
                out[x] = (out[x] + out[x - ch]) & 0xFF
        elif ft == 2:  # up
            out = (row + prev) & 0xFF
        elif ft == 3:  # average
            out = row.copy()
            for x in range(stride):
                left = out[x - ch] if x >= ch else 0
                out[x] = (out[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            out = row.copy()
            for x in range(stride):
                a = out[x - ch] if x >= ch else 0
                c = prev[x - ch] if x >= ch else 0
                out[x] = (out[x] + _paeth(a, prev[x], c)) & 0xFF
        else:
            raise ValueError(f"{path}: bad scanline filter {ft}")
        img[y] = out.astype(np.uint8)
        prev = img[y].astype(np.int32)
    return img.reshape(h, w, ch)[:, :, :3]


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
