"""A PNG reader for the images the driver writes: 8-bit gray or RGB,
not interlaced, any of the five row filters."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 2:
        return (row.astype(np.uint16) + up).astype(np.uint8)
    out = row.astype(np.int64)
    if kind == 1:
        for c in range(bpp):
            out[c::bpp] = np.cumsum(out[c::bpp]) & 255
        return out.astype(np.uint8)
    up = up.astype(np.int64)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            out[i] = (out[i] + (left + up[i]) // 2) & 255
        else:
            upleft = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, int(up[i]), upleft)) & 255
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, 3) uint8, channels in the file's order (RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, color {color})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    rows, up = [], np.zeros(w * bpp, np.uint8)
    for r in range(h):
        up = _unfilter(int(raw[r, 0]), raw[r, 1:], up, bpp)
        rows.append(up)
    img = np.stack(rows)
    return img if bpp == 1 else img.reshape(h, w, 3)
