"""Image/record writers for the results driver.

Counterpart of `gme_tpu/io/writers.py`.  PNG writing replaces the
reference's `cv2.imwrite` calls (reference results.py:64-106): the native
writer (`gme_tpu_torch.native.loader`, zlib) when it builds, else OpenCV
when importable, else the dependency-free pure-Python encoder here.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def _png_encode(img: np.ndarray, compress_level: int = 1) -> bytes:
    """Minimal PNG encoder for uint8 grayscale / BGR images."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        color_type = 0  # grayscale
        raw = img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2  # truecolor; PNG wants RGB, our canvases are BGR
        raw = img[..., ::-1]
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = raw.shape[:2]
    # Filter byte 0 (None) per scanline.
    lines = np.zeros((h, 1 + raw[0].nbytes), dtype=np.uint8)
    lines[:, 1:] = raw.reshape(h, -1)
    compressed = zlib.compress(lines.tobytes(), compress_level)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, native: Optional[bool] = None) -> None:
    """Gray or BGR uint8 image to a PNG.  `native=True` demands the native
    writer and raises without it (the JAX package falls back there)."""
    img = np.asarray(img)
    if native is not False:
        from gme_tpu_torch.native import loader as native_loader

        if native is True:
            native_loader.write_png(path, img)  # raises when unavailable
            return
        try:
            if native_loader.available():
                native_loader.write_png(path, img)
                return
        except (OSError, ValueError):
            pass  # the JAX package's fallback: cv2, then pure Python
    if _HAS_CV2:
        cv2.imwrite(path, img)
        return
    with open(path, "wb") as f:
        f.write(_png_encode(img))


class PSNRRecords:
    """Incrementally-persisted per-pair PSNR records.

    Mirrors the reference's psnr_records.json (results.py:109-112) but stores
    real floats (the reference stores complex-number strings — utils.py
    cmath bug) and rewrites atomically.  `load` accepts both formats so
    reference-produced records remain readable.
    """

    def __init__(self, path: str):
        self.path = path
        self.records: Dict[str, float] = {}
        if os.path.exists(path):
            self.records = self.load(path)

    def add(self, idx, value: float) -> None:
        self.records[str(idx)] = float(value)

    def flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.records, f)
        os.replace(tmp, self.path)

    @staticmethod
    def load(path: str) -> Dict[str, float]:
        with open(path) as f:
            raw = json.load(f)
        out: Dict[str, float] = {}
        for k, v in raw.items():
            if isinstance(v, str):
                # reference format: "(22.72+0j)" — take the real part
                s = v.strip("()")
                if "+" in s[1:]:
                    s = s[: s.index("+", 1)]
                out[k] = float(s)
            else:
                out[k] = float(v)
        return out

    def summary(self) -> Dict[str, float]:
        """Aggregate stats (replaces reference utils.some_data, utils.py:138-164)."""
        vals = np.array(list(self.records.values()), dtype=np.float64)
        if vals.size == 0:
            return {}
        return {
            "count": int(vals.size),
            "avg": float(vals.mean()),
            "var": float(vals.var()),
            "std": float(vals.std()),
            "max": float(vals.max()),
            "min": float(vals.min()),
        }
