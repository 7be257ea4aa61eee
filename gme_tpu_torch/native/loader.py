"""ctypes bindings to the native host runtime, built at first use.

The same C ABI as the JAX package's native loader: y4m probe and decode,
the optional libav codec decode, `gme_write_png` and the asynchronous PNG
writer pool.  The port keeps its own copy of the C++ source,
`gme_tpu_torch/native/gme_native.cpp` (byte for byte the JAX package's),
so that a tree holding only `gme_tpu_torch/` builds it.  `g++` compiles it
into `gme_tpu_torch/_build/libgme_native_<hash>.so`, keyed by a hash of the
source and flags and put in place with `os.replace`, so processes that
build at once do not clash.  libav is linked only where its headers exist.

Without `g++`, zlib or the source, `available()` is False and the callers
take their pure-Python paths, as the JAX package's do when its library is
not built; `build_error()` says why.  A caller that demands the library
(`native=True`) raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCE = os.path.join(_PKG_DIR, "native", "gme_native.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None
# The writer pool's size in each library loaded (by path): the library
# starts its pool once, at the first size asked for, and ignores the rest.
_POOL_WORKERS: Dict[str, int] = {}


def _libav_flags() -> List[str]:
    """The FFmpeg/libav codec path, where its development headers exist."""
    for inc in ("/usr/include", "/usr/include/x86_64-linux-gnu"):
        if os.path.exists(os.path.join(inc, "libavformat", "avformat.h")):
            return ["-I" + inc, "-DGME_WITH_LIBAV",
                    "-lavformat", "-lavcodec", "-lavutil", "-lswscale"]
    return []


def build(force: bool = False) -> str:
    """Compile the library unless it exists (or `force`); its path.
    Raises RuntimeError when g++ or the source is missing or g++ fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime cannot be built")
    if not os.path.isfile(SOURCE):
        raise RuntimeError(f"native source {SOURCE} not found")
    # The libraries follow the source: the linker resolves left to right.
    libs = ["-lz", "-pthread", *_libav_flags()]
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode() + b"\0"
                             + f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libgme_native_{key}.so")
    if os.path.exists(path) and not force:
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_long, c_char_p, c_void_p = ctypes.c_int, ctypes.c_long, ctypes.c_char_p, ctypes.c_void_p
    u8p, intp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    sigs = {
        "gme_y4m_probe": (c_int, [c_char_p, intp, intp, intp]),
        "gme_y4m_decode": (c_int, [c_char_p, u8p, c_long]),
        "gme_codec_available": (c_int, []),
        "gme_codec_open": (c_void_p, [c_char_p, intp, intp]),
        "gme_codec_read_gray": (c_int, [c_void_p, u8p]),
        "gme_codec_close": (None, [c_void_p]),
        "gme_write_png": (c_int, [c_char_p, u8p, c_int, c_int, c_int, c_int]),
        "gme_png_writer_start": (c_int, [c_int]),
        "gme_png_writer_submit": (c_int, [c_char_p, u8p, c_int, c_int, c_int, c_int]),
        "gme_png_writer_drain": (c_int, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build and load once per process; None when the build is impossible."""
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _LIB = _bind(ctypes.CDLL(build()))
    except (RuntimeError, OSError) as e:
        _LIB, _ERROR = None, str(e)
    return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or untried)."""
    return _ERROR


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host runtime is not available: {_ERROR}")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_y4m(path: str) -> List[np.ndarray]:
    """Every frame's Y plane, (H, W) uint8, from one bulk decode."""
    lib = _lib()
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.gme_y4m_probe(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"native y4m probe failed ({rc}) for {path}")
    buf = np.empty((n.value, h.value, w.value), dtype=np.uint8)
    rc = lib.gme_y4m_decode(path.encode(), _u8(buf), buf.size)
    if rc != 0:
        raise ValueError(f"native y4m decode failed ({rc}) for {path}")
    return [buf[i] for i in range(n.value)]


def codec_available() -> bool:
    """True when the library was built with FFmpeg/libav support."""
    lib = _load()
    return lib is not None and bool(lib.gme_codec_available())


def iter_codec(path: str):
    """Grayscale frames of a codec video (mp4/webm/...), one at a time, by
    the native demux and decode (the same BT.601 fixed point as cv2)."""
    lib = _lib()
    if not lib.gme_codec_available():
        raise RuntimeError("the native host runtime was built without libav")
    w, h = ctypes.c_int(), ctypes.c_int()
    handle = lib.gme_codec_open(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if not handle:
        raise ValueError(f"native codec open failed for {path}")
    try:
        while True:
            buf = np.empty((h.value, w.value), dtype=np.uint8)
            rc = lib.gme_codec_read_gray(handle, _u8(buf))
            if rc == 0:
                return
            if rc < 0:
                raise ValueError(f"native codec decode failed ({rc}) for {path}")
            yield buf
    finally:
        lib.gme_codec_close(handle)


def decode_codec(path: str) -> List[np.ndarray]:
    return list(iter_codec(path))


def _image(img: np.ndarray):
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        return img, 1
    if img.ndim == 3 and img.shape[2] == 3:
        return img, 3
    raise ValueError(f"unsupported image shape {img.shape}")


def write_png(path: str, img: np.ndarray) -> None:
    """Gray or BGR uint8 image to a PNG (zlib level 1)."""
    img, channels = _image(img)
    rc = _lib().gme_write_png(path.encode(), _u8(img), img.shape[1], img.shape[0], channels, 1)
    if rc != 0:
        raise IOError(f"native png write failed ({rc}) for {path}")


class AsyncPNGWriter:
    """The native background PNG writer pool: gray and BGR images, each
    encoded as `write_png` encodes it.  `submit` copies the image; `drain`
    blocks until every submitted file is written and raises if any write
    failed.

    The pool starts once a process, with the `workers` of the first
    writer: a later writer shares it, whatever it asks for, and its
    `workers` is the size the pool runs at."""

    def __init__(self, workers: int = 2):
        self._lib = _lib()
        if self._lib.gme_png_writer_start(workers) != 0:
            raise RuntimeError("failed to start the native png writer pool")
        self.workers = _POOL_WORKERS.setdefault(self._lib._name, workers)

    def submit(self, path: str, img: np.ndarray) -> None:
        img, channels = _image(img)
        rc = self._lib.gme_png_writer_submit(
            path.encode(), _u8(img), img.shape[1], img.shape[0], channels, 1)
        if rc != 0:
            raise IOError(f"native png submit failed for {path}")

    def drain(self) -> None:
        if self._lib.gme_png_writer_drain() != 0:
            raise IOError("the native png writer pool failed to write a file")
