"""Video decode -> grayscale uint8 frame arrays.

Counterpart of `gme_tpu/io/video.py` (which the port cannot import: the
`gme_tpu` package loads JAX), with the same paths and fallbacks:

- codec formats (mp4/webm/...): the native libav shim when built with it,
  else OpenCV when importable (decode only);
- raw y4m: a dependency-free parser here, with the native runtime
  (`gme_tpu_torch.native.loader`) for bulk decode when it builds.

Grayscale conversion matches cv2.cvtColor(BGR2GRAY): the ITU-R BT.601 weights
0.114/0.587/0.299 with fixed-point rounding.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np

try:  # decode-only dependency
    import cv2  # type: ignore

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def bgr_to_gray(frame: np.ndarray) -> np.ndarray:
    """BT.601 luma with OpenCV's fixed-point rounding (matches
    cv2.cvtColor(..., COLOR_BGR2GRAY) bit-for-bit)."""
    b = frame[..., 0].astype(np.uint32)
    g = frame[..., 1].astype(np.uint32)
    r = frame[..., 2].astype(np.uint32)
    # OpenCV 15-bit fixed point: round(0.299/0.587/0.114 * 2^15).
    y = 3735 * b + 19235 * g + 9798 * r
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def _parse_y4m(path: str) -> List[np.ndarray]:
    """Minimal YUV4MPEG2 parser: returns the Y (luma) plane per frame."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"\n")
    header = data[:header_end].decode("ascii", "replace")
    if not header.startswith("YUV4MPEG2"):
        raise ValueError(f"not a y4m file: {path}")
    width = height = None
    subsampling = "420"
    for tok in header.split()[1:]:
        if tok.startswith("W"):
            width = int(tok[1:])
        elif tok.startswith("H"):
            height = int(tok[1:])
        elif tok.startswith("C"):
            subsampling = tok[1:]
    if width is None or height is None:
        raise ValueError(f"y4m header missing dimensions: {header}")
    ysize = width * height
    if subsampling.startswith("420"):
        frame_size = ysize + 2 * ((width // 2) * (height // 2))
    elif subsampling.startswith("422"):
        frame_size = ysize + 2 * ((width // 2) * height)
    elif subsampling.startswith("444"):
        frame_size = 3 * ysize
    elif subsampling.startswith("mono"):
        frame_size = ysize
    else:
        raise ValueError(f"unsupported y4m subsampling: {subsampling}")

    frames = []
    pos = header_end + 1
    n = len(data)
    while pos < n:
        fh_end = data.index(b"\n", pos)
        if not data[pos:fh_end].startswith(b"FRAME"):
            raise ValueError("corrupt y4m frame header")
        pos = fh_end + 1
        y = np.frombuffer(data, dtype=np.uint8, count=ysize, offset=pos)
        frames.append(y.reshape(height, width).copy())
        pos += frame_size
    return frames


def _iter_y4m(path: str):
    """Incremental YUV4MPEG2 parser: yields Y planes one frame at a time
    (same output as `_parse_y4m`, without reading the whole file upfront)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").rstrip("\n")
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {path}")
        width = height = None
        subsampling = "420"
        for tok in header.split()[1:]:
            if tok.startswith("W"):
                width = int(tok[1:])
            elif tok.startswith("H"):
                height = int(tok[1:])
            elif tok.startswith("C"):
                subsampling = tok[1:]
        if width is None or height is None:
            raise ValueError(f"y4m header missing dimensions: {header}")
        ysize = width * height
        if subsampling.startswith("420"):
            chroma = 2 * ((width // 2) * (height // 2))
        elif subsampling.startswith("422"):
            chroma = 2 * ((width // 2) * height)
        elif subsampling.startswith("444"):
            chroma = 2 * ysize
        elif subsampling.startswith("mono"):
            chroma = 0
        else:
            raise ValueError(f"unsupported y4m subsampling: {subsampling}")
        while True:
            fh = f.readline()
            if not fh:
                return
            if not fh.startswith(b"FRAME"):
                raise ValueError("corrupt y4m frame header")
            y = np.frombuffer(f.read(ysize), dtype=np.uint8)
            if y.size < ysize:
                raise ValueError("truncated y4m frame")
            yield y.reshape(height, width).copy()
            f.seek(chroma, 1)


def iter_video_frames(path: str, native: Optional[bool] = None):
    """Streaming decode: yields (H, W) uint8 grayscale frames one at a time.

    Same frame values as `get_video_frames` (bit-identical across paths),
    but incrementally — the input side of pipeline parallelism: the driver
    computes on early frames while later ones still decode (the reference
    decodes the whole video upfront, utils.py:9-31).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".y4m",):
        # Contract for y4m (aligned with get_video_frames, which prefers the
        # native loader): native=True demands the native loader (bulk decode,
        # raises if unbuilt); the default keeps the pure-Python parser because
        # it is the only *incremental* y4m path — both are bit-identical
        # (tests/test_torch_io.py), so the default trades nothing but
        # buffering.
        if native is True:
            from gme_tpu_torch.native import loader as native_loader

            if not native_loader.available():
                raise RuntimeError(
                    "native=True but the native y4m runtime is not available: "
                    f"{native_loader.build_error()}"
                )
            yield from native_loader.decode_y4m(path)
            return
        yield from _iter_y4m(path)
        return
    if native is not False:
        from gme_tpu_torch.native import loader as native_loader

        if native_loader.codec_available():
            yield from native_loader.iter_codec(path)
            return
        if native is True:
            raise RuntimeError(
                "native=True but the native runtime was not built with libav"
            )
    if not _HAS_CV2:
        raise RuntimeError(
            f"decoding {ext} requires the native runtime built with libav "
            "or OpenCV; convert to .y4m for the dependency-free path"
        )
    cap = cv2.VideoCapture(path)
    try:
        while True:
            if not cap.grab():
                return
            ok, frame = cap.retrieve()
            if not ok:
                return
            if frame.ndim == 3 and frame.shape[2] == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield frame
    finally:
        cap.release()


class FramePrefetcher:
    """Background-thread streaming decoder with blocking random access.

    Decodes `path` on a daemon thread into an in-memory frame list.  By
    default the whole video stays resident (as in the reference,
    utils.py:9-31 — the win is OVERLAP, not memory); for long clips the
    driver bounds residency with `max_ahead` (the decoder blocks once that
    many frames past the release watermark are buffered) and retires
    consumed frames with `release_below` (GOP-window eviction — the results
    loop is monotone, so frames below the flushed batch are dead).

    `frame(i)` blocks until frame i is decoded and returns None once the
    stream ends before i.  A decoder exception re-raises in the consumer —
    but only for frames the decoder never produced: the valid decoded
    prefix of a corrupt-tail stream stays accessible.

    With `timers` (a `utils.profiling.StageTimer`), each wait of the decoder
    on `max_ahead` is a `decode.blocked` stage on the decoder's thread.
    """

    def __init__(
        self,
        path: str,
        native: Optional[bool] = None,
        max_ahead: Optional[int] = None,
        timers=None,
    ):
        import threading

        self._timers = timers
        self._frames: List[Optional[np.ndarray]] = []
        self._released = 0  # frames below this index are evicted
        self._max_ahead = max_ahead
        self._done = False
        self._closed = False
        self._decode_s: Optional[float] = None
        self._err: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._run, args=(path, native), daemon=True
        )
        self._thread.start()

    def _run(self, path: str, native) -> None:
        import time as _time

        t0 = _time.perf_counter()
        complete = False
        try:
            for fr in iter_video_frames(path, native):
                with self._cv:
                    if self._full():
                        with (self._timers.stage("decode.blocked") if self._timers
                              else contextlib.nullcontext()):
                            while self._full():
                                self._cv.wait()
                    if self._closed:
                        return
                    self._frames.append(fr)
                    self._cv.notify_all()
            complete = True
        except Exception as e:  # re-raised in the consumer by frame()
            with self._cv:
                self._err = e
        finally:
            with self._cv:
                if complete:
                    self._decode_s = _time.perf_counter() - t0
                self._done = True
                self._cv.notify_all()

    def _full(self) -> bool:
        """The decoder must wait: `max_ahead` frames past the watermark are
        buffered and the prefetcher is open (call holding the lock)."""
        return (
            self._max_ahead is not None
            and len(self._frames) - self._released >= self._max_ahead
            and not self._closed
        )

    def frame(self, i: int) -> Optional[np.ndarray]:
        """Frame i, blocking until decoded; None if the stream ended first."""
        with self._cv:
            while len(self._frames) <= i and not self._done:
                self._cv.wait()
            if i < len(self._frames):
                if i < self._released:
                    raise RuntimeError(
                        f"frame {i} was released (release_below"
                        f"({self._released}) already retired it)"
                    )
                return self._frames[i]
            if self._err is not None:
                raise self._err
            return None

    def release_below(self, i: int) -> None:
        """Retire frames [0, i): their memory is dropped and the decoder's
        `max_ahead` window slides forward.  Accessing a retired frame is an
        error — callers release only below their own lookback window."""
        with self._cv:
            i = min(i, len(self._frames))
            if i <= self._released:
                return
            for j in range(self._released, i):
                self._frames[j] = None  # list slots stay (8 bytes each)
            self._released = i
            self._cv.notify_all()

    def resident(self) -> int:
        """Number of decoded frames currently held in memory."""
        with self._cv:
            return len(self._frames) - self._released

    def close(self) -> None:
        """Stop the decode thread (e.g. on a max_pairs early exit, where the
        bounded-`max_ahead` decoder would otherwise block forever)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def decode_seconds(self) -> Optional[float]:
        """Wall time of the COMPLETE background decode, or None while it is
        still running / was closed early / failed — so stage accounting
        never reads a half-written value (the read is synchronized)."""
        with self._cv:
            return self._decode_s

    def count(self) -> int:
        """Total frame count (blocks until the stream ends — do not call
        mid-stream with `max_ahead` set unless frames are being consumed
        concurrently, or decoder and caller deadlock)."""
        with self._cv:
            while not self._done:
                self._cv.wait()
            if self._err is not None:
                raise self._err
            return len(self._frames)


def get_video_frames(path: str, native: Optional[bool] = None) -> List[np.ndarray]:
    """Decode a video to a list of (H, W) uint8 grayscale frames.

    Mirrors the behaviour of reference utils.py:9-31 (full video in host
    RAM, grayscale).  Raw y4m files use the native C++ loader when built,
    else the pure-Python parser; codec formats use OpenCV.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".y4m",):
        if native is not False:
            from gme_tpu_torch.native import loader as native_loader

            if native is True and not native_loader.available():
                # The JAX package parses in Python here; the port raises.
                raise RuntimeError(
                    "native=True but the native y4m runtime is not available: "
                    f"{native_loader.build_error()}"
                )
            try:
                if native_loader.available():
                    return native_loader.decode_y4m(path)
            except (RuntimeError, ValueError, OSError):
                if native is True:
                    raise
        return _parse_y4m(path)

    # Codec formats: native FFmpeg shim first (bit-identical grayscale —
    # same decoder family + same BT.601 fixed point), cv2 as fallback.
    if native is not False:
        try:
            from gme_tpu_torch.native import loader as native_loader

            if native_loader.codec_available():
                return native_loader.decode_codec(path)
            if native is True:  # explicit request must not fall back to cv2
                raise RuntimeError(
                    "native=True but the native runtime was not built with libav"
                )
        except (RuntimeError, ValueError, OSError):
            if native is True:
                raise
    if not _HAS_CV2:
        raise RuntimeError(
            f"decoding {ext} requires the native runtime built with libav "
            "or OpenCV; convert to .y4m for the dependency-free path"
        )
    cap = cv2.VideoCapture(path)
    frames: List[np.ndarray] = []
    while True:
        if not cap.grab():
            break
        ok, frame = cap.retrieve()
        if not ok:
            break
        if frame.ndim == 3 and frame.shape[2] == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        frames.append(frame)
    cap.release()
    return frames


def write_y4m(path: str, frames, fps: int = 30) -> None:
    """Write grayscale frames as YUV4MPEG2 (C420jpeg, neutral chroma).

    Dependency-free lossless encode for the framework's raw-video path: the
    Y plane round-trips bit-exactly through `get_video_frames`.
    """
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    H, W = frames[0].shape
    if H % 2 or W % 2:
        raise ValueError("y4m 4:2:0 needs even dimensions")
    chroma = np.full((H // 2) * (W // 2), 128, np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            if fr.shape != (H, W):
                raise ValueError("all frames must share one shape")
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            f.write(chroma)
            f.write(chroma)


def frames_to_array(frames: List[np.ndarray]) -> np.ndarray:
    """Stack decoded frames into one (N, H, W) uint8 array."""
    return np.stack(frames, axis=0)


def create_video_from_frames(frame_path, num_frames, video_name, fps=30):
    """Re-encode result frames to a video (reference utils.py:119-136)."""
    if not _HAS_CV2:
        raise RuntimeError("create_video_from_frames requires OpenCV")
    imgs = []
    for i in range(3, num_frames):
        name = f"{i - 3}-{i}.png"
        img = cv2.imread(os.path.join(frame_path, name))
        if img is not None:
            imgs.append(img)
    if not imgs:
        raise FileNotFoundError(f"no frames found under {frame_path}")
    h, w = imgs[0].shape[:2]
    video = cv2.VideoWriter(video_name, 0, fps, (w, h))
    for img in imgs:
        video.write(img)
    video.release()
