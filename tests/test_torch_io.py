"""The port's host-side I/O against the JAX package's: y4m decode and
encode, PNG encoding and writing on every path, the PSNR records, the
frame prefetcher, the needle diagram, and the native runtime built by g++.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import gme_tpu.io.draw as jdraw
import gme_tpu.io.video as jvideo
import gme_tpu.io.writers as jwriters
import gme_tpu_torch.io.draw as tdraw
import gme_tpu_torch.io.video as tvideo
import gme_tpu_torch.io.writers as twriters
from gme_tpu_torch.native import loader

cv2 = pytest.importorskip("cv2")

CHROMA = {  # bytes of chroma per frame, as a function of (H, W)
    "420jpeg": lambda h, w: 2 * (w // 2) * (h // 2),
    "422": lambda h, w: 2 * (w // 2) * h,
    "444": lambda h, w: 2 * h * w,
    "mono": lambda h, w: 0,
}


def _write_y4m(path, frames, subsampling, rng):
    """A y4m file with random chroma, so a parser that misreads the frame
    size reads chroma as luma."""
    h, w = frames[0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{subsampling}\n".encode())
        for y in frames:
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(rng.randint(0, 256, CHROMA[subsampling](h, w), np.uint8).tobytes())


@pytest.mark.parametrize("subsampling", sorted(CHROMA))
def test_y4m_parse_and_iterate_equal_jax(tmp_path, rng, subsampling):
    frames = [rng.randint(0, 256, (18, 26), np.uint8) for _ in range(4)]
    path = str(tmp_path / "clip.y4m")
    _write_y4m(path, frames, subsampling, rng)
    want = jvideo._parse_y4m(path)
    for got in (tvideo._parse_y4m(path), list(tvideo._iter_y4m(path)),
                list(tvideo.iter_video_frames(path, native=False)),
                tvideo.get_video_frames(path, native=False)):
        assert len(got) == len(want) == 4
        for a, b, orig in zip(got, want, frames):
            assert np.array_equal(a, b) and np.array_equal(a, orig)


def test_write_y4m_bytes_equal_jax(tmp_path, rng):
    frames = [rng.randint(0, 256, (16, 24), np.uint8) for _ in range(3)]
    tvideo.write_y4m(str(tmp_path / "t.y4m"), frames, fps=25)
    jvideo.write_y4m(str(tmp_path / "j.y4m"), frames, fps=25)
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    with pytest.raises(ValueError, match="even"):
        tvideo.write_y4m(str(tmp_path / "odd.y4m"), [np.zeros((3, 4), np.uint8)])


def test_bgr_to_gray_equals_jax_and_cv2(rng):
    frame = rng.randint(0, 256, (32, 48, 3), np.uint8)
    got = tvideo.bgr_to_gray(frame)
    assert np.array_equal(got, jvideo.bgr_to_gray(frame))
    assert np.array_equal(got, cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shape", [(20, 30), (12, 17, 3)])
def test_png_encode_bytes_equal_jax(rng, shape):
    img = rng.randint(0, 256, shape, np.uint8)
    assert twriters._png_encode(img) == jwriters._png_encode(img)


@pytest.mark.parametrize("path_name", ["native", "cv2", "python"])
@pytest.mark.parametrize("shape", [(20, 30), (12, 17, 3)])
def test_write_png_pixels_equal(tmp_path, rng, monkeypatch, path_name, shape):
    """Every writer path decodes to the image, as the JAX writer's file does."""
    img = rng.randint(0, 256, shape, np.uint8)
    jwriters.write_png(str(tmp_path / "j.png"), img)
    out = str(tmp_path / "t.png")
    if path_name == "native":
        if not loader.available():
            pytest.skip(f"native runtime not built here: {loader.build_error()}")
        twriters.write_png(out, img, native=True)
    else:
        monkeypatch.setattr(twriters, "_HAS_CV2", path_name == "cv2")
        twriters.write_png(out, img, native=False)
    flag = cv2.IMREAD_GRAYSCALE if len(shape) == 2 else cv2.IMREAD_COLOR
    got = cv2.imread(out, flag)
    assert np.array_equal(got, img)
    assert np.array_equal(got, cv2.imread(str(tmp_path / "j.png"), flag))


def test_psnr_records_roundtrip_and_reference_format(tmp_path):
    path = str(tmp_path / "psnr_records.json")
    rec = twriters.PSNRRecords(path)
    rec.add(1, 22.5)
    rec.add(2, 24.0)
    rec.flush()
    assert not os.path.exists(path + ".tmp")  # written by an atomic replace
    again = twriters.PSNRRecords(path)
    assert again.records == {"1": 22.5, "2": 24.0}
    assert again.summary() == jwriters.PSNRRecords(path).summary()
    assert again.summary()["count"] == 2 and abs(again.summary()["avg"] - 23.25) < 1e-9

    # The reference's complex-string format (utils.py cmath bug) reads.
    with open(path, "w") as f:
        json.dump({"5": "(22.724+0j)", "6": "(18.5+0j)", "7": 30.0}, f)
    assert twriters.PSNRRecords.load(path) == jwriters.PSNRRecords.load(path)
    assert twriters.PSNRRecords.load(path) == {"5": 22.724, "6": 18.5, "7": 30.0}
    assert twriters.PSNRRecords(str(tmp_path / "none.json")).summary() == {}


def test_frame_prefetcher_propagates_errors(tmp_path):
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOT A VIDEO\n")
    pf = tvideo.FramePrefetcher(str(bad))
    with pytest.raises(ValueError):
        pf.frame(0)


def test_frame_prefetcher_bounded_residency(tmp_path, rng):
    """With max_ahead set, the decoder never holds more than the window past
    the release watermark."""
    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(64)]
    path = str(tmp_path / "long.y4m")
    tvideo.write_y4m(path, frames)
    pf = tvideo.FramePrefetcher(path, max_ahead=8)
    peak = 0
    for i in range(64):
        assert np.array_equal(pf.frame(i), frames[i])
        peak = max(peak, pf.resident())
        pf.release_below(max(0, i - 1))
    assert peak <= 8, f"resident peaked at {peak} > max_ahead=8"
    assert pf.frame(64) is None
    with pytest.raises(RuntimeError):  # a retired frame is an error
        pf.frame(0)


def test_frame_prefetcher_corrupt_tail_keeps_prefix(tmp_path, rng):
    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(4)]
    path = tmp_path / "trunc.y4m"
    tvideo.write_y4m(str(path), frames)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) - 300])  # truncate inside frame 3's Y
    pf = tvideo.FramePrefetcher(str(path))
    for i in range(3):
        assert np.array_equal(pf.frame(i), frames[i])
    with pytest.raises(ValueError):
        pf.frame(3)


def test_frame_prefetcher_decode_seconds(tmp_path, rng):
    """None until the whole decode completes, then a float; close() before
    completion keeps it None."""
    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(6)]
    path = str(tmp_path / "c.y4m")
    tvideo.write_y4m(path, frames)
    pf = tvideo.FramePrefetcher(path)
    assert pf.count() == 6
    assert isinstance(pf.decode_seconds(), float)

    pf2 = tvideo.FramePrefetcher(path, max_ahead=2)
    assert np.array_equal(pf2.frame(0), frames[0])
    pf2.close()
    pf2._thread.join(timeout=5)
    assert not pf2._thread.is_alive()
    assert pf2.decode_seconds() is None


@pytest.mark.parametrize("with_cv2", [True, False])
def test_draw_motion_field_equals_jax(monkeypatch, rng, with_cv2):
    """The needle diagram of an int field and of a float (hierarchical)
    field, through cv2's antialiased arrows or the Bresenham loop."""
    monkeypatch.setattr(jdraw, "_HAS_CV2", with_cv2)
    monkeypatch.setattr(tdraw, "_HAS_CV2", with_cv2)
    frame = rng.randint(0, 256, (64, 80), np.uint8)
    for field in (rng.randint(-20, 21, (4, 5, 2)).astype(np.int16),
                  rng.uniform(-9, 9, (4, 5, 2)).astype(np.float32)):
        got = tdraw.draw_motion_field(frame, field)
        assert got.shape == (64, 80, 3) and got.dtype == np.uint8
        assert np.array_equal(got, jdraw.draw_motion_field(frame, field))


# ---------------------------------------------------------------------------
# The native runtime
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The loader with no library loaded and its build directory in tmp."""
    monkeypatch.setattr(loader, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setattr(loader, "_TRIED", False)
    monkeypatch.setattr(loader, "_ERROR", None)
    return loader


def _needs_toolchain():
    if shutil.which("g++") is None or not any(
            os.path.exists(os.path.join(d, "zlib.h")) for d in ("/usr/include", "/usr/local/include")):
        pytest.skip("g++ or zlib.h is missing")


def test_native_builds_and_decodes_y4m(fresh_loader, tmp_path, rng):
    _needs_toolchain()
    assert fresh_loader.available(), fresh_loader.build_error()
    built = os.listdir(tmp_path / "build")
    assert len(built) == 1 and built[0].startswith("libgme_native_") and built[0].endswith(".so")
    assert fresh_loader.build() == str(tmp_path / "build" / built[0])  # cached
    frames = [rng.randint(0, 256, (18, 26), np.uint8) for _ in range(5)]
    for subsampling in sorted(CHROMA):
        path = str(tmp_path / f"clip_{subsampling}.y4m")
        _write_y4m(path, frames, subsampling, rng)
        want = tvideo._parse_y4m(path)
        for got in (fresh_loader.decode_y4m(path), tvideo.get_video_frames(path, native=True),
                    list(tvideo.iter_video_frames(path, native=True))):
            assert len(got) == 5 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_native_png_pixels_and_async_pool(fresh_loader, tmp_path, rng):
    _needs_toolchain()
    imgs = [rng.randint(0, 256, (21, 34), np.uint8), rng.randint(0, 256, (9, 13, 3), np.uint8)]
    fresh_loader.write_png(str(tmp_path / "g.png"), imgs[0])
    fresh_loader.write_png(str(tmp_path / "c.png"), imgs[1])
    assert np.array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE), imgs[0])
    assert np.array_equal(cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_COLOR), imgs[1])

    pool = fresh_loader.AsyncPNGWriter(2)
    paths = [str(tmp_path / f"a{i}.png") for i in range(12)]
    for i, p in enumerate(paths):
        img = np.full((16, 24), i * 20, np.uint8)
        pool.submit(p, img)
        img[:] = 0  # the pool copied the pixels on submit
    pool.drain()
    for i, p in enumerate(paths):
        assert np.array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), np.full((16, 24), i * 20, np.uint8))
    pool.submit(str(tmp_path / "no_such_dir" / "x.png"), imgs[0])
    with pytest.raises(IOError, match="failed"):  # a failed write surfaces at the drain
        pool.drain()


@pytest.mark.parametrize("shape", [(240, 320, 3), (9, 13, 3), (21, 34)])
def test_native_pool_writes_the_bytes_of_write_png(fresh_loader, tmp_path, rng, shape):
    """The pool encodes a BGR needle (and a gray image) into the bytes
    `write_png` writes, from a copy taken on submit."""
    _needs_toolchain()
    img = rng.randint(0, 256, shape, np.uint8)
    fresh_loader.write_png(str(tmp_path / "sync.png"), img)
    pool = fresh_loader.AsyncPNGWriter(2)
    submitted = img.copy()
    pool.submit(str(tmp_path / "pool.png"), submitted)
    submitted[:] = 0  # the pool copied the pixels on submit
    pool.drain()
    got = (tmp_path / "pool.png").read_bytes()
    assert got == (tmp_path / "sync.png").read_bytes()
    flag = cv2.IMREAD_COLOR if img.ndim == 3 else cv2.IMREAD_GRAYSCALE
    assert np.array_equal(cv2.imread(str(tmp_path / "pool.png"), flag), img)


_POOL_SIZE_SCRIPT = """
import os, sys
from gme_tpu_torch.native import loader
loader._BUILD_DIR = sys.argv[1]
def threads():
    return len(os.listdir("/proc/self/task"))
before = threads()
first = loader.AsyncPNGWriter(5)
started = threads() - before
second = loader.AsyncPNGWriter(9)
print(first.workers, second.workers, started, threads() - before - started)
"""


def test_native_pool_runs_at_the_first_writers_size(fresh_loader, tmp_path):
    """The library starts its pool once a process: the first writer's size
    is the one every writer reports, and a larger one starts no thread."""
    _needs_toolchain()
    fresh_loader.build()
    out = subprocess.run([sys.executable, "-c", _POOL_SIZE_SCRIPT, str(tmp_path / "build")],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5", "5", "5", "0"]


def test_native_true_raises_when_not_built(fresh_loader, monkeypatch, tmp_path, rng):
    """Without g++ the library is unavailable: the default paths take the
    Python fallbacks, and native=True raises and never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not fresh_loader.available()
    assert "g++" in fresh_loader.build_error()
    assert not (tmp_path / "build").exists()
    frames = [rng.randint(0, 256, (16, 16), np.uint8) for _ in range(3)]
    path = str(tmp_path / "n.y4m")
    tvideo.write_y4m(path, frames)
    assert all(np.array_equal(a, b) for a, b in zip(tvideo.get_video_frames(path), frames))
    with pytest.raises(RuntimeError, match="native=True"):
        list(tvideo.iter_video_frames(path, native=True))
    with pytest.raises(RuntimeError, match="native=True"):
        tvideo.get_video_frames(path, native=True)
    with pytest.raises(RuntimeError, match="not available"):
        twriters.write_png(str(tmp_path / "x.png"), frames[0], native=True)
    with pytest.raises(RuntimeError, match="not available"):
        fresh_loader.AsyncPNGWriter(2)
    twriters.write_png(str(tmp_path / "y.png"), frames[0])  # cv2 or Python
    assert np.array_equal(cv2.imread(str(tmp_path / "y.png"), cv2.IMREAD_GRAYSCALE), frames[0])
