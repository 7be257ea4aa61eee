"""The PNG reader against the port's encoder (filter none) and OpenCV's
(adaptive filters), and the pruning of a call's PNGs to its sample."""

import numpy as np
import pytest

from benchmark.clips import synthetic_pan
from benchmark.png import read_png


def images():
    g = synthetic_pan(1, 37, 53, (0, 0), 5)[0]
    rgb = np.stack([g, 255 - g, np.roll(g, 3, axis=1)], axis=-1)
    return g, rgb


def test_reads_the_ports_encoder(tmp_path):
    from gme_tpu_torch.io.writers import _png_encode

    g, bgr = images()
    for name, img, want in (("g", g, g), ("c", bgr, bgr[..., ::-1])):
        path = tmp_path / f"{name}.png"
        path.write_bytes(_png_encode(img))
        assert np.array_equal(read_png(str(path)), want)


def test_reads_every_filter(tmp_path):
    cv2 = pytest.importorskip("cv2")
    g, bgr = images()
    noisy = np.random.default_rng(1).integers(0, 256, (29, 31), dtype=np.uint8)
    for name, img, want in (("g", g, g), ("n", noisy, noisy), ("c", bgr, bgr[..., ::-1])):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        assert np.array_equal(read_png(path), want)


def test_prune_keeps_only_the_sampled_pairs(tmp_path):
    """A call's PNGs after pruning: the five of each kept pair, no other;
    the sample is drawn from the seed and the call's index alone."""
    from benchmark import run

    keep = run.image_sample(3_000_000_123, 4, 206, 1, 1)
    assert keep == run.image_sample(3_000_000_123, 4, 206, 1, 1)
    assert len(keep) == 1 and 1 <= keep[0] <= 206
    assert {tuple(run.image_sample(7, k, 206, 1, 1)) for k in range(8)} != {tuple(keep)}
    for s in run.IMAGE_STREAMS:
        (tmp_path / s).mkdir()
        for i in range(1, 207):
            name = i - 5 if s in ("frames", "compensated") else i
            (tmp_path / s / f"{name}.png").write_bytes(b"x")
    (tmp_path / "psnr_records.json").write_text("{}")
    run.prune_images(str(tmp_path), keep, 1)
    left = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.png"))
    i = keep[0]
    assert left == sorted([f"frames/{i - 5}.png", f"compensated/{i - 5}.png",
                           f"curr_prev_diff/{i}.png", f"curr_comp_diff/{i}.png",
                           f"model_motion_field/{i}.png"])
    assert (tmp_path / "psnr_records.json").exists()
