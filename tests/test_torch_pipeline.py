"""The ported per-pair step as a whole against the JAX package.

`gme_tpu_torch.gme_pipeline_batch` on the CPU against JAX
`gme_pipeline_batch(..., GMEConfig(search_impl="volume"))`, every output
key: integer outputs exactly, parameters to 1e-5 (ROADMAP queue C: XLA's
FMA contraction), PSNR to 1e-4 dB.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from conftest import synth_pair
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models.gme import gme_pipeline_batch as jax_pipeline_batch
import gme_tpu_torch
from gme_tpu_torch.config import GMEConfig

PAN240_PAIRS = [(10, 11), (60, 61), (150, 151)]
INT_KEYS = ("model_motion_field", "compensated", "diff_curr_prev",
            "diff_curr_comp", "volume_edge_hits")


def _smooth_frame(rng, H, W):
    """tests/test_bbme.py's low-pass texture: walks travel on it."""
    low = rng.randint(0, 256, (H // 4, W // 4)).astype(np.float32)
    img = np.kron(low, np.ones((4, 4), np.float32))
    for _ in range(2):
        img = (np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 1) + 4 * img) / 8.0
    return img.astype(np.uint8)


def _run_both(prev, curr, jax_cfg):
    want = jax_pipeline_batch(jnp.asarray(prev), jnp.asarray(curr), jax_cfg)
    want = {k: np.asarray(v) for k, v in want.items()}
    cfg = GMEConfig.from_dict(dataclasses.asdict(jax_cfg))
    got = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr), cfg)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in INT_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["parameters"].dtype == np.float32
    np.testing.assert_allclose(got["parameters"], want["parameters"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    return got


@pytest.mark.parametrize("fast", [False, True])
def test_pipeline_matches_jax_volume_engine(fast):
    """tests/test_bbme.py's two-pair batch: a 64x64 smooth frame rolled by
    (16, 16) and by (2, 2).  Under the fast radii the big shift's walks
    reach the volume edge (ring visits and clamps)."""
    rng = np.random.RandomState(0)
    prev = _smooth_frame(rng, 64, 64)
    prev_b = np.stack([prev, prev])
    curr_b = np.stack([np.roll(prev, (16, 16), (0, 1)), np.roll(prev, (2, 2), (0, 1))])
    cfg = JaxGMEConfig(search_impl="volume")
    got = _run_both(prev_b, curr_b, cfg.fast() if fast else cfg)
    if fast:
        assert got["volume_edge_hits"][0] > 0 and got["volume_edge_hits"][1] == 0


def test_pipeline_matches_jax_on_synthetic_pairs():
    """Three noisy translating pairs at a size that is no multiple of 16:
    the block crop and the uncovered remainder rows and columns."""
    rng = np.random.RandomState(5)
    pairs = [synth_pair(rng, 100, 150, shift=s) for s in ((2, -3), (0, 5), (-4, 1))]
    prev = np.stack([p for p, _ in pairs])
    curr = np.stack([c for _, c in pairs])
    _run_both(prev, curr, JaxGMEConfig(search_impl="volume"))


def test_pipeline_matches_pan240_goldens(goldens):
    """The three pan240 golden pairs as one batch: against JAX (integers
    exactly), and against the reference within the JAX tests' own
    tolerances (tests/test_models.py: params < 5e-3, <= 2% of field cells,
    PSNR < 0.2 dB)."""
    g = goldens("pan240_pipeline.npz")
    prev = np.stack([g[f"prev_{a}_{b}"] for a, b in PAN240_PAIRS])
    curr = np.stack([g[f"curr_{a}_{b}"] for a, b in PAN240_PAIRS])
    got = _run_both(prev, curr, JaxGMEConfig(search_impl="volume"))
    for i, (a, b) in enumerate(PAN240_PAIRS):
        assert np.abs(got["parameters"][i] - g[f"params_{a}_{b}"]).max() < 5e-3
        assert (got["model_motion_field"][i] != g[f"mf_{a}_{b}"]).any(-1).mean() <= 0.02
        assert abs(float(got["psnr"][i]) - float(g[f"psnr_{a}_{b}"])) < 0.2


def test_pipeline_step_is_one_pair_of_the_batch(rng):
    prev, curr = synth_pair(rng, 64, 80)
    step = gme_tpu_torch.gme_pipeline_step(torch.from_numpy(prev), torch.from_numpy(curr))
    batch = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(prev)[None], torch.from_numpy(curr)[None])
    for k in batch:
        assert torch.equal(step[k], batch[k][0]), k
