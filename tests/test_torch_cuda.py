"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they skip wherever no CUDA device is present.  This file
imports no `jax`, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Shapes are small and odd on purpose (ragged tiles, frame edges, clamps); the
main-path shapes are exercised by chip_smoke.py.  Every kernel output is
an integer, so every kernel comparison is `torch.equal`.
"""

import numpy as np
import pytest
import torch

from gme_tpu_torch.config import MAE, MSE, GMEConfig
from gme_tpu_torch.models.gme import gme_pipeline_batch
from gme_tpu_torch.ops import bbme
from gme_tpu_torch.ops import cuda_kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u8(rng, *shape):
    return torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("bs,Hc,Wc,D", [
    (2, 16, 24, 9), (4, 24, 32, 13), (2, 36, 64, 33), (4, 52, 68, 11),
    (2, 38, 130, 33), (1, 9, 17, 8), (4, 64, 64, 65),
])
def test_cost_volume_small_block(cuda, pnorm, bs, Hc, Wc, D):
    rng = np.random.RandomState(bs * 1000 + D)
    prev, cpad = _u8(rng, 3, Hc, Wc), _u8(rng, 3, Hc + D - 1, Wc + D - 1)
    want = K.cost_volume_plain(prev, cpad, bs, D, pnorm)
    got = K.cost_volume_small_block(prev.to(cuda), cpad.to(cuda), bs, D, pnorm)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bs,Hc,Wc,D", [
    (8, 32, 40, 9), (16, 48, 80, 9), (16, 32, 48, 33), (8, 40, 56, 17),
    (12, 36, 60, 21), (16, 48, 64, 65), (16, 32, 32, 113),
])
def test_cost_volume_mse_block(cuda, bs, Hc, Wc, D):
    rng = np.random.RandomState(bs * 1000 + D)
    prev, cpad = _u8(rng, 2, Hc, Wc), _u8(rng, 2, Hc + D - 1, Wc + D - 1)
    want = K.cost_volume_plain(prev, cpad, bs, D, MSE)
    got = K.cost_volume_mse_block(prev.to(cuda), cpad.to(cuda), bs, D)
    assert torch.equal(got.cpu(), want)


def test_cost_volume_largest_block_sum(cuda):
    """The largest exact SSD, 16*16*255**2, survives the float32 store."""
    bs, D = 16, 9
    prev = torch.zeros((1, 16, 16), dtype=torch.uint8)
    cpad = torch.full((1, 16 + D - 1, 16 + D - 1), 255, dtype=torch.uint8)
    got = K.cost_volume_mse_block(prev.to(cuda), cpad.to(cuda), bs, D)
    assert float(got.max()) == 16 * 16 * 255 ** 2


@pytest.mark.parametrize("H,W,bs,R,shift", [(48, 64, 8, 5, 9), (60, 80, 2, 16, 3), (64, 96, 16, 32, 20)])
def test_chase_fixpoint(cuda, H, W, bs, R, shift):
    rng = np.random.RandomState(shift)
    base = rng.randint(0, 256, (2, H + shift, W + shift)).astype(np.uint8)
    prev = torch.from_numpy(base[:, :H, :W].copy())
    curr = torch.from_numpy(base[:, shift:, shift:].copy())
    D = 2 * R + 1
    vol = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
    origins = bbme._block_origins(H // bs, W // bs, bs, "cpu")
    rank = bbme._succ_map_packed(vol, origins, H, W, bs, R).reshape(-1, D * D)
    og = origins.expand(vol.shape[:-1] + (2,)).reshape(-1, 2)
    bounds = torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                         dim=1).to(torch.int32).contiguous()
    for iters in (1, 3, 4096):
        want_o, want_t = K.chase_fixpoint_plain(rank, bounds, D, R, iters)
        got_o, got_t = K.chase_fixpoint(rank.to(cuda), bounds.to(cuda), D, R, iters)
        assert torch.equal(got_o.cpu(), want_o) and torch.equal(got_t.cpu(), want_t)


@pytest.mark.parametrize("H,W,bs", [(64, 96, 16), (33, 47, 8), (30, 44, 4), (720, 1280, 16)])
def test_warp_block_field(cuda, H, W, bs):
    rng = np.random.RandomState(H)
    nbh, nbw = H // bs, W // bs
    f = _u8(rng, 3, H, W)
    d = torch.from_numpy(rng.randint(-40, 41, (3, nbh, nbw, 2)).astype(np.int32))
    want = K.warp_block_field_plain(f, d, bs)
    got = K.warp_block_field(f.to(cuda), d.to(cuda), bs)
    assert torch.equal(got.cpu(), want)


def test_launch_counts_and_pipeline_equal_cpu(cuda):
    """The whole step on the card equals the same step on the CPU, and went
    through every kernel."""
    rng = np.random.RandomState(0)
    low = rng.randint(0, 256, (2, 25, 38)).astype(np.float32)
    img = np.kron(low, np.ones((1, 4, 4), np.float32))[:, :100, :150]
    prev = img.astype(np.uint8)
    curr = np.roll(prev, (3, -5), (1, 2))
    cfg = GMEConfig()
    want = gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr), cfg)
    K.reset_launch_counts()
    got = gme_pipeline_batch(torch.from_numpy(prev).to(cuda), torch.from_numpy(curr).to(cuda), cfg)
    assert all(n > 0 for n in K.LAUNCHES.values()), K.LAUNCHES
    for k in want:
        if k == "psnr":  # a float32 mean over > 2**24: reduction order moves the last bits
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k
