"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode, on the shapes of
tests/test_pallas.py and tests/test_warp.py.  Every output is an integer
(held in float32 for the volumes), so every comparison is exact.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them to these plain versions there.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gme_tpu.config import MAE, MSE
from gme_tpu.ops import bbme as jbbme
from gme_tpu.ops import pallas_kernels as pk
from gme_tpu_torch.ops import cuda_kernels as K
from gme_tpu_torch.ops import bbme as tbbme

# (bs, Hc, Wc, D) of tests/test_pallas.py that the JAX dispatch sends to the
# planes kernel (#1) and to the Hankel kernel (#2, MSE only).
PLANES_SHAPES = [(2, 16, 24, 9), (4, 24, 32, 13), (2, 36, 64, 33), (4, 52, 68, 11)]
HANKEL_SHAPES = [(8, 32, 40, 9), (16, 48, 80, 9), (16, 32, 48, 33), (8, 40, 56, 17),
                 (12, 36, 60, 21)]


def _volume_case(rng, bs, Hc, Wc, D):
    prev = rng.randint(0, 256, (Hc, Wc)).astype(np.uint8)
    cpad = rng.randint(0, 256, (Hc + D - 1, Wc + D - 1)).astype(np.uint8)
    return prev, cpad


def _pallas_volume(prev, cpad, bs, D, pnorm):
    """(nbh, nbw, D*D): the Pallas (D, D, nbh, nbw) volume in the port's
    layout."""
    vol = np.asarray(pk.dfd_cost_volume(
        jnp.asarray(prev, jnp.float32), jnp.asarray(cpad, jnp.float32), bs, D,
        pnorm, interpret=True))
    return vol.transpose(2, 3, 0, 1).reshape(vol.shape[2], vol.shape[3], D * D)


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("bs,Hc,Wc,D", PLANES_SHAPES)
def test_cost_volume_small_block_matches_planes_kernel(rng, pnorm, bs, Hc, Wc, D):
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    got = K.cost_volume_small_block(
        torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None], bs, D, pnorm)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), _pallas_volume(prev, cpad, bs, D, pnorm))


@pytest.mark.parametrize("bs,Hc,Wc,D", HANKEL_SHAPES)
def test_cost_volume_mse_block_matches_hankel_kernel(rng, bs, Hc, Wc, D):
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    got = K.cost_volume_mse_block(
        torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None], bs, D)
    np.testing.assert_array_equal(got[0].numpy(), _pallas_volume(prev, cpad, bs, D, MSE))


def test_cost_volume_is_batched(rng):
    """A batch is one call: each pair's slice equals its own call."""
    bs, Hc, Wc, D = 2, 12, 20, 9
    cases = [_volume_case(rng, bs, Hc, Wc, D) for _ in range(3)]
    prev = torch.from_numpy(np.stack([c[0] for c in cases]))
    cpad = torch.from_numpy(np.stack([c[1] for c in cases]))
    batched = K.cost_volume_small_block(prev, cpad, bs, D, MSE)
    for i in range(3):
        single = K.cost_volume_small_block(prev[i:i + 1], cpad[i:i + 1], bs, D, MSE)
        assert torch.equal(batched[i], single[0])


def _chase_case(rng, shift):
    """The case of tests/test_pallas.py::test_chase_kernel_matches_
    sequential_oracle: a real rank map of a shifted random frame."""
    H, W, bs, R = 48, 64, 8, 5
    D = 2 * R + 1
    base = rng.randint(0, 256, (H + shift, W + shift), np.uint8)
    prev, curr = jnp.asarray(base[:H, :W]), jnp.asarray(base[shift:, shift:])
    nbh, nbw = H // bs, W // bs
    origins = jbbme._block_origins(nbh, nbw, bs)
    vol = jbbme.compute_cost_volume(prev, curr, bs, R, MSE)
    rank = np.array(jbbme._succ_map(vol, origins, H, W, bs, R)).reshape(nbh * nbw, D * D)
    og = np.asarray(origins).reshape(-1, 2)
    bounds = np.stack([-og[:, 0], (H - bs - 1) - og[:, 0],
                       -og[:, 1], (W - bs - 1) - og[:, 1]], axis=1).astype(np.int32)
    return rank, bounds, D, R


@pytest.mark.parametrize("shift", [2, 9])  # 9 > R: ring visits and clamps
def test_chase_fixpoint_matches_chase_kernel(rng, shift):
    rank, bounds, D, R = _chase_case(rng, shift)
    jb = np.concatenate([bounds, np.zeros_like(bounds)], axis=1)  # (C, 8)
    want_o, want_t = pk.chase_fixpoint(
        jnp.asarray(rank), jnp.asarray(jb), D, R, 4096, interpret=True)
    got_o, got_t = K.chase_fixpoint(
        torch.from_numpy(rank), torch.from_numpy(bounds), D, R, 4096)
    assert got_o.dtype == torch.int32 and got_t.dtype == torch.bool
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    if shift == 9:
        assert got_t.any()


def test_chase_fixpoint_stops_at_max_iters(rng):
    """A walk cut by max_iters stops where the lockstep loop stops."""
    rank, bounds, D, R = _chase_case(rng, 9)
    jb = np.concatenate([bounds, np.zeros_like(bounds)], axis=1)
    for iters in (1, 2):
        want_o, want_t = pk.chase_fixpoint(
            jnp.asarray(rank), jnp.asarray(jb), D, R, iters, interpret=True)
        got_o, got_t = K.chase_fixpoint(
            torch.from_numpy(rank), torch.from_numpy(bounds), D, R, iters)
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize(
    "shape,bs", [((64, 96), 16), ((48, 80), 16), ((30, 44), 4), ((33, 47), 8)])
def test_warp_block_field_matches_warp_kernel(rng, shape, bs):
    H, W = shape
    nbh, nbw = H // bs, W // bs
    f = rng.randint(0, 256, (H, W), np.uint8)
    d = rng.randint(-20, 21, (nbh, nbw, 2)).astype(np.int32)
    want = np.asarray(pk.warp_block_field(jnp.asarray(f), jnp.asarray(d), bs, interpret=True))
    got = K.warp_block_field(torch.from_numpy(f)[None], torch.from_numpy(d)[None], bs)
    assert got.dtype == torch.uint8 and got.shape == (1, nbh * bs, nbw * bs)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_warp_block_field_batched(rng):
    """The batched form: one call over three (frame, field) pairs equals the
    vmapped Pallas kernel (tests/test_warp.py::test_warp_pallas_kernel_batched)."""
    H, W, bs = 32, 48, 8
    nbh, nbw = H // bs, W // bs
    fb = rng.randint(0, 256, (3, H, W), np.uint8)
    db = rng.randint(-10, 11, (3, nbh, nbw, 2)).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda f, d: pk.warp_block_field(f, d, bs, interpret=True))(
            jnp.asarray(fb), jnp.asarray(db)))
    got = K.warp_block_field(torch.from_numpy(fb), torch.from_numpy(db), bs)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pnorm,bs,Hc,Wc,D", [
    (MAE, 16, 32, 48, 9),   # MAE at bs >= 8: row-offset kernel
    (MSE, 4, 24, 24, 7),    # D < 8: row-offset kernel
    (MAE, 8, 32, 40, 9),
])
def test_rowoffset_shapes_raise(pnorm, bs, Hc, Wc, D):
    """Shapes the JAX dispatch sends to `_cost_volume_kernel` (ROADMAP B5)
    raise instead of running a kernel the port does not have."""
    prev = torch.zeros((1, Hc, Wc), dtype=torch.uint8)
    cpad = torch.zeros((1, Hc + D - 1, Wc + D - 1), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="B5"):
        tbbme._dfd_cost_volume(prev, cpad, bs, D, pnorm)


def test_cross_volume_shapes_raise():
    """MSE at bs=16 with bs + D - 1 > 128 (R >= 57) needs
    `_cross_volume_kernel` (ROADMAP B6)."""
    bs, D = 16, 115
    prev = torch.zeros((1, 32, 32), dtype=torch.uint8)
    cpad = torch.zeros((1, 32 + D - 1, 32 + D - 1), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="B6"):
        tbbme._dfd_cost_volume(prev, cpad, bs, D, MSE)


def test_wrappers_check_inputs():
    prev = torch.zeros((1, 16, 16), dtype=torch.uint8)
    cpad = torch.zeros((1, 24, 24), dtype=torch.uint8)
    with pytest.raises(ValueError, match="dtype"):
        K.cost_volume_small_block(prev.float(), cpad, 2, 9, MSE)
    with pytest.raises(ValueError, match="shape"):
        K.cost_volume_small_block(prev, cpad[:, :-1], 2, 9, MSE)
    with pytest.raises(ValueError, match="contiguous"):
        K.cost_volume_small_block(prev, cpad.transpose(1, 2), 2, 9, MSE)
    with pytest.raises(ValueError, match="takes"):
        K.cost_volume_mse_block(prev, cpad, 2, 9)
    with pytest.raises(ValueError, match="device"):
        K.warp_block_field(torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta"),
                           torch.zeros((1, 2, 2, 2), dtype=torch.int32, device="meta"), 8)
