"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they skip wherever no CUDA device is present.  This file
imports no `jax`, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Shapes are small and odd on purpose (ragged tiles, frame edges, clamps); the
main-path shapes are exercised by chip_smoke.py.  Every kernel output is
an integer, so every kernel comparison is `torch.equal`.
"""

import json
import os

import numpy as np
import pytest
import torch

from gme_tpu_torch.config import DIAMOND, MAE, MSE, GMEConfig, PipelineConfig
from gme_tpu_torch.io.video import write_y4m
from gme_tpu_torch.models.gme import gme_pipeline_batch, gme_pipeline_batch_adaptive
from gme_tpu_torch.models.hierarchical_bbme import hierarchical_wrapper
from gme_tpu_torch.ops import bbme
from gme_tpu_torch.ops import cuda_kernels as K
from gme_tpu_torch.pipeline.results import process_video
from gme_tpu_torch.utils import compiled

DEFAULT_PATH_KERNELS = ("cost_volume_small_block", "cost_volume_mse_block",
                        "chase_volume", "warp_block_field")

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


def _volume_frames(kind, rng, B, Hc, Wc, D):
    """uint8 prev (B, Hc, Wc) and curr_pad: random, constant, or random
    pixels of 0 and 255 (the extreme differences)."""
    shapes = ((B, Hc, Wc), (B, Hc + D - 1, Wc + D - 1))
    if kind == "constant":
        return tuple(torch.full(s, v, dtype=torch.uint8) for s, v in zip(shapes, (77, 200)))
    if kind == "extreme":
        return tuple(torch.from_numpy((rng.randint(0, 2, s) * 255).astype(np.uint8)) for s in shapes)
    return tuple(_u8(rng, *s) for s in shapes)


FRAME_KINDS = ["random", "constant", "extreme"]


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("D", [8, 9, 17, 25, 65, None])  # None: bs + D - 1 = 128
@pytest.mark.parametrize("bs", [8, 10, 12, 13, 16])
def test_cost_volume_mse_block_tensor_core_layout(cuda, bs, D, kind):
    """The u8 tensor-core kernel on 2 x 7 cells (7: no tile width divides
    it), B 3 (B 1 for constant frames), bit for bit against the plain MSE."""
    D = 129 - bs if D is None else D
    rng = np.random.RandomState(bs * 1000 + D)
    B = 1 if kind == "constant" else 3
    prev, cpad = (t.to(cuda) for t in _volume_frames(kind, rng, B, 2 * bs, 7 * bs, D))
    want = K.cost_volume_plain(prev, cpad, bs, D, MSE)
    got = K.cost_volume_mse_block(prev, cpad, bs, D)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("D", [8, 17, 33, 65])
@pytest.mark.parametrize("bs", [1, 2, 4])
def test_cost_volume_small_block_vector_stores(cuda, bs, D, pnorm, kind):
    """The four-outputs-a-thread kernel on 3 x 131 cells (131: ragged runs
    of cells for every T), B 3 (B 1 for constant frames), bit for bit
    against the plain volume."""
    rng = np.random.RandomState(bs * 1000 + D * 10 + pnorm)
    B = 1 if kind == "constant" else 3
    prev, cpad = (t.to(cuda) for t in _volume_frames(kind, rng, B, 3 * bs, 131 * bs, D))
    want = K.cost_volume_plain(prev, cpad, bs, D, pnorm)
    got = K.cost_volume_small_block(prev, cpad, bs, D, pnorm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("bs,D", [(1, 257), (2, 129), (2, 241), (4, 129)])
def test_cost_volume_small_block_offset_row_bands(cuda, bs, D, pnorm):
    """Above 8192 outputs a cell, CUDA blocks take bands of offset rows."""
    rng = np.random.RandomState(bs * 1000 + D)
    prev, cpad = (t.to(cuda) for t in _volume_frames("random", rng, 2, 2 * bs, 5 * bs, D))
    want = K.cost_volume_plain(prev, cpad, bs, D, pnorm)
    assert torch.equal(K.cost_volume_small_block(prev, cpad, bs, D, pnorm), want)


# (bs, Hc, Wc, D): bs 1, odd bs, D < 8, D over several 16-offset tiles with
# a ragged last tile, MSE bs 20 (sums above 2**24), partial cell tiles; then
# runs of cells that no cell-run width divides (106 cells of bs 12 at D 51,
# the three-step's row; 129 of bs 7), D over two bands of offset-column
# tiles (D 130 at bs 3), and bs 32 and 33 either side of the packed tiles.
ROWOFFSET_SHAPES = [
    (1, 9, 17, 5), (3, 21, 33, 7), (2, 36, 64, 6), (12, 48, 84, 51),
    (8, 40, 56, 9), (5, 25, 45, 37), (20, 40, 60, 21), (16, 32, 48, 3),
    (12, 24, 1272, 51), (7, 14, 903, 9), (3, 6, 120, 130), (32, 64, 96, 13),
    (33, 66, 99, 6),
]


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("bs,Hc,Wc,D", ROWOFFSET_SHAPES)
def test_cost_volume_rowoffset(cuda, pnorm, bs, Hc, Wc, D):
    rng = np.random.RandomState(bs * 1000 + D)
    prev, cpad = _u8(rng, 3, Hc, Wc), _u8(rng, 3, Hc + D - 1, Wc + D - 1)
    want = K.cost_volume_plain(prev, cpad, bs, D, pnorm)
    got = K.cost_volume_rowoffset(prev.to(cuda), cpad.to(cuda), bs, D, pnorm)
    assert torch.equal(got.cpu(), want)


# Every bs % 4 residue on each route of the row-offset kernel: the small-block
# body (bs 1, 2), the packed register tiles (3 .. 24; 1 to 6 words a block row,
# a masked tail word wherever bs % 4 != 0) and the byte-staged tiles (33).
PACKED_BS = [1, 2, 3, 5, 6, 7, 9, 12, 13, 20, 24, 33]
# D below, at and above the 4 x 4 register tile, and not a multiple of it.
PACKED_D = [1, 2, 5, 6, 28, 51, 65]


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("D", PACKED_D)
@pytest.mark.parametrize("bs", PACKED_BS)
def test_cost_volume_rowoffset_packed_tiles(cuda, bs, D, pnorm, kind):
    """The packed-word routes on 2 x 7 cells (7: no run of cells divides
    it), B 2 (B 1 for constant frames), bit for bit against the plain
    volume."""
    rng = np.random.RandomState(bs * 1000 + D * 10 + pnorm)
    B = 1 if kind == "constant" else 2
    prev, cpad = (t.to(cuda) for t in _volume_frames(kind, rng, B, 2 * bs, 7 * bs, D))
    want = K.cost_volume_plain(prev, cpad, bs, D, pnorm)
    assert torch.equal(K.cost_volume_rowoffset(prev, cpad, bs, D, pnorm), want)


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("D", [1, 6, 28, 65])
@pytest.mark.parametrize("bs", [1, 2, 3, 4, 5, 6, 7, 17, 20, 33])
def test_cost_volume_cross_tile_routes(cuda, bs, D, kind):
    """The cross kernel outside bs 8..16 runs the row-offset kernel's packed
    routes: the cross term at every such bs, and SSD mode (the direct MSE)
    below bs 8, each bit for bit against its plain version."""
    rng = np.random.RandomState(bs * 1000 + D)
    B = 1 if kind == "constant" else 2
    prev, cpad = (t.to(cuda) for t in _volume_frames(kind, rng, B, 2 * bs, 5 * bs, D))
    assert torch.equal(K.cost_volume_cross(prev, cpad, bs, D),
                       K.cost_volume_cross_plain(prev, cpad, bs, D))
    if bs < 8:
        ssd = K.cost_volume_cross(prev, cpad, bs, D, ssd=True)
        assert torch.equal(ssd, K.cost_volume_cross_plain(prev, cpad, bs, D, True))
        assert torch.equal(ssd, K.cost_volume_plain(prev, cpad, bs, D, MSE))


@pytest.mark.parametrize("bs,Hc,Wc,D", [
    (16, 32, 48, 115), (16, 48, 64, 129), (8, 24, 40, 125), (1, 7, 9, 4), (20, 40, 40, 17),
])
def test_cost_volume_cross(cuda, bs, Hc, Wc, D):
    rng = np.random.RandomState(bs * 1000 + D)
    prev, cpad = _u8(rng, 2, Hc, Wc), _u8(rng, 2, Hc + D - 1, Wc + D - 1)
    want = K.cost_volume_cross_plain(prev, cpad, bs, D)
    got = K.cost_volume_cross(prev.to(cuda), cpad.to(cuda), bs, D)
    assert torch.equal(got.cpu(), want)
    if bs <= 16:  # the decomposed MSE equals the direct one
        direct = K.cost_volume_plain(prev, cpad, bs, D, MSE)
        decomp = bbme._dfd_cost_volume_mse_decomp(prev.to(cuda), cpad.to(cuda), bs, D)
        assert torch.equal(decomp.cpu(), direct)


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("ssd", [False, True])
@pytest.mark.parametrize("bs", range(8, 17))
def test_cost_volume_cross_bands(cuda, bs, ssd, kind):
    """The u8 tensor-core kernel in bands of offset rows at every bs
    template, D = 145 - bs (bs + D - 1 = 144 > 128; 3 or 4 bands, some
    short), on 2 x 5 cells, B 3 (B 1 for constant frames), bit for bit
    against its plain version; in SSD mode also against the direct MSE."""
    D = 145 - bs
    rng = np.random.RandomState(bs * 1000 + D + ssd)
    B = 1 if kind == "constant" else 3
    prev, cpad = (t.to(cuda) for t in _volume_frames(kind, rng, B, 2 * bs, 5 * bs, D))
    got = K.cost_volume_cross(prev, cpad, bs, D, ssd=ssd)
    assert torch.equal(got, K.cost_volume_cross_plain(prev, cpad, bs, D, ssd))
    if ssd:
        assert torch.equal(got, K.cost_volume_plain(prev, cpad, bs, D, MSE))
        assert torch.equal(got, K.cost_volume_rowoffset(prev, cpad, bs, D, MSE))


@pytest.mark.parametrize("B,nbh,nbw", [(1, 3, 7), (3, 2, 5)])
@pytest.mark.parametrize("D", [1, 5, 8, 9, 17, 33, 65, 100, 128])
@pytest.mark.parametrize("bs", [8, 11, 16])
def test_cost_volume_cross_small_windows(cuda, bs, D, B, nbh, nbw):
    """The tensor-core kernel where the window fits one band (D 1 to 128),
    on ragged cell counts, in both modes."""
    rng = np.random.RandomState(bs * 1000 + D * 10 + B)
    prev, cpad = (t.to(cuda) for t in _volume_frames("random", rng, B, nbh * bs, nbw * bs, D))
    assert torch.equal(K.cost_volume_cross(prev, cpad, bs, D),
                       K.cost_volume_cross_plain(prev, cpad, bs, D))
    assert torch.equal(K.cost_volume_cross(prev, cpad, bs, D, ssd=True),
                       K.cost_volume_plain(prev, cpad, bs, D, MSE))


@pytest.mark.parametrize("bs,D", [(8, 129), (16, 129), (16, 113)])
def test_cost_volume_cross_extremes(cuda, bs, D):
    """All-0 prev blocks against all-255 windows, and the reverse: the SSD
    is bs^2 * 255^2 everywhere (16,646,400 at bs 16), the cross term 0."""
    for lo, hi in ((0, 255), (255, 0)):
        prev = torch.full((2, 2 * bs, 3 * bs), lo, dtype=torch.uint8, device=cuda)
        cpad = torch.full((2, 2 * bs + D - 1, 3 * bs + D - 1), hi, dtype=torch.uint8, device=cuda)
        ssd = K.cost_volume_cross(prev, cpad, bs, D, ssd=True)
        assert float(ssd.min()) == float(ssd.max()) == bs * bs * 255 ** 2
        assert float(K.cost_volume_cross(prev, cpad, bs, D).abs().max()) == 0


def test_cost_volume_rowoffset_largest_block_sum(cuda):
    """The largest MSE block the int32 sums take, bs 181, in one tile."""
    bs, D = 181, 2
    prev = torch.zeros((1, bs, bs), dtype=torch.uint8)
    cpad = torch.full((1, bs + D - 1, bs + D - 1), 255, dtype=torch.uint8)
    got = K.cost_volume_rowoffset(prev.to(cuda), cpad.to(cuda), bs, D, MSE)
    want = K.cost_volume_plain(prev, cpad, bs, D, MSE)
    assert torch.equal(got.cpu(), want) and float(want.max()) == float(np.float32(bs * bs * 255 ** 2))


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


def _chase_inputs(volume, H, W, bs, R):
    D = 2 * R + 1
    origins = bbme._block_origins(H // bs, W // bs, bs, volume.device)
    og = origins.expand(volume.shape[:-1] + (2,)).reshape(-1, 2)
    bounds = torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                         dim=1).to(torch.int32).contiguous()
    rank = bbme._succ_map(volume, origins, H, W, bs, R).reshape(-1, D * D)
    return volume.reshape(-1, D * D).contiguous(), bounds, rank


def _assert_volume_chase(cuda, volume, H, W, bs, R):
    """The volume chase on the card equals its plain version and the
    rank-map chase, cut at 1, 3 and 4096 steps, on the rule of this bs."""
    D = 2 * R + 1
    vol, bounds, rank = _chase_inputs(volume, H, W, bs, R)
    packed = bbme._packed_rule(bs)
    for iters in (1, 3, 4096):
        want_o, want_t = K.chase_fixpoint_plain(rank, bounds, D, R, iters)
        plain_o, plain_t = K.chase_volume_plain(vol, bounds, D, R, iters, packed)
        assert torch.equal(plain_o, want_o) and torch.equal(plain_t, want_t)
        got_o, got_t = K.chase_volume(vol.to(cuda), bounds.to(cuda), D, R, iters, packed)
        assert torch.equal(got_o.cpu(), want_o) and torch.equal(got_t.cpu(), want_t)


@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("H,W,bs,R,shift", [(48, 64, 8, 5, 9), (60, 80, 2, 16, 3), (64, 96, 16, 32, 20),
                                            (8, 64, 8, 4, 2), (48, 8, 8, 4, 2), (16, 16, 16, 3, 1),
                                            (100, 140, 20, 6, 5), (20, 100, 20, 8, 3),
                                            (96, 128, 16, 64, 7)])
def test_chase_volume(cuda, H, W, bs, R, shift, pnorm):
    """Shifted random frames: ring visits, frame clamps, lo > hi (a frame
    edge of one block), the select chain's rule at bs 20, radius 64."""
    rng = np.random.RandomState(shift * 10 + bs)
    base = rng.randint(0, 256, (2, H + shift, W + shift)).astype(np.uint8)
    prev = torch.from_numpy(base[:, :H, :W].copy())
    curr = torch.from_numpy(base[:, shift:, shift:].copy())
    _assert_volume_chase(cuda, bbme.compute_cost_volume(prev, curr, bs, R, pnorm), H, W, bs, R)


@pytest.mark.parametrize("kind", ["ties", "inf", "big"])
def test_chase_volume_edge_costs(cuda, kind):
    """Exact ties (costs 0..2), cells of +inf, and costs above 2**24 (the
    select chain at bs 20)."""
    bs, H, W, R = (20, 100, 140, 6) if kind == "big" else (8, 48, 64, 5)
    D = 2 * R + 1
    rng = np.random.RandomState(len(kind))
    shape = (2, H // bs, W // bs, D * D)
    if kind == "ties":
        vol = rng.randint(0, 3, shape).astype(np.float32)
    elif kind == "big":
        vol = (rng.randint(2**24, 2**26, shape) & ~3).astype(np.float32)
    else:
        vol = rng.randint(0, 2**24, shape).astype(np.float32)
        vol[:, ::2, 1::2] = np.inf
    _assert_volume_chase(cuda, torch.from_numpy(vol), H, W, bs, R)


def test_chase_volume_720p_level2(cuda):
    """The main path's shape: 24 720p pairs at level 2, 86,400 cells, D 65."""
    rng = np.random.RandomState(0)
    low = rng.randint(0, 256, (2, 181, 321)).astype(np.float32)
    img = np.kron(low, np.ones((1, 4, 4), np.float32))[:, :720, :1280].astype(np.uint8)
    prev = torch.from_numpy(np.repeat(img[:1], 24, 0)).to(cuda)
    curr = torch.roll(prev, (3, 6), (1, 2))
    H, W, bs, R = 720, 1280, 16, 32
    volume = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
    D = 2 * R + 1
    vol, bounds, rank = _chase_inputs(volume, H, W, bs, R)
    for iters in (1, 3, 4096):
        want = K.chase_fixpoint_plain(rank, bounds.to(cuda), D, R, iters)
        got = K.chase_volume(vol, bounds.to(cuda), D, R, iters, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("H,W,bs", [(64, 96, 16), (33, 47, 8), (30, 44, 4), (720, 1280, 16)])
def test_warp_block_field(cuda, H, W, bs):
    rng = np.random.RandomState(H)
    nbh, nbw = H // bs, W // bs
    f = _u8(rng, 3, H, W)
    d = torch.from_numpy(rng.randint(-40, 41, (3, nbh, nbw, 2)).astype(np.int32))
    want = K.warp_block_field_plain(f, d, bs)
    got = K.warp_block_field(f.to(cuda), d.to(cuda), bs)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bs", [4, 8, 12, 16, 5, 20])
@pytest.mark.parametrize("H,W,amp", [(64, 96, 3), (33, 47, 40), (48, 81, 200), (720, 1280, 40)])
def test_warp_block_field_runs(cuda, bs, H, W, amp):
    """The run kernel (bs 4, 8, 12, 16) and the per-byte kernel (other bs):
    in-frame runs at every alignment, runs that clip at either edge or
    leave the frame, ragged frames, and a frame that starts off a 4-byte
    boundary (a view one byte into its buffer)."""
    rng = np.random.RandomState(H + bs)
    nbh, nbw = H // bs, W // bs
    buf = _u8(rng, 2 * H * W + 1)
    f = buf[1:].reshape(2, H, W)
    d = torch.from_numpy(rng.randint(-amp, amp + 1, (2, nbh, nbw, 2)).astype(np.int32))
    want = K.warp_block_field_plain(f.contiguous(), d, bs)
    got = K.warp_block_field(buf.to(cuda)[1:].reshape(2, H, W), d.to(cuda), bs)
    assert torch.equal(got.cpu(), want)
    aligned = K.warp_block_field(f.contiguous().to(cuda), d.to(cuda), bs)
    assert torch.equal(aligned.cpu(), want)


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
    compiled.reset_replay_counts()
    got = gme_pipeline_batch(torch.from_numpy(prev).to(cuda), torch.from_numpy(curr).to(cuda), cfg)
    # The compiled step's first call launches eagerly, later ones by replays.
    launches = _launched()
    assert all(launches[n] > 0 for n in DEFAULT_PATH_KERNELS), launches
    for k in want:
        if k == "psnr":  # a float32 mean over > 2**24: reduction order moves the last bits
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


def _pan_pair(seed, H, W, shift):
    rng = np.random.RandomState(seed)
    low = rng.randint(0, 256, (2, H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = np.kron(low, np.ones((1, 4, 4), np.float32))[:, :H, :W].astype(np.uint8)
    return torch.from_numpy(img), torch.from_numpy(np.roll(img, shift, (1, 2)).copy())


@pytest.mark.parametrize("sp,pnorm,impl", [
    (0, MAE, "auto"), (1, MAE, "volume"), (1, MSE, "gather"), (2, MAE, "volume"),
    (2, MSE, "gather"), (3, MAE, "volume"), (3, MSE, "gather"),
])
def test_get_motion_field_equals_cpu(cuda, sp, pnorm, impl):
    prev, curr = _pan_pair(sp, 72, 120, (3, -5))
    kw = dict(block_size=12, search_window=8, searching_procedure=sp, pnorm_distance=pnorm,
              search_impl=impl, return_diagnostics=True)
    want, wd = bbme.get_motion_field(prev, curr, **kw)
    got, gd = bbme.get_motion_field(prev.to(cuda), curr.to(cuda), **kw)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gd["volume_edge_hits"].cpu(), wd["volume_edge_hits"])


@pytest.mark.parametrize("cfg", [
    GMEConfig(searching_procedure=0), GMEConfig(searching_procedure=1),
    GMEConfig(searching_procedure=2), GMEConfig(volume_radius=64),
    GMEConfig(dense_volume_radius=3),
])
def test_pipeline_configs_equal_cpu(cuda, cfg):
    prev, curr = _pan_pair(1, 100, 150, (4, -6))
    want = gme_pipeline_batch(prev, curr, cfg)
    got = gme_pipeline_batch(prev.to(cuda), curr.to(cuda), cfg)
    for k in want:
        if k == "psnr":
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


def test_hierarchical_wrapper_equals_cpu(cuda):
    prev, curr = _pan_pair(2, 100, 96, (2, 3))
    want = hierarchical_wrapper(prev, curr, searching_procedure=DIAMOND)
    got = hierarchical_wrapper(prev.to(cuda), curr.to(cuda), searching_procedure=DIAMOND)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shift", [(3, -5), (12, 17)])
def test_volume_diamond_bs20_equals_cpu(cuda, shift):
    """The select-chain rank map (bs > 16) on the card equals the CPU."""
    prev, curr = _pan_pair(20, 100, 140, shift)
    kw = dict(block_size=20, searching_procedure=DIAMOND, pnorm_distance=MAE,
              search_impl="volume", volume_radius=8, return_diagnostics=True)
    want, wd = bbme.get_motion_field(prev, curr, **kw)
    got, gd = bbme.get_motion_field(prev.to(cuda), curr.to(cuda), **kw)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gd["volume_edge_hits"].cpu(), wd["volume_edge_hits"])


def _alternating_clip(n=7, H=128, W=160):
    """Panned alternately (2, 3) and (10, 14) px per frame: some pairs
    escape the fast radii, some do not."""
    steps = [(2, 3), (10, 14)] * (n // 2)
    pos = np.cumsum([(0, 0)] + steps[: n - 1], 0)
    last = pos[-1]
    rng = np.random.RandomState(0)
    low = rng.randint(0, 256, ((H + last[0]) // 4 + 1, (W + last[1]) // 4 + 1)).astype(np.float32)
    base = np.kron(low, np.ones((4, 4), np.float32)).astype(np.uint8)
    return np.stack([base[last[0] - p[0]: last[0] - p[0] + H, last[1] - p[1]: last[1] - p[1] + W]
                     for p in pos])


def test_adaptive_equals_default(cuda):
    frames = torch.from_numpy(_alternating_clip()).to(cuda)
    prev, curr = frames[:-1], frames[1:]
    fast = gme_pipeline_batch(prev, curr, GMEConfig().fast())["volume_edge_hits"]
    assert bool((fast > 0).any()) and bool((fast == 0).any()), fast
    got = gme_pipeline_batch_adaptive(prev, curr)
    want = gme_pipeline_batch(prev, curr)
    for k in want:
        if k != "volume_edge_hits":
            assert torch.equal(got[k], want[k]), k


def test_driver_equals_cpu(cuda, tmp_path):
    """process_video on the card writes the CPU run's files: the same PSNR
    records and byte-equal PNGs (one writer, equal pixels)."""
    clip = str(tmp_path / "alt.y4m")
    write_y4m(clip, list(_alternating_clip(n=6)))
    cfg = PipelineConfig(batch_size=2)
    got = process_video(clip, str(tmp_path / "gpu"), cfg, device="cuda")
    want = process_video(clip, str(tmp_path / "cpu"), cfg, device="cpu")
    assert got["pairs_processed"] == want["pairs_processed"] == 5
    assert got["volume_edge_hits"] == want["volume_edge_hits"]
    recs = [json.load(open(tmp_path / d / "alt" / "psnr_records.json")) for d in ("gpu", "cpu")]
    assert sorted(recs[0]) == sorted(recs[1])
    for k in recs[1]:
        assert abs(recs[0][k] - recs[1][k]) <= 1e-4, k
    for stream in ("frames", "compensated", "curr_prev_diff", "curr_comp_diff",
                   "model_motion_field"):
        names = sorted(os.listdir(tmp_path / "cpu" / "alt" / stream))
        assert len(names) == 5 and names == sorted(os.listdir(tmp_path / "gpu" / "alt" / stream))
        for name in names:
            assert ((tmp_path / "gpu" / "alt" / stream / name).read_bytes()
                    == (tmp_path / "cpu" / "alt" / stream / name).read_bytes()), (stream, name)


def test_driver_device_events_and_captures(cuda, tmp_path):
    """The driver's timing events: positive upload, step, copy-out and idle
    seconds, together no more than the call's wall, the idle shared out
    whole among the main thread's stages; a call at a new shape captures
    the step's graph, a second call at that shape captures none."""
    import time

    clip = str(tmp_path / "alt.y4m")
    write_y4m(clip, list(_alternating_clip(n=7)))
    cfg = PipelineConfig(batch_size=4, write_images=False)  # two batches, one padded
    gme_pipeline_batch.clear()
    walls, summaries = [], []
    for name in ("first", "second"):
        t0 = time.perf_counter()
        summaries.append(process_video(clip, str(tmp_path / name), cfg, device="cuda"))
        walls.append(time.perf_counter() - t0)
    for s, wall in zip(summaries, walls):
        d = s["device"]
        for key in ("upload_s", "step_s", "copy_out_s", "idle_s"):
            assert d[key] > 0, (key, d)
        assert d["upload_s"] + d["step_s"] + d["copy_out_s"] + d["idle_s"] <= wall, (d, wall)
        assert sum(d["idle_by_stage_s"].values()) == pytest.approx(d["idle_s"], rel=1e-6)
        assert s["counters"]["slots"] == 8 and s["pairs_processed"] == 6
        assert s["counters"]["h2d_bytes"] == 2 * 8 * 128 * 160
    assert summaries[0]["counters"]["captures"] >= 1
    assert summaries[1]["counters"]["captures"] == 0
    assert (summaries[1]["counters"]["process_capture_s"]
            == summaries[0]["counters"]["process_capture_s"] > 0)


def test_driver_timing_events_of_every_batch(cuda, tmp_path, monkeypatch):
    """Six batches of one pair: every batch reads its own upload, step and
    copy from its own events, and every batch after the first its idle gap
    from the batch before, in the order the batches were dispatched."""
    from gme_tpu_torch.pipeline import results as R

    clip = str(tmp_path / "alt.y4m")
    write_y4m(clip, list(_alternating_clip(n=7)))
    seen = []
    real = R._device_summary

    def keep(rows, *args):
        seen.extend(rows)
        return real(rows, *args)

    monkeypatch.setattr(R, "_device_summary", keep)
    s = process_video(clip, str(tmp_path / "out"), PipelineConfig(batch_size=1, write_images=False),
                      device="cuda")
    assert s["counters"]["slots"] == 6 and len(seen) == 6
    assert seen[0][1] is None and all(r[1] >= 0 for r in seen[1:]), seen
    assert all(r[2] > 0 and r[3] > 0 and r[4] > 0 for r in seen), seen
    assert [r[0] for r in seen] == sorted(r[0] for r in seen)


# ---------------------------------------------------------------------------
# Row bands and meshes on one card (the `devices` list names it per slot)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pnorm", [MAE, MSE])
@pytest.mark.parametrize("bs,R,T,nbw", [(2, 16, 23, 40), (16, 32, 3, 5), (16, 12, 2, 4),
                                        (12, 25, 2, 3), (4, 6, 5, 7)])
def test_cost_volume_band_equals_cpu(cuda, pnorm, bs, R, T, nbw):
    """The band volume of stacked bands (a per-row gb0, rows past the frame)
    through the volume kernels equals the CPU's."""
    rng = np.random.RandomState(bs + R)
    B = 6
    prev = _u8(rng, B, T * bs, nbw * bs)
    curr = _u8(rng, B, T * bs + 2 * R, nbw * bs + 2 * R)
    gb0 = torch.tensor([0, T - 1, 2 * T, 0, T, 3 * T], dtype=torch.int32)
    H, W = 3 * T * bs + bs // 2, nbw * bs + 3
    want = bbme.compute_cost_volume_band(prev, curr, gb0, (H, W), bs, R, pnorm)
    got = bbme.compute_cost_volume_band(prev.to(cuda), curr.to(cuda), gb0.to(cuda), (H, W), bs,
                                        R, pnorm)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("H,W,space,sp", [(96, 84, 4, DIAMOND), (128, 80, 2, DIAMOND),
                                          (96, 84, 4, 0), (96, 84, 4, 1)])
def test_spatial_step_on_one_card_equals_cpu(cuda, H, W, space, sp):
    """The spatial step with its bands on one card: the stacked volume
    kernels and chase give the 1x1 step's outputs, and the CPU's."""
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager
    from gme_tpu_torch.parallel.mesh import make_mesh
    from gme_tpu_torch.parallel.spatial import make_spatial_pipeline, make_spatial_pipeline_eager

    rng = np.random.RandomState(H + space)
    prev = rng.randint(0, 256, (2, H, W)).astype(np.uint8)
    curr = np.stack([np.roll(p, (2, -1), (0, 1)) for p in prev])
    cfg = GMEConfig(search_impl="volume", searching_procedure=sp)
    mesh = make_mesh(2, space, [cuda] * (2 * space))
    p, c = torch.from_numpy(prev).to(cuda), torch.from_numpy(curr).to(cuda)
    K.reset_launch_counts()
    got = make_spatial_pipeline_eager(mesh, cfg, H, W)(p, c)
    banded = dict(K.LAUNCHES)
    K.reset_launch_counts()
    one = gme_pipeline_batch_eager(p, c, cfg)
    # Two data shards, each one launch of each kernel a level.
    assert banded == {k: 2 * v for k, v in K.LAUNCHES.items() if k != "warp_block_field"} | {
        "warp_block_field": 0}, (banded, K.LAUNCHES)
    graphed = make_spatial_pipeline(mesh, cfg, H, W)(p, c)  # every slot one card: compiled
    cpu = make_spatial_pipeline(make_mesh(2, space, ["cpu"] * (2 * space)), cfg, H, W)(
        torch.from_numpy(prev), torch.from_numpy(curr))
    for k in one:
        assert torch.equal(got[k].cpu(), one[k].cpu()), k
        assert torch.equal(graphed[k], got[k]), k
        if k == "psnr":  # log10 on the card and on the CPU may differ by an ulp
            torch.testing.assert_close(got[k].cpu(), cpu[k], rtol=0, atol=1e-4)
        else:
            assert torch.equal(got[k].cpu(), cpu[k]), k


def test_data_parallel_on_one_card_equals_the_batch(cuda):
    from gme_tpu_torch.parallel.data_parallel import make_sharded_pipeline
    from gme_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.RandomState(5)
    prev = rng.randint(0, 256, (4, 64, 80)).astype(np.uint8)
    curr = np.stack([np.roll(p, (1, 3), (0, 1)) for p in prev])
    p, c = torch.from_numpy(prev).to(cuda), torch.from_numpy(curr).to(cuda)
    got = make_sharded_pipeline(make_mesh(2, 1, [cuda] * 2), GMEConfig())(p, c)
    want = gme_pipeline_batch(p, c, GMEConfig())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_direct_warps_equal_cpu(cuda):
    """bilinear_sample, warp_backward and warp_forward on the card equal
    the CPU's bit for bit (huge and NaN parameters too), and a short
    optimisation stays close."""
    from gme_tpu_torch.models import direct

    rng = np.random.RandomState(6)
    img = torch.from_numpy(rng.randint(0, 256, (60, 84)).astype(np.uint8))
    x = torch.from_numpy(rng.rand(700).astype(np.float32) * 100 - 20)
    y = torch.from_numpy(rng.rand(700).astype(np.float32) * 120 - 20)
    x[:4] = torch.tensor([float("nan"), 1e30, -float("inf"), 59.0])
    want = direct.bilinear_sample(img, x, y)
    got = direct.bilinear_sample(img.to(cuda), x.to(cuda), y.to(cuda)).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    for model, p in (("affine", [1.5, 0.01, -0.02, -2.25, 0.015, 0.01]),
                     ("perspective", [1.5, -2.25, 1.01, 0.02, -0.015, 0.99, 1e-4, -5e-5])):
        p = torch.tensor(p)
        assert torch.equal(direct.warp_backward(img.to(cuda), p.to(cuda), model).cpu(),
                           direct.warp_backward(img, p, model))
        for q in (p, torch.zeros_like(p), p * 1e9, torch.full_like(p, float("nan"))):
            assert torch.equal(direct.warp_forward(img.to(cuda), q.to(cuda), model).cpu(),
                               direct.warp_forward(img, q, model))
        curr = direct.warp_backward(img, p, model)
        a, _ = direct.optimize_level(direct.identity_params(model), img, curr, model, 20)
        b, _ = direct.optimize_level(direct.identity_params(model, cuda), img.to(cuda),
                                     curr.to(cuda), model, 20)
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)


def test_mesh_across_cards_equals_one_card(cuda, tmp_path):
    """Meshes over distinct cards (rows and partial sums move between
    devices): data parallel, the spatial step and the driver's default
    slots (the visible cards) equal the 1x1 step on the first card.  The
    spatial step there is the segmented band program (per-card graphs split
    at the collectives): over two calls on different frames it equals its
    eager body and the 1x1 step bit for bit, a replay launches what the
    eager body launches and nothing eagerly, and the first call's outputs
    are unchanged by the second.  Every card fits its own copy of the
    parameters (the eager step body): each card's copy of every replicated
    output equals card 0's and the 1x1 step's."""
    from gme_tpu_torch.config import MeshConfig
    from gme_tpu_torch.parallel import spatial
    from gme_tpu_torch.parallel.data_parallel import make_sharded_pipeline
    from gme_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    rng = np.random.RandomState(8)
    H, W = 96 * n // 2, 84
    prev = rng.randint(0, 256, (n, H, W)).astype(np.uint8)
    calls = []
    for shift in ((2, -1), (-3, 4)):
        curr = np.stack([np.roll(p, shift, (0, 1)) for p in prev])
        calls.append((torch.from_numpy(prev).to(cards[0]), torch.from_numpy(curr).to(cards[0])))
        prev = np.roll(prev, (5, 7), (1, 2))
    cfg = GMEConfig(search_impl="volume")
    meshes = {"space": make_mesh(1, n, cards), "both": make_mesh(2, n // 2, cards)}
    runs = {"data": make_sharded_pipeline(make_mesh(n, 1, cards), cfg)}
    runs.update({name: spatial.make_spatial_pipeline(m, cfg, H, W) for name, m in meshes.items()})
    for p, c in calls:
        want = gme_pipeline_batch(p, c, cfg)
        for name, step in runs.items():
            got = step(p, c)
            for k in want:
                assert got[k].device == cards[0] and torch.equal(got[k], want[k]), (name, k)
    for p, c in calls:
        lh = H // n
        bands = spatial.scatter_rows((p, c), cards, [k * lh for k in range(n)], lh)
        step = spatial.spatial_gme_step(*bands, cfg, H, W)
        want = gme_pipeline_batch(p, c, cfg)
        for k in ("parameters", "model_motion_field", "psnr", "volume_edge_hits"):
            assert list(step[k]) == cards, k
            for card, copy in step[k].items():
                assert copy.device == card and torch.equal(copy.to(cards[0]), want[k]), (card, k)
    for name, m in meshes.items():
        assert spatial._program_for(m) is spatial.spatial_program_segmented
        _compiled_equals_eager(runs[name], spatial.make_spatial_pipeline_eager(m, cfg, H, W),
                               calls)
        entry = spatial.spatial_program_segmented.last_entry
        assert len(entry.devices) == n and entry.steps, name
        assert any(s.pairs for s in entry.steps), name  # copies between cards run as peer copies
    clip = str(tmp_path / "clip.y4m")
    write_y4m(clip, [prev[0]] + [np.roll(prev[0], (i, -i), (0, 1)) for i in range(1, 5)])
    pcfg = PipelineConfig(gme=cfg, batch_size=2, write_images=False)
    recs = []
    for name, mesh in (("one", MeshConfig()), ("mesh", MeshConfig(data=2, space=n // 2))):
        process_video(clip, str(tmp_path / name), pcfg.replace(mesh=mesh), device="cuda")
        recs.append(json.load(open(tmp_path / name / "clip" / "psnr_records.json")))
    assert recs[0] == recs[1] and len(recs[0]) == 4


# ---------------------------------------------------------------------------
# Compiled entries (captured CUDA graphs) against their eager bodies
# ---------------------------------------------------------------------------

def _launched():
    replayed = compiled.replay_launches()
    return {n: K.LAUNCHES[n] + replayed[n] for n in K.LAUNCHES}


def _host_reads(fn, *args, **kwargs):
    """Reads of a tensor's value by the host (`item`, `bool`, a copy to the
    CPU) in one call of `fn`."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            to_host = (isinstance(out, torch.Tensor) and out.device.type == "cpu"
                       and any(isinstance(t, torch.Tensor) and t.is_cuda
                               for t in tree_leaves((args, kwargs))))
            if func is torch.ops.aten._local_scalar_dense.default or to_host:
                self.n += 1
            return out

    with Reads() as mode:
        fn(*args, **kwargs)
    return mode.n


def _compiled_equals_eager(fn, eager, calls, keep=None):
    """`fn` (compiled) over `calls`, a list of argument tuples on the card:
    each call equal to `eager` bit for bit with as many launches of each
    kernel, and the first call's outputs unchanged by the later calls."""
    outs = []
    for args in calls:
        K.reset_launch_counts()
        compiled.reset_replay_counts()
        want = eager(*args)
        eager_launches = _launched()
        fn(*args)  # captures on the first call of a key
        K.reset_launch_counts()
        compiled.reset_replay_counts()
        got = fn(*args)
        assert _launched() == eager_launches, (_launched(), eager_launches)
        assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES  # replays only
        flat_w, _ = compiled._flatten(want)
        flat_g, _ = compiled._flatten(got)
        assert len(flat_w) == len(flat_g)
        for w, g in zip(flat_w, flat_g):
            assert w.dtype == g.dtype and torch.equal(w, g)
        outs.append(([t.clone() for t in flat_g], flat_g))
    for kept, returned in outs:
        assert all(torch.equal(a, b) for a, b in zip(kept, returned))
    return outs


@pytest.mark.parametrize("cfg", [GMEConfig(), GMEConfig(searching_procedure=0),
                                 GMEConfig(searching_procedure=1),
                                 GMEConfig(searching_procedure=2), GMEConfig(volume_radius=64)])
def test_compiled_step_equals_eager(cuda, cfg):
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager

    calls = []
    for seed, shift in ((4, (3, -5)), (5, (-6, 9))):
        prev, curr = _pan_pair(seed, 100, 150, shift)
        calls.append((prev.to(cuda), curr.to(cuda), cfg))
    _compiled_equals_eager(gme_pipeline_batch, gme_pipeline_batch_eager, calls)
    entry = next(e for k, e in gme_pipeline_batch.entries.items() if k[0] == (("cfg", cfg),))
    # One graph whatever the search: 2D-log's three loops are WHILE nodes.
    assert len(entry.graphs) == 1
    assert len(entry.loops) == (3 if cfg.searching_procedure == 2 else 0)
    assert _host_reads(gme_pipeline_batch, *calls[0]) == 0


@pytest.mark.parametrize("sp,impl,max_iters", [
    (0, "auto", 4096), (1, "volume", 4096), (2, "volume", 4096), (2, "volume", 3),
    (3, "volume", 4096), (3, "gather", 4096), (2, "gather", 11),
])
def test_compiled_motion_field_equals_eager(cuda, sp, impl, max_iters):
    kw = dict(block_size=12, search_window=8, searching_procedure=sp, pnorm_distance=MAE,
              max_iters=max_iters, search_impl=impl, return_diagnostics=True)
    calls = []
    for seed, shift in ((6, (3, -5)), (7, (9, 4))):
        prev, curr = _pan_pair(seed, 72, 120, shift)
        calls.append((prev.to(cuda), curr.to(cuda)))
    _compiled_equals_eager(lambda p, c: bbme.get_motion_field_jit(p, c, **kw),
                           lambda p, c: bbme.get_motion_field(p, c, **kw), calls)
    entry = bbme.get_motion_field_jit.last_entry
    assert len(entry.graphs) == 1
    assert len(entry.loops) == (1 if sp == 2 or (sp == 3 and impl == "gather") else 0)
    assert _host_reads(bbme.get_motion_field_jit, *calls[0], **kw) == 0


@pytest.mark.parametrize("sp,impl", [(2, "volume"), (3, "gather")])
def test_compiled_loop_replays_any_iteration_count(cuda, sp, impl):
    """One captured entry replayed on a panned pair, a still pair (2D-log:
    no body run after its unrolled steps) and a larger pan, at more than
    one count of body runs, then a max_iters=3 call (static, so an entry of
    its own): each bit-equal to the eager body, with its launches once the
    body's counter is read, and the counter's runs those of the eager
    loop's chunks (its host reads but the last)."""
    kw = dict(block_size=12, search_window=8, searching_procedure=sp, pnorm_distance=MAE,
              search_impl=impl, return_diagnostics=True)
    prev, curr = _pan_pair(9, 72, 120, (3, -5))
    big = _pan_pair(10, 72, 120, (9, 11))
    cases = [((prev, curr), 4096), ((prev, prev), 4096), (big, 4096), ((prev, curr), 3)]
    runs = []
    for (p, c), max_iters in cases:
        p, c = p.to(cuda), c.to(cuda)

        def fn(p, c, _m=max_iters):
            return bbme.get_motion_field_jit(p, c, max_iters=_m, **kw)

        def eager(p, c, _m=max_iters):
            return bbme.get_motion_field(p, c, max_iters=_m, **kw)

        _compiled_equals_eager(fn, eager, [(p, c)])
        entry = bbme.get_motion_field_jit.last_entry
        assert len(entry.graphs) == 1 and len(entry.loops) == 1
        runs.append(int(entry.loops[0].runs[0]))
        assert entry.launches == _launched()
        assert runs[-1] == _host_reads(eager, p, c) - 1
    keys = {bbme.get_motion_field_jit.key(p.to(cuda), c.to(cuda), max_iters=m, **kw)
            for (p, c), m in cases}
    assert len(keys) == 2  # the three 4096-step calls replay one entry
    assert runs[0] > 0 and len(set(runs[:3])) > 1 and runs[3] <= 1, runs
    if sp == 2:  # a still 2D-log pair ends in its unrolled steps
        assert runs[1] == 0, runs


def test_compiled_small_ops_and_adaptive_equal_eager(cuda):
    import gme_tpu_torch as G
    from gme_tpu_torch.models import gme as tgme

    prev, curr = _pan_pair(8, 100, 150, (2, 3))
    prev, curr = prev.to(cuda), curr.to(cuda)
    params = torch.tensor([[2.5, 0.01, -0.02, -1.5, 0.003, 0.01]] * 2, device=cuda)
    field = G.get_motion_field_affine((6, 9), params)
    for fn, eager, args in (
        (G.get_pyramids_jit, G.get_pyramids, (prev, 3)),
        (G.get_motion_field_affine_jit, G.get_motion_field_affine, ((6, 9), params)),
        (G.compensate_frame_jit, G.compensate_frame, (prev, field)),
        (G.psnr_jit, G.psnr, (prev, curr)),
        (G.global_motion_estimation_jit, G.global_motion_estimation, (prev, curr)),
    ):
        _compiled_equals_eager(fn, eager, [args])
    frames = torch.from_numpy(_alternating_clip()).to(cuda)
    a, b = frames[:-1], frames[1:]
    got = tgme.gme_pipeline_batch_adaptive(a, b)
    want = tgme.gme_pipeline_batch_eager(a, b)
    for k in want:
        if k != "volume_edge_hits":
            assert torch.equal(got[k], want[k]), k


def test_compiled_direct_level_equals_eager(cuda):
    from gme_tpu_torch.models import direct

    img = torch.from_numpy(_alternating_clip(n=2)[0]).to(cuda)
    true = torch.tensor([1.5, 0.01, 0, -1.0, 0, 0.01], device=cuda)
    curr = direct.warp_backward(img, true, "affine")
    sched = direct._schedule(0.01, 40).to(cuda)
    p0 = direct.identity_params("affine", cuda)
    args = (p0, img.float(), curr, sched, "affine", 160.0)
    _compiled_equals_eager(direct._adam_level_jit, direct._adam_level, [args])


def test_compiled_f32_fit_equals_eager(cuda):
    """The f32 fit (float fields, 1080p) captures: its batched solve reads
    nothing back."""
    from gme_tpu_torch.ops import affine

    rng = np.random.RandomState(9)
    field = torch.from_numpy(rng.randn(3, 9, 12, 2).astype(np.float32) * 4).to(cuda)
    mask = torch.from_numpy(rng.rand(3, 9, 12) > 0.3).to(cuda)
    fit = compiled.compiled(affine._fit_normal_equations_f32,
                            static_argnames=("frame_shape", "coord_stride"))
    _compiled_equals_eager(fit, affine._fit_normal_equations_f32,
                           [(field, mask, (144, 192), 4), (field * 2, ~mask, (144, 192), 4)])
    assert len(fit.entries) == 1
    fit.clear()
    assert not fit.entries and fit.last_entry is None


@pytest.mark.parametrize("space,sp", [(2, DIAMOND), (4, DIAMOND), (4, 1), (4, 0)])
def test_compiled_spatial_step_equals_eager_and_one_card(cuda, space, sp):
    """Every slot on one card: the spatial step is one compiled band
    program, bit-equal to its eager body (as many launches a replay) and to
    the 1x1 step, PSNR included, over two calls on different frames."""
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager
    from gme_tpu_torch.parallel import spatial
    from gme_tpu_torch.parallel.mesh import make_mesh

    H, W = 96, 84
    cfg = GMEConfig(search_impl="volume", searching_procedure=sp)
    mesh = make_mesh(1, space, [cuda] * space)
    step = spatial.make_spatial_pipeline(mesh, cfg, H, W)
    eager = spatial.make_spatial_pipeline_eager(mesh, cfg, H, W)
    calls = []
    for seed, shift in ((0, (3, -5)), (1, (-6, 9))):
        prev, curr = _pan_pair(seed, H, W, shift)
        calls.append((prev.to(cuda), curr.to(cuda)))
    _compiled_equals_eager(step, eager, calls)
    assert spatial.spatial_program_jit.last_entry is not None
    for p, c in calls:
        got, one = step(p, c), gme_pipeline_batch_eager(p, c, cfg)
        for k in one:
            assert torch.equal(got[k], one[k]), k


@pytest.mark.parametrize("space", [2, 4])
def test_segmented_spatial_program_on_one_card(cuda, space):
    """Every slot on one card, called by name: the segmented band program
    (graphs split at the collectives, each collective a step of copies)
    equals the single-graph program, its eager body and the 1x1 step bit
    for bit over two calls on different frames, with as many launches a
    replay as the eager body and the steps the CPU counts (one pair makes
    no segment before the first collective)."""
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager
    from gme_tpu_torch.parallel import spatial
    from gme_tpu_torch.parallel.mesh import make_mesh

    H, W = 96, 84
    B = 2 if space == 2 else 1  # one pair: no device work before the first collective
    cfg = GMEConfig(search_impl="volume")
    mesh = make_mesh(1, space, [cuda] * space)
    calls = []
    for seed, shift in ((0, (3, -5)), (1, (-6, 9))):
        prev, curr = _pan_pair(seed, H, W, shift)
        calls.append((prev[:B].to(cuda), curr[:B].to(cuda)))

    def segmented(p, c):
        return spatial.spatial_program_segmented(p, c, mesh.devices, cfg, H, W)

    _compiled_equals_eager(segmented, spatial.make_spatial_pipeline_eager(mesh, cfg, H, W),
                           calls)
    entry = spatial.spatial_program_segmented.last_entry
    assert len(entry.steps) == 16 and len(entry.graphs) == 16 + (B > 1)
    for p, c in calls:
        got = segmented(p, c)
        single = spatial.spatial_program_jit(p, c, mesh.devices, cfg, H, W)
        one = gme_pipeline_batch_eager(p, c, cfg)
        for k in one:
            assert torch.equal(got[k], single[k]) and torch.equal(got[k], one[k]), k
    assert len(spatial.spatial_program_jit.last_entry.graphs) == 1


def test_profile_stages_runs_on_the_card(cuda):
    """`python -m gme_tpu_torch.tools.profile_stages` at its default size
    (240x320, batch 32): every stage timed on the card, the partition's
    outputs and the compiled step's equal to the eager step's."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "gme_tpu_torch.tools.profile_stages", "--reps",
                           "3"], cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (result["H"], result["W"], result["batch"]) == (240, 320, 32)
    assert all(r["device_ms"] > 0 for r in result["stages"]), result["stages"]
    assert result["step_busy_ms"] > 0 and result["partition_device_ms"] > 0


def test_capture_of_a_host_read_raises(cuda):
    """A function that reads a tensor on the host cannot be captured: the
    call raises, naming the function; it does not run eagerly instead."""
    def reads(x):
        return x * float(x.sum().item())

    fn = compiled.compiled(reads)
    with pytest.raises(compiled.CaptureError, match="reads"):
        fn(torch.ones(4, device=cuda))
    assert not fn.entries
    assert torch.equal(torch.ones(2, device=cuda) + 1, torch.full((2,), 2.0, device=cuda))

