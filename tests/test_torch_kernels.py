"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode, on the shapes of
tests/test_pallas.py and tests/test_warp.py.  Every output is an integer
(held in float32 for the volumes), so every comparison is exact.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them to these plain versions there.
"""

import itertools

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


def _pallas_rowoffset(prev, cpad, bs, D, pnorm, cross=False):
    """(nbh, nbw, D*D): `_dfd_cost_volume_rowoffset` in interpret mode in
    the port's layout."""
    vol = np.asarray(pk._dfd_cost_volume_rowoffset(
        jnp.asarray(prev, jnp.float32), jnp.asarray(cpad, jnp.float32), bs, D, pnorm,
        True, cross=cross))
    return vol.transpose(2, 3, 0, 1).reshape(vol.shape[2], vol.shape[3], D * D)


@pytest.mark.parametrize("pnorm,bs,Hc,Wc,D", [
    (MAE, 16, 32, 48, 9),   # MAE at bs >= 8: row-offset kernel
    (MSE, 4, 24, 24, 7),    # D < 8: row-offset kernel
    (MAE, 8, 32, 40, 9),
])
def test_rowoffset_shapes_raise(rng, pnorm, bs, Hc, Wc, D):
    """Shapes the JAX dispatch sends to `_cost_volume_kernel` (the name is
    the raise these shapes met before they had a kernel): the port's
    dispatch and `cost_volume_rowoffset` (its plain version here) equal the
    Pallas kernel in interpret mode."""
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    want = _pallas_rowoffset(prev, cpad, bs, D, pnorm)
    p, c = torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None]
    np.testing.assert_array_equal(K.cost_volume_rowoffset(p, c, bs, D, pnorm)[0].numpy(), want)
    np.testing.assert_array_equal(tbbme._dfd_cost_volume(p, c, bs, D, pnorm)[0].numpy(), want)


@pytest.mark.parametrize("pnorm,bs,Hc,Wc,D", [
    (MAE, 12, 24, 36, 5), (MSE, 2, 8, 12, 5), (MAE, 3, 9, 12, 6), (MSE, 3, 9, 12, 6),
    (MAE, 9, 18, 27, 5), (MAE, 13, 26, 26, 7), (MSE, 5, 10, 15, 6), (MSE, 7, 14, 21, 3),
])
def test_cost_volume_rowoffset_matches_cost_volume_kernel(rng, pnorm, bs, Hc, Wc, D):
    """MAE at bs 12 (the BBME command line's default), bs 2 with D < 8 (the
    exhaustive dense init), bs 3, which does not divide 8, and the other
    residues of bs mod 4 the packed kernel masks (bs 5, 7, 9, 13)."""
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    got = K.cost_volume_rowoffset(torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None],
                                  bs, D, pnorm)
    np.testing.assert_array_equal(got[0].numpy(), _pallas_rowoffset(prev, cpad, bs, D, pnorm))


@pytest.mark.parametrize("bs,Hc,Wc,D", [(8, 16, 24, 9), (16, 32, 32, 5)])
def test_cost_volume_cross_matches_cross_kernel(rng, bs, Hc, Wc, D):
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    got = K.cost_volume_cross(torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None], bs, D)
    np.testing.assert_array_equal(got[0].numpy(),
                                  _pallas_rowoffset(prev, cpad, bs, D, MSE, cross=True))


def test_cross_volume_shapes_raise(rng):
    """MSE at bs=16 with bs + D - 1 > 128 (R >= 57; the name is the raise
    this shape met before it had a kernel): the decomposed MSE over the
    cross volume equals JAX `_dfd_cost_volume_mse_decomp` in interpret mode
    and the direct MSE volume, bit for bit."""
    bs, Hc, Wc, D = 16, 32, 32, 115
    prev, cpad = _volume_case(rng, bs, Hc, Wc, D)
    vol = np.asarray(pk._dfd_cost_volume_mse_decomp(
        jnp.asarray(prev, jnp.float32), jnp.asarray(cpad, jnp.float32), bs, D, True))
    want = vol.transpose(2, 3, 0, 1).reshape(Hc // bs, Wc // bs, D * D)
    p, c = torch.from_numpy(prev)[None], torch.from_numpy(cpad)[None]
    got = tbbme._dfd_cost_volume(p, c, bs, D, MSE)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert torch.equal(got, K.cost_volume_plain(p, c, bs, D, MSE))


def test_plain_volume_rounds_large_blocks_once():
    """MSE at bs 20 sums past 2**24: the plain version is the exact integer
    sum rounded to float32 once (ROADMAP queue C logs JAX's float32 sums)."""
    bs, D = 20, 3
    prev = torch.zeros((1, bs, bs), dtype=torch.uint8)
    cpad = torch.full((1, bs + D - 1, bs + D - 1), 255, dtype=torch.uint8)
    cpad[0, 0, 0] = 254
    got = K.cost_volume_rowoffset(prev, cpad, bs, D, MSE)
    exact = bs * bs * 255 ** 2 - (255 ** 2 - 254 ** 2)
    assert got[0, 0, 0, 0].item() == float(np.float32(exact))
    assert got[0, 0, 0, 1].item() == float(np.float32(bs * bs * 255 ** 2))


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
    with pytest.raises(ValueError, match="overflow"):
        K.cost_volume_rowoffset(torch.zeros((1, 182, 182), dtype=torch.uint8),
                                torch.zeros((1, 182, 182), dtype=torch.uint8), 182, 1, MSE)
    with pytest.raises(ValueError, match="overflow"):
        K.cost_volume_cross(torch.zeros((1, 182, 182), dtype=torch.uint8),
                            torch.zeros((1, 182, 182), dtype=torch.uint8), 182, 1)
    with pytest.raises(ValueError, match="pnorm"):
        K.cost_volume_rowoffset(prev, cpad, 2, 9, 3)
    with pytest.raises(ValueError, match="ssd"):
        K.cost_volume_cross(torch.zeros((1, 20, 20), dtype=torch.uint8),
                            torch.zeros((1, 20, 20), dtype=torch.uint8), 20, 1, ssd=True)
    with pytest.raises(ValueError, match="device"):
        K.warp_block_field(torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta"),
                           torch.zeros((1, 2, 2, 2), dtype=torch.int32, device="meta"), 8)


# ---------------------------------------------------------------------------
# CPU models of the redesigned volume kernels' layouts
# ---------------------------------------------------------------------------

def _band_rows(D, band_outputs=5632):
    """Offset rows per CUDA block of csrc/cost_volume_cross.cu: near-equal
    bands whose (R, D) stage holds at most about `band_outputs` outputs."""
    bands = -(-D * D // band_outputs)
    return -(-D // bands)


def _mma_bands(prev, cpad, bs, D, Rb, ssd=True):
    """The volume exactly as csrc/cost_volume_mma.cuh lays it out, in plain
    int32 torch, in bands of Rb offset rows (Rb = D: the one band of
    cost_volume_mse_block).  Per (cell, band of rows dr0 .. dr0+R-1): the
    band's (bs+R-1) x (bs+D-1) window zero-padded to the kernel's row stride
    S = 8G + 24 rounded up to 16 (G = ceil(D/8)); for each prev row r the A
    operand A[(dr, g), c'] = W[r + dr, 8g + c'] (rows m = dr*G + g, padded
    to a multiple of 16, padded rows reading row 0) times the 8-wide
    Toeplitz band B[c', n] = P[r, c' - n]; the sum over r is the cross term
    at (dr0 + dr, 8g + n), columns dc >= D and padded rows dropped.
    Epilogue: the cross term, or (ssd) the box sums of W^2 (column sums over
    bs rows, then sliding sums over bs columns) - 2 * cross + sum P^2.  Each
    band's R*D outputs are one run, stored as a ragged head, aligned quads
    and a ragged tail; the model checks that every output is stored once."""
    B, Hc, Wc = prev.shape
    Hp, Wp = cpad.shape[1:]
    nbh, nbw = Hc // bs, Wc // bs
    K, G = bs + D - 1, (D + 7) // 8
    S = (8 * G + 24 + 15) & ~15
    i32 = torch.int32
    P = prev.reshape(B, nbh, bs, nbw, bs).permute(0, 1, 3, 2, 4).to(i32)
    c = torch.arange(32)[:, None] - torch.arange(8)[None, :]    # c' - n, (32, 8)
    toeplitz = [P[..., r, :][..., c.clamp(0, bs - 1)] * ((c >= 0) & (c < bs)) for r in range(bs)]
    sb2 = (P ** 2).sum((-2, -1), dtype=i32)
    out = torch.full((B * nbh * nbw * D * D,), float("nan"))
    stores = torch.zeros(out.shape, dtype=i32)
    cpad = cpad.contiguous()
    for dr0 in range(0, D, Rb):
        R = min(Rb, D - dr0)
        win = cpad.as_strided((B, nbh, nbw, bs + R - 1, K), (Hp * Wp, bs * Wp, bs, Wp, 1), dr0 * Wp)
        win = torch.nn.functional.pad(win.to(i32), (0, S - K))  # (B, nbh, nbw, bs+R-1, S)
        M = R * G
        m = torch.arange(-(-M // 16) * 16)
        m = torch.where(m < M, m, 0)
        dr, g = m // G, m % G
        cols = 8 * g[:, None] + torch.arange(32)                # (Mp, 32)
        cross = torch.zeros((B, nbh, nbw, len(m), 8), dtype=i32)
        for r in range(bs):
            A = win[..., r + dr[:, None], cols]                 # (B, nbh, nbw, Mp, 32)
            assert A.dtype == toeplitz[r].dtype == i32
            cross += A @ toeplitz[r]
        res = cross[..., :M, :].reshape(B, nbh, nbw, R, 8 * G)[..., :D]
        if ssd:
            sq = win[..., :K] ** 2
            box = sq.unfold(-2, bs, 1).sum(-1, dtype=i32).unfold(-1, bs, 1).sum(-1, dtype=i32)
            res = box - 2 * res + sb2[..., None, None]
        assert res.dtype == i32
        n = R * D
        for cell, vals in enumerate(res.to(torch.float32).reshape(-1, n)):
            first = cell * D * D + dr0 * D
            head = min((4 - first % 4) % 4, n)
            nvec = (n - head) // 4
            tail = head + 4 * nvec
            assert (first + head) % 4 == 0
            f = torch.cat([torch.arange(head), head + torch.arange(4 * nvec),
                           torch.arange(tail, min(tail + 3, n))])
            out[first + f] = vals[f]
            stores[first + f] += 1
    assert bool((stores == 1).all())
    return out.reshape(B, nbh, nbw, D * D)


MMA_SHAPES = ([(bs, D) for bs in (8, 10, 13, 16) for D in (8, 9, 25, 65)]
              + [(8, 121), (10, 119), (13, 116), (16, 113)])  # bs + D - 1 = 128


def _frames(kind, rng, B, Hc, Wc, D):
    shape_p, shape_c = (B, Hc, Wc), (B, Hc + D - 1, Wc + D - 1)
    if kind == "random":
        return (torch.from_numpy(rng.randint(0, 256, shape_p).astype(np.uint8)),
                torch.from_numpy(rng.randint(0, 256, shape_c).astype(np.uint8)))
    lo, hi = (0, 255) if kind == "0-255" else (255, 0)
    return (torch.full(shape_p, lo, dtype=torch.uint8), torch.full(shape_c, hi, dtype=torch.uint8))


@pytest.mark.parametrize("kind", ["random", "0-255", "255-0"])
@pytest.mark.parametrize("bs,D", MMA_SHAPES)
def test_mma_tiling_model_equals_plain_mse(rng, kind, bs, D):
    """The tensor-core layout of cost_volume_mse_block, modelled in int32,
    equals the plain MSE volume bit for bit (2 x 3 cells; all-0 against
    all-255 reaches the 16,646,400 maximum at bs 16)."""
    prev, cpad = _frames(kind, rng, 2 if kind == "random" else 1, 2 * bs, 3 * bs, D)
    got = _mma_bands(prev, cpad, bs, D, D)
    assert torch.equal(got, K.cost_volume_plain(prev, cpad, bs, D, MSE))
    if kind != "random":
        assert float(got.max()) == bs * bs * 255 ** 2


@pytest.mark.parametrize("kind", ["random", "0-255", "255-0"])
@pytest.mark.parametrize("bs,D", [(bs, D) for bs in (8, 12, 16) for D in (113, 121, 129)])
def test_mma_band_model_equals_plain_volumes(rng, kind, bs, D):
    """cost_volume_cross's tensor-core layout in bands of offset rows (D 113
    and 121 end in a short band), modelled in int32, equals the plain cross
    volume and, in SSD mode, the plain MSE volume bit for bit (2 x 3
    cells)."""
    prev, cpad = _frames(kind, rng, 2 if kind == "random" else 1, 2 * bs, 3 * bs, D)
    Rb = _band_rows(D)
    assert -(-D // Rb) == 3 and (D % Rb > 0) == (D != 129)
    cross = _mma_bands(prev, cpad, bs, D, Rb, ssd=False)
    assert torch.equal(cross, K.cost_volume_cross_plain(prev, cpad, bs, D))
    ssd = _mma_bands(prev, cpad, bs, D, Rb)
    assert torch.equal(ssd, K.cost_volume_plain(prev, cpad, bs, D, MSE))
    assert torch.equal(K.cost_volume_cross(prev, cpad, bs, D, ssd=True), ssd)
    if kind != "random":
        assert float(ssd.min()) == float(ssd.max()) == bs * bs * 255 ** 2
        assert float(cross.max()) == 0


def _small_block_walk(B, nbh, nbw, bs, D, threads=256, outputs_per_block=8192):
    """The output walk of csrc/cost_volume_small_block.cu: a CUDA block per
    run of T whole cells, or per band of R offset rows of one cell where a
    cell has too many outputs; in each, the ragged head and tail one output
    each, then the aligned quads with (cell, dr, dc) carried by a fixed
    step.  Returns the flat index of every output written, with the (b, t,
    j, dr, dc) the kernel computes it for."""
    DD = D * D
    T = max(1, min(nbw, -(-outputs_per_block // DD)))
    R = D if T > 1 else min(D, -(-outputs_per_block // D))
    step = 4 * threads
    written = []
    for b, t, j0, r0 in itertools.product(range(B), range(nbh), range(0, nbw, T), range(0, D, R)):
        tc, nr = min(T, nbw - j0), min(R, D - r0)
        DDc = nr * D
        n = tc * DDc
        first = ((b * nbh + t) * nbw + j0) * DD + r0 * D
        head = min(n, (4 - first % 4) % 4)
        nq = (n - head) // 4
        tail = head + 4 * nq
        s_cell, s_rem = divmod(step, DDc)
        s_dr, s_dc = divmod(s_rem, D)
        for f in list(range(head)) + list(range(tail, n)):
            cell, rem = divmod(f, DDc)
            dr, dc = divmod(rem, D)
            written.append((first + f, (b, t, j0 + cell, r0 + dr, dc)))
        for tid in range(min(threads, nq)):
            cell, rem = divmod(head + 4 * tid, DDc)
            dr, dc = divmod(rem, D)
            for q in range(tid, nq, threads):
                assert (first + head + 4 * q) % 4 == 0
                ce, re, de = cell, dr, dc
                for e in range(4):
                    written.append((first + head + 4 * q + e, (b, t, j0 + ce, r0 + re, de)))
                    de += 1
                    if de == D:
                        de, re = 0, re + 1
                        if re == nr:
                            re, ce = 0, ce + 1
                dc += s_dc
                if dc >= D:
                    dc, dr = dc - D, dr + 1
                dr += s_dr
                if dr >= nr:
                    dr, cell = dr - nr, cell + 1
                cell += s_cell
    return written


@pytest.mark.parametrize("B,nbh,nbw,bs,D", [
    (1, 2, 37, 2, 33), (3, 1, 160, 2, 17), (2, 2, 9, 1, 8), (1, 1, 70, 4, 65), (2, 1, 5, 2, 9),
    (2, 1, 3, 2, 129), (1, 2, 2, 1, 257),  # bands of offset rows
])
def test_small_block_walk_covers_each_output_once(B, nbh, nbw, bs, D):
    """Every output of the volume is written exactly once, at the (cell,
    dr, dc) its flat index names, by the walk of cost_volume_small_block."""
    written = _small_block_walk(B, nbh, nbw, bs, D)
    DD = D * D
    flat = sorted(f for f, _ in written)
    assert flat == list(range(B * nbh * nbw * DD))
    for f, (b, t, j, dr, dc) in written:
        assert f == (((b * nbh + t) * nbw + j) * D + dr) * D + dc
