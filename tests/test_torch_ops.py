"""Each module of the PyTorch port against its JAX namesake, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Integer outputs must be equal.  Float parameters are equal too wherever
the host CPU has FMA: XLA:CPU contracts a multiply and an add into one FMA
inside `jit`, and the port rounds those terms once as well (ROADMAP queue
C); elsewhere XLA rounds every product and they agree to 1e-5.  PSNR to
1e-4 dB.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gme_tpu.config import MAE, MSE
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models import gme as jgme
from gme_tpu.ops import affine as jaff
from gme_tpu.ops import bbme as jbbme
from gme_tpu.ops import metrics as jmet
from gme_tpu.ops import pyramid as jpyr
from gme_tpu.ops import warp as jwarp
from gme_tpu_torch.config import GMEConfig
from gme_tpu_torch.models import gme as tgme
from gme_tpu_torch.ops import affine as taff
from gme_tpu_torch.ops import bbme as tbbme
from gme_tpu_torch.ops import metrics as tmet
from gme_tpu_torch.ops import pyramid as tpyr
from gme_tpu_torch.ops import warp as twarp
from gme_tpu_torch.utils.guards import debug_checks



def _host_has_fma() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return any(line.startswith("flags") and "fma" in line.split() for line in f)
    except OSError:
        return False


PARAM_ATOL = 0.0 if _host_has_fma() else 1e-5
PSNR_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8), (9, 7), (121, 161), (15, 15), (64, 96)])
def test_pyrdown_matches_jax(rng, shape):
    x = rng.randint(0, 256, (3,) + shape, np.uint8)
    got = tpyr.pyrdown(_t(x))
    assert got.dtype == torch.uint8
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jpyr.pyrdown(jnp.asarray(x[i]))))


def test_pyramid_matches_reference_golden(goldens):
    g = goldens("pan240_pipeline.npz")
    pyr = tpyr.get_pyramids(_t(g["prev_10_11"])[None], 3)
    assert [tuple(p.shape) for p in pyr] == [(1, 60, 80), (1, 120, 160), (1, 240, 320)]
    for li in range(3):
        np.testing.assert_array_equal(pyr[li][0].numpy(), g[f"pyr_{li}"])


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_psnr_matches_jax(rng, goldens):
    g = goldens("pan240_pipeline.npz")
    a = np.stack([g["curr_10_11"], rng.randint(0, 256, (240, 320), np.uint8), g["curr_10_11"]])
    b = np.stack([g["comp_10_11"], rng.randint(0, 256, (240, 320), np.uint8), g["curr_10_11"]])
    got = tmet.psnr(_t(a), _t(b)).numpy()
    want = np.array([float(jmet.psnr(jnp.asarray(a[i]), jnp.asarray(b[i]))) for i in range(3)])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PSNR_ATOL)
    assert got[2] == -1.0  # identical frames
    assert abs(got[0] - float(g["psnr_10_11"])) < 1e-3


def test_frame_difference_matches_jax(rng):
    a = rng.randint(0, 256, (2, 9, 13), np.uint8)
    b = rng.randint(0, 256, (2, 9, 13), np.uint8)
    got = tmet.frame_difference(_t(a), _t(b))
    assert got.dtype == torch.uint8
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jmet.frame_difference(jnp.asarray(a[i]), jnp.asarray(b[i]))))


# ---------------------------------------------------------------------------
# Affine
# ---------------------------------------------------------------------------

def _random_fields(rng, n=4, nbh=6, nbw=9, amp=20):
    return rng.randint(-amp, amp + 1, (n, nbh, nbw, 2)).astype(np.int32)


def test_affine_field_matches_jax(rng):
    """Against the jitted JAX field, as the JAX step computes it."""
    params = (rng.randn(5, 6) * [3, 0.2, 0.2, 3, 0.2, 0.2]).astype(np.float32)
    params[0] = [0.5, 0, 0, 1.5, 0, 0]  # exact halves round to even
    got = taff.get_motion_field_affine((7, 11), _t(params))
    assert got.dtype == torch.int16 and got.shape == (5, 7, 11, 2)
    for i in range(5):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jaff.get_motion_field_affine_jit((7, 11), jnp.asarray(params[i]))))


def test_fma_rounds_once():
    """`_fma` is a*b + c rounded once.  (1 + 2^-23)(1 - 2^-23) - 1 keeps
    the -2^-46 that a rounded product loses.  In the second case the exact
    sum lies 2^-70 below the float32 midpoint 1 + 2^-23 + 2^-24: its
    float64 sum is that midpoint, which ties to even, upwards; rounding to
    odd moves it back below the midpoint, so it rounds down as the exact
    sum does."""
    f32 = np.float32
    a = np.array([1 + 2 ** -23, 2 ** -24 * (1 - 2 ** -23)], f32)
    b = np.array([1 - 2 ** -23, 1 + 2 ** -23], f32)
    c = np.array([-1.0, 1 + 2 ** -23], f32)
    got = taff._fma(_t(a), _t(b), _t(c)).numpy()
    assert got[0] == f32(-(2.0 ** -46)) and a[0] * b[0] + c[0] == 0
    twice = f32(a[1].astype(np.float64) * b[1] + c[1])
    assert got[1] == f32(1 + 2 ** -23) and twice == f32(1 + 2 ** -22)


def test_affine_model_matches_jitted_jax(rng):
    """The float displacement against jit(vmap(affine_model)) over a 45x80
    cell grid, bit for bit where the host has FMA: XLA:CPU fuses both
    products."""
    import jax
    from jax import lax

    params = (rng.randn(200, 6) * [30, 0.05, 0.05, 30, 0.05, 0.05]).astype(np.float32)
    xs = lax.broadcasted_iota(jnp.float32, (45, 80), 0)
    ys = lax.broadcasted_iota(jnp.float32, (45, 80), 1)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jaff.affine_model(xs, ys, p)))(jnp.asarray(params)))
    x, y = taff._cell_coords(45, 80, torch.float32, "cpu")
    np.testing.assert_allclose(taff.affine_model(x, y, _t(params)).numpy(), want,
                               rtol=0, atol=PARAM_ATOL)


def test_params_from_moments_matches_jitted_jax(rng):
    """2000 moment vectors of 45x80 integer fields (the 720p level-2 grid)
    with about 70% inliers, against jit(vmap(params_from_moments)) of the
    JAX package, bit for bit where the host has FMA."""
    import jax

    amp = rng.randint(1, 40, 2000)
    fields = np.stack([rng.randint(-a, a + 1, (45, 80, 2)) for a in amp]).astype(np.int32)
    masks = rng.rand(len(amp), 45, 80) < 0.7
    mom = taff.int_moments(_t(fields), _t(masks), 4)
    want = np.asarray(jax.jit(jax.vmap(jaff.params_from_moments))(
        jnp.asarray(mom.numpy().astype(np.int32))))
    got = taff.params_from_moments(mom).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)


def test_first_parameters_and_projection_match_jax(rng):
    fields = _random_fields(rng, amp=17)
    got = taff.compute_first_parameters(_t(fields))
    for i in range(len(fields)):
        want = np.asarray(jaff.compute_first_parameters(jnp.asarray(fields[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            taff.parameter_projection(got)[i].numpy(),
            np.asarray(jaff.parameter_projection(jnp.asarray(want))))


def test_int_moments_and_fit_match_jax(rng):
    """The parameters against the jitted JAX fit, as the JAX step runs it."""
    import jax

    fields = _random_fields(rng)
    masks = rng.rand(*fields.shape[:3]) > 0.3
    got_m = taff.int_moments(_t(fields), _t(masks), 4)
    got_p = taff.fit_normal_equations(_t(fields), _t(masks), (96, 144), 4)
    assert got_p.dtype == torch.float32
    for i in range(len(fields)):
        want_m = np.asarray(jaff.int_moments(jnp.asarray(fields[i]), jnp.asarray(masks[i]), 4))
        np.testing.assert_array_equal(got_m[i].numpy(), want_m)
        want_p = np.asarray(jax.jit(jaff.fit_normal_equations, static_argnums=(2, 3))(
            jnp.asarray(fields[i]), jnp.asarray(masks[i]), (96, 144), 4))
        np.testing.assert_allclose(got_p[i].numpy(), want_p, rtol=0, atol=PARAM_ATOL)


def test_f32_fit_matches_jax(rng):
    """The fallback for frames whose moments overflow int32 (1080p)."""
    fields = _random_fields(rng, nbh=8, nbw=12)
    masks = rng.rand(*fields.shape[:3]) > 0.2
    assert not taff.moments_fit_ok(67, 120, (1080, 1920), 4)
    got = taff._fit_normal_equations_f32(_t(fields), _t(masks), (128, 192), 4)
    for i in range(len(fields)):
        want = np.asarray(jaff._fit_normal_equations_f32(
            jnp.asarray(fields[i]), jnp.asarray(masks[i]), (128, 192), 4))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-4)


def test_degenerate_fit_raises():
    """Under `debug_checks()`, as the JAX package's checks raise only when
    enabled (outside it the fit gives NaN: tests/test_torch_guards.py)."""
    field = torch.zeros((1, 1, 5, 2), dtype=torch.int32)  # one cell row: collinear
    with debug_checks():
        with pytest.raises(ValueError, match="singular"):
            taff.fit_normal_equations(field, torch.ones((1, 1, 5), dtype=torch.bool), (16, 80), 4)
        with pytest.raises(ValueError, match="empty"):
            taff._fit_normal_equations_f32(
                field, torch.zeros((1, 1, 5), dtype=torch.bool), (16, 80), 4)


@pytest.mark.parametrize("fraction", [0.0, 0.3, 0.5])
def test_outlier_mask_matches_jax(rng, fraction):
    gt = _random_fields(rng, amp=6)
    af = _random_fields(rng, amp=3).astype(np.int16)
    got = taff.outlier_mask(_t(gt), _t(af), fraction)
    for i in range(len(gt)):
        want = np.asarray(jaff.outlier_mask(jnp.asarray(gt[i]), jnp.asarray(af[i]), fraction))
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_robust_fit_matches_reference_golden(goldens):
    """The JAX package's affine golden: the non-robust and robust fits of a
    64x80 pair, through the port's search and fit; against the jitted JAX
    robust fit."""
    import jax

    g = goldens("affine_fit.npz")
    prev, curr = _t(g["prev"])[None], _t(g["curr"])[None]
    cfg = GMEConfig()
    field = tbbme.get_motion_field(prev, curr, block_size=16, searching_procedure=3)
    nonrobust = taff.fit_normal_equations(field, torch.ones(field.shape[:3], dtype=torch.bool), (64, 80), 4)
    np.testing.assert_allclose(nonrobust[0].numpy(), g["nonrobust"], atol=2e-3)
    robust = tgme.best_affine_parameters_robust(prev, curr, _t(g["old"])[None], cfg)
    np.testing.assert_allclose(robust[0].numpy(), g["robust"], atol=2e-3)
    with_diag, diag = tgme.best_affine_parameters_robust(
        prev, curr, _t(g["old"])[None], cfg, return_diagnostics=True)
    assert torch.equal(with_diag, robust) and diag["volume_edge_hits"].shape == (1,)
    jcfg = JaxGMEConfig(search_impl="volume")
    want = np.asarray(jax.jit(lambda p, c, o: jgme.best_affine_parameters_robust(p, c, o, jcfg))(
        jnp.asarray(g["prev"]), jnp.asarray(g["curr"]), jnp.asarray(g["old"])))
    np.testing.assert_allclose(robust[0].numpy(), want, rtol=0, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# Warp
# ---------------------------------------------------------------------------

def test_compensate_frame_matches_reference_golden(goldens):
    g = goldens("warp.npz")
    got = twarp.compensate_frame(_t(g["frame"])[None], _t(g["mf"])[None])
    np.testing.assert_array_equal(got[0].numpy(), g["comp"])


@pytest.mark.parametrize("shape,nb", [((64, 96), (4, 6)), ((33, 47), (4, 5)), ((40, 56), (2, 2))])
def test_compensate_frame_matches_jax(rng, shape, nb):
    """Out-of-frame sources keep the original pixel; rows and columns past
    the field's cover stay as they are."""
    f = rng.randint(0, 256, (3,) + shape, np.uint8)
    mf = rng.randint(-25, 26, (3,) + nb + (2,)).astype(np.int16)
    got = twarp.compensate_frame(_t(f), _t(mf))
    for i in range(3):
        want = np.asarray(jwarp.compensate_frame(jnp.asarray(f[i]), jnp.asarray(mf[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)


# ---------------------------------------------------------------------------
# BBME: cost volume, rank map, SDSP, diamond search
# ---------------------------------------------------------------------------

VOLUME_CASES = [  # (H, W, bs, R, pnorm)
    (20, 28, 2, 5, MAE), (20, 28, 2, 5, MSE), (37, 51, 4, 6, MAE),
    (48, 56, 8, 8, MSE), (48, 64, 16, 6, MSE), (50, 70, 16, 10, MSE),
    (40, 40, 8, 12, MSE),
]


def _frames(rng, H, W, n=2):
    return (rng.randint(0, 256, (n, H, W), np.uint8),
            rng.randint(0, 256, (n, H, W), np.uint8))


@pytest.mark.parametrize("H,W,bs,R,pnorm", VOLUME_CASES)
def test_cost_volume_and_rank_map_match_jax(rng, H, W, bs, R, pnorm):
    prev, curr = _frames(rng, H, W)
    vol = tbbme.compute_cost_volume(_t(prev), _t(curr), bs, R, pnorm)
    nbh, nbw = H // bs, W // bs
    origins = tbbme._block_origins(nbh, nbw, bs, "cpu")
    rank = tbbme._succ_map_packed(vol, origins, H, W, bs, R)
    assert rank.dtype == torch.int8 and rank.shape == (2, nbh, nbw, (2 * R + 1) ** 2)
    jorigins = jbbme._block_origins(nbh, nbw, bs)
    for i in range(2):
        jvol = jbbme.compute_cost_volume(jnp.asarray(prev[i]), jnp.asarray(curr[i]), bs, R, pnorm)
        np.testing.assert_array_equal(vol[i].numpy(), np.asarray(jvol))  # +inf included
        np.testing.assert_array_equal(
            rank[i].numpy(), np.asarray(jbbme._succ_map_packed(jvol, jorigins, H, W, bs, R)))


def test_rank_map_ties_and_inf_match_jax():
    """The adversarial volumes of tests/test_pallas.py: all ties, all +inf,
    the largest exact cost, and a mix."""
    H, W, bs, R = 32, 32, 8, 4
    nbh, nbw, D = H // bs, W // bs, 2 * R + 1
    max_cost = float(255 * 255 * bs * bs)
    vols = [
        np.zeros((nbh, nbw, D * D), np.float32),
        np.full((nbh, nbw, D * D), np.inf, np.float32),
        np.full((nbh, nbw, D * D), max_cost, np.float32),
        np.random.RandomState(3).choice([0.0, 1.0, max_cost, np.inf], (nbh, nbw, D * D)).astype(np.float32),
    ]
    got = tbbme._succ_map_packed(_t(np.stack(vols)), tbbme._block_origins(nbh, nbw, bs, "cpu"), H, W, bs, R)
    jorigins = jbbme._block_origins(nbh, nbw, bs)
    for i, v in enumerate(vols):
        want = np.asarray(jbbme._succ_map_packed(jnp.asarray(v), jorigins, H, W, bs, R))
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_take_best_picks_first_minimum():
    """argmin ties resolve to the first index, all-+inf rows to index 0."""
    inf = float("inf")
    cost = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0], [inf] * 5, [5.0, 5.0, 5.0, 5.0, 5.0],
                         [inf, inf, 7.0, inf, 7.0]])
    pos = torch.arange(4 * 5 * 2, dtype=torch.int32).reshape(4, 5, 2)
    got = tbbme._take_best(pos, cost)
    np.testing.assert_array_equal(got.numpy(), pos[torch.arange(4), torch.tensor([1, 0, 0, 2])].numpy())
    want = np.asarray(jbbme._take_best(jnp.asarray(pos.numpy())[None], jnp.asarray(cost.numpy())[None]))[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs,radius", [(2, 16), (16, 32), (8, 4)])
def test_diamond_search_matches_jax(rng, bs, radius):
    """The field and `volume_edge_hits` of a batch, against the JAX package's
    volume engine; radius 4 at bs 8 clamps walks at the volume edge."""
    H, W, shift = 64, 80, 6
    base = rng.randint(0, 256, (2, H + shift, W + shift), np.uint8)
    prev, curr = base[:, :H, :W], base[:, shift:, shift:]
    field, diag = tbbme.get_motion_field(
        _t(prev), _t(curr), block_size=bs, searching_procedure=3, volume_radius=radius,
        return_diagnostics=True)
    assert field.dtype == torch.int32 and diag["volume_edge_hits"].shape == (2,)
    for i in range(2):
        jf, jd = jbbme.get_motion_field(
            jnp.asarray(prev[i]), jnp.asarray(curr[i]), block_size=bs, searching_procedure=3,
            pnorm_distance=MSE, search_impl="volume", volume_radius=radius, return_diagnostics=True)
        np.testing.assert_array_equal(field[i].numpy(), np.asarray(jf))
        assert int(diag["volume_edge_hits"][i]) == int(jd["volume_edge_hits"])
    if radius == 4:
        assert int(diag["volume_edge_hits"].sum()) > 0


@pytest.mark.parametrize("pn,bs,sw", [(0, 4, 2), (1, 4, 2), (1, 8, 4), (1, 12, 8)])
def test_diamond_search_matches_reference_golden(goldens, pn, bs, sw):
    g = goldens("bbme_synthetic.npz")
    field = tbbme.get_motion_field(
        _t(g["prev"])[None], _t(g["curr"])[None], block_size=bs, searching_procedure=3,
        pnorm_distance=pn)
    np.testing.assert_array_equal(field[0].numpy(), g[f"mf_sp3_pn{pn}_bs{bs}_sw{sw}"])


def test_jax_config_round_trips():
    jcfg = JaxGMEConfig(volume_radius=24, search_impl="volume")
    assert dataclasses.asdict(GMEConfig.from_dict(dataclasses.asdict(jcfg))) == dataclasses.asdict(jcfg)
    assert GMEConfig.from_dict(dataclasses.asdict(jcfg.fast())) == GMEConfig.from_dict(
        dataclasses.asdict(jcfg)).fast()
