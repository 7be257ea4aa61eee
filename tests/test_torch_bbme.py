"""The port's block-matching searches against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Every
output compared here is an integer (motion fields, `volume_edge_hits`) or a
half of one (the hierarchical float32 field), so every comparison is exact.
JAX runs on the CPU, where its "auto" engine is the gather engine; the
port's "auto" is the volume engine, and the two agree wherever
`volume_edge_hits` is 0.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gme_tpu.config import BBMEConfig as JaxBBMEConfig
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models import hierarchical_bbme as jhier
from gme_tpu.models.gme import gme_pipeline_batch as jax_pipeline_batch
from gme_tpu.ops import bbme as jbbme
import gme_tpu_torch
from gme_tpu_torch.config import EXHAUSTIVE, MAE, MSE, TWODLOG, BBMEConfig, GMEConfig
from gme_tpu_torch.models import hierarchical_bbme as thier
from gme_tpu_torch.ops import bbme as tbbme
from test_torch_ops import PARAM_ATOL

GOLDEN_CASES = [(sp, pn, bs, sw) for sp in range(4) for pn in (MAE, MSE)
                for bs, sw in ((4, 2), (8, 4), (12, 8))]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _smooth_frame(rng, H, W):
    """tests/test_bbme.py's low-pass texture: walks travel on it."""
    low = rng.randint(0, 256, (H // 4, W // 4)).astype(np.float32)
    img = np.kron(low, np.ones((4, 4), np.float32))
    for _ in range(2):
        img = (np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 1) + 4 * img) / 8.0
    return img.astype(np.uint8)


def _jax_field(prev, curr, **kw):
    return np.asarray(jbbme.get_motion_field_jit(jnp.asarray(prev), jnp.asarray(curr), **kw))


# ---------------------------------------------------------------------------
# The signature, the defaults, the config
# ---------------------------------------------------------------------------

def test_get_motion_field_signature_is_jax():
    """Parameter names, order and defaults are the JAX package's, so a call
    by position or with defaults runs the same search."""
    want = inspect.signature(jbbme.get_motion_field).parameters
    got = inspect.signature(tbbme.get_motion_field).parameters
    assert list(got) == list(want)
    for name in want:
        assert got[name].default == want[name].default, name
    assert gme_tpu_torch.get_motion_field is tbbme.get_motion_field


def test_get_motion_field_defaults_equal_jax(rng):
    """With every default: three-step, bs 4, sw 2, MSE."""
    base = rng.randint(0, 256, (2, 44, 60), np.uint8)
    curr = np.roll(base, (1, -2), (1, 2))
    got = tbbme.get_motion_field(_t(base), _t(curr))
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), _jax_field(base[i], curr[i]))
        np.testing.assert_array_equal(
            got[i].numpy(), _jax_field(base[i], curr[i], block_size=4, search_window=2,
                                       searching_procedure=1, pnorm_distance=MSE))


def test_bbme_config_from_jax_and_cfg_call_equal_jax(rng):
    jcfg = JaxBBMEConfig(block_size=8, search_window=4, searching_procedure=TWODLOG,
                         pnorm_distance=MAE, search_impl="volume", volume_radius=12)
    cfg = BBMEConfig.from_dict(dataclasses.asdict(jcfg))
    assert [f.name for f in dataclasses.fields(BBMEConfig)] == [
        f.name for f in dataclasses.fields(JaxBBMEConfig)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(BBMEConfig()) == dataclasses.asdict(JaxBBMEConfig())
    with pytest.raises(ValueError, match="unknown BBMEConfig"):
        BBMEConfig.from_dict({"no_such_field": 1})
    prev = _smooth_frame(rng, 48, 64)
    curr = np.roll(prev, (5, -3), (0, 1))
    got = tbbme.get_motion_field_cfg(_t(prev)[None], _t(curr)[None], cfg)
    want = np.asarray(jbbme.get_motion_field_cfg(jnp.asarray(prev), jnp.asarray(curr), jcfg))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_pipeline_passes_search_window_to_the_search():
    """The GME step's exhaustive search uses `cfg.search_window`: at sw 3 it
    equals JAX, and the frames are chosen so that sw 2 gives another field."""
    rng = np.random.RandomState(4)
    prev = _smooth_frame(rng, 64, 96)
    curr = np.roll(prev, (-12, 12), (0, 1))
    jcfg = JaxGMEConfig(searching_procedure=EXHAUSTIVE, search_window=3, search_impl="volume")
    want = jax_pipeline_batch(jnp.asarray(prev[None]), jnp.asarray(curr[None]), jcfg)
    narrow = jax_pipeline_batch(jnp.asarray(prev[None]), jnp.asarray(curr[None]),
                                jcfg.replace(search_window=2))
    assert not np.array_equal(np.asarray(want["model_motion_field"]),
                              np.asarray(narrow["model_motion_field"]))
    got = gme_tpu_torch.gme_pipeline_batch(_t(prev)[None], _t(curr)[None],
                                           GMEConfig.from_dict(dataclasses.asdict(jcfg)))
    for k in ("model_motion_field", "compensated", "diff_curr_comp", "volume_edge_hits"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["parameters"].numpy(), np.asarray(want["parameters"]),
                               rtol=0, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# The reference goldens, both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp,pn,bs,sw", GOLDEN_CASES)
def test_motion_field_matches_golden_and_jax(goldens, sp, pn, bs, sw):
    g = goldens("bbme_synthetic.npz")
    ref = g[f"mf_sp{sp}_pn{pn}_bs{bs}_sw{sw}"]
    np.testing.assert_array_equal(
        _jax_field(g["prev"], g["curr"], block_size=bs, search_window=sw,
                   searching_procedure=sp, pnorm_distance=pn), ref)
    for impl in ("volume", "gather"):
        field, diag = tbbme.get_motion_field(
            _t(g["prev"])[None], _t(g["curr"])[None], block_size=bs, search_window=sw,
            searching_procedure=sp, pnorm_distance=pn, search_impl=impl,
            return_diagnostics=True)
        assert field.dtype == torch.int32 and field.shape == (1,) + ref.shape
        np.testing.assert_array_equal(field[0].numpy(), ref, err_msg=impl)
        assert diag["volume_edge_hits"].shape == (1,)


def test_hierarchical_matches_golden(goldens):
    g = goldens("hierarchical_bbme.npz")
    got = gme_tpu_torch.hierarchical_wrapper(_t(g["prev"])[None], _t(g["curr"])[None],
                                             block_size=10, search_window=4,
                                             searching_procedure=3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), g["field"])


@pytest.mark.parametrize("shape,sp", [((100, 96), 3), ((80, 104), 1), ((100, 96), 0)])
def test_hierarchical_matches_jax(rng, shape, sp):
    """100x96 takes the row-pad branch (coarse grids 2x2 -> 4x4 against
    5x4), 80x104 the column-pad branch (4x4 against 4x5); the coarsest level
    runs procedure `sp`, every finer one diamond."""
    H, W = shape
    prev = rng.randint(0, 256, (2, H, W), np.uint8)
    curr = np.roll(prev, (3, -2), (1, 2))
    got = thier.hierarchical_wrapper(_t(prev), _t(curr), searching_procedure=sp)
    want = jax.vmap(jax.jit(functools.partial(jhier.hierarchical_wrapper, searching_procedure=sp)))(
        jnp.asarray(prev), jnp.asarray(curr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rescale_motion_field_matches_jax():
    mf = np.array([[[1.5, -1.5], [-0.5, 2.0]], [[0.0, 3.5], [-2.5, 7.0]]], np.float32)[None]
    got = thier.rescale_motion_field(_t(mf))
    want = np.asarray(jhier.rescale_motion_field(jnp.asarray(mf[0])))
    assert got.dtype == torch.int32 and got.shape == (1, 4, 4, 2)
    np.testing.assert_array_equal(got[0].numpy(), want)


# ---------------------------------------------------------------------------
# Engines, diagnostics, ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [1, 2, 3])
@pytest.mark.parametrize("pn", [MAE, MSE])
def test_gather_engine_matches_jax_gather(rng, sp, pn):
    """The gather engine on a batch of two pairs, with diagnostics (always 0
    on the gather engine), against JAX `search_impl="gather"`."""
    prev = np.stack([_smooth_frame(rng, 48, 72) for _ in range(2)])
    curr = np.stack([np.roll(prev[0], (6, -9), (0, 1)), np.roll(prev[1], (-3, 2), (0, 1))])
    kw = dict(block_size=8, search_window=6, searching_procedure=sp, pnorm_distance=pn,
              search_impl="gather")
    field, diag = tbbme.get_motion_field(_t(prev), _t(curr), return_diagnostics=True, **kw)
    assert int(diag["volume_edge_hits"].abs().sum()) == 0
    for i in range(2):
        np.testing.assert_array_equal(field[i].numpy(), _jax_field(prev[i], curr[i], **kw))


@pytest.mark.parametrize("sp", [0, 1, 2])
def test_volume_engine_matches_jax_volume(rng, sp):
    """A batch of two pairs whose walks move, against JAX's volume engine,
    with its diagnostics."""
    prev = np.stack([_smooth_frame(rng, 48, 64) for _ in range(2)])
    curr = np.stack([np.roll(prev[0], (7, 7), (0, 1)), np.roll(prev[1], (-2, 4), (0, 1))])
    kw = dict(block_size=8, search_window=4, searching_procedure=sp, pnorm_distance=MSE,
              search_impl="volume", volume_radius=6)
    field, diag = tbbme.get_motion_field(_t(prev), _t(curr), return_diagnostics=True, **kw)
    for i in range(2):
        jf, jd = jbbme.get_motion_field(jnp.asarray(prev[i]), jnp.asarray(curr[i]),
                                        return_diagnostics=True, **kw)
        np.testing.assert_array_equal(field[i].numpy(), np.asarray(jf))
        assert int(diag["volume_edge_hits"][i]) == int(jd["volume_edge_hits"])


def test_twodlog_edge_hits_match_jax():
    """tests/test_bbme.py's case: a (12, 12) roll fires the detector at
    radius 8 and not at 32, where the field equals the gather engine's."""
    rng = np.random.RandomState(0)
    prev = _smooth_frame(rng, 64, 64)
    curr = np.roll(prev, (12, 12), (0, 1))
    kw = dict(pnorm_distance=1, block_size=8, search_window=4)
    hits = {}
    for radius in (8, 32):
        got_f, got_d = tbbme.twodlog_search(_t(prev)[None], _t(curr)[None], search_impl="volume",
                                            volume_radius=radius, return_diagnostics=True, **kw)
        want_f, want_d = jbbme.twodlog_search(jnp.asarray(prev), jnp.asarray(curr),
                                              search_impl="volume", volume_radius=radius,
                                              return_diagnostics=True, **kw)
        np.testing.assert_array_equal(got_f[0].numpy(), np.asarray(want_f))
        hits[radius] = int(got_d["volume_edge_hits"][0])
        assert hits[radius] == int(want_d["volume_edge_hits"])
    assert hits[8] > 0 and hits[32] == 0
    gather = tbbme.twodlog_search(_t(prev)[None], _t(curr)[None], search_impl="gather", **kw)
    np.testing.assert_array_equal(got_f.numpy(), gather.numpy())


@pytest.mark.parametrize("pn", [MAE, MSE])
def test_exhaustive_ties_match_jax(pn):
    """Flat frames make every candidate of a flat block tie: the first
    minimum in column-offset-outer order wins, as in the reference."""
    rng = np.random.RandomState(11)
    prev = np.full((2, 40, 48), 90, np.uint8)
    prev[0, 16:28, 20:36] = rng.randint(0, 256, (12, 16))
    prev[1, :, 24:] = 200
    curr = np.stack([np.roll(prev[0], (2, -3), (0, 1)), prev[1]])
    field = tbbme.exhaustive_search(_t(prev), _t(curr), pn, 4, 3)
    # Flat interior blocks of pair 1: (wc, wr) = (-3, -3), the first offset, wins.
    assert (field[1, 1:, 1:5] == torch.tensor([-3, -3], dtype=torch.int32)).all()
    for i in range(2):
        np.testing.assert_array_equal(
            field[i].numpy(), _jax_field(prev[i], curr[i], block_size=4, search_window=3,
                                         searching_procedure=0, pnorm_distance=pn))


def test_threestep_radius_and_steps_match_jax():
    for bs, sw in ((4, 2), (12, 8), (16, 2), (2, 2), (8, 7)):
        assert tbbme.threestep_search_radius(bs, sw) == jbbme.threestep_search_radius(bs, sw)
        for step in (0, 1, 3):
            np.testing.assert_array_equal(tbbme._nine_offsets(step, "cpu").numpy(),
                                          np.asarray(jbbme._nine_offsets(step)))


def test_unknown_procedure_and_pnorm_raise():
    prev = torch.zeros((1, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="procedure"):
        tbbme.get_motion_field(prev, prev, searching_procedure=7)
    with pytest.raises(ValueError, match="pnorm"):
        tbbme.get_motion_field(prev, prev, pnorm_distance=5, search_impl="gather")


# ---------------------------------------------------------------------------
# The select-chain rank map (above block size 16)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [20, 24])
@pytest.mark.parametrize("shift,radius", [((3, -5), 32), ((12, 17), 6)])
def test_volume_diamond_above_bs16_equals_jax(bs, shift, radius):
    """MAE volumes are exact in both packages at bs 20/24 (max 24**2 * 255
    < 2**24), so the volume-engine diamond walk on the select-chain rank
    map equals JAX's field and ring count; radius 6 makes walks reach the
    ring and the clamps.  (MSE is not compared above bs 16: JAX's float32
    sums are not exact there, ROADMAP queue C.)"""
    rng = np.random.RandomState(bs + radius)
    prev = _smooth_frame(rng, 96, 120)
    curr = np.roll(prev, shift, (0, 1))
    kw = dict(block_size=bs, searching_procedure=3, pnorm_distance=MAE, search_impl="volume",
              volume_radius=radius, return_diagnostics=True)
    got, diag = tbbme.get_motion_field(_t(prev)[None], _t(curr)[None], **kw)
    want, wdiag = jbbme.get_motion_field(jnp.asarray(prev), jnp.asarray(curr), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int(diag["volume_edge_hits"][0]) == int(wdiag["volume_edge_hits"])
    assert (int(diag["volume_edge_hits"][0]) > 0) == (radius == 6)


@pytest.mark.parametrize("bs,R,shift", [(4, 3, (2, 2)), (8, 5, (3, -4)), (16, 6, (7, 9)),
                                         (2, 16, (-5, 6))])
def test_select_rank_map_equals_packed(bs, R, shift):
    """At bs <= 16 both builders apply; their rank maps are equal (as
    tests/test_pallas.py holds them for JAX), frame clamps included."""
    rng = np.random.RandomState(bs * 100 + R)
    prev = np.stack([_smooth_frame(rng, 64, 80), rng.randint(0, 256, (64, 80)).astype(np.uint8)])
    curr = np.stack([np.roll(prev[0], shift, (0, 1)), np.roll(prev[1], (1, 1), (0, 1))])
    P, C = _t(prev), _t(curr)
    vol = tbbme.compute_cost_volume(P, C, bs, R, MSE)
    og = tbbme._block_origins(64 // bs, 80 // bs, bs, "cpu")
    packed = tbbme._succ_map_packed(vol, og, 64, 80, bs, R)
    assert torch.equal(tbbme._succ_map_select(vol, og, 64, 80, bs, R), packed)
    assert torch.equal(tbbme._succ_map(vol, og, 64, 80, bs, R), packed)
