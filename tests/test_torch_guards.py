"""The port's guards (`gme_tpu_torch/utils/guards.py`) and the degenerate
fit, against the JAX package on the CPU.

The first six tests mirror tests/test_guards.py: a degenerate fit raises
under `run_checked`, and outside it yields NaN parameters.  The rest hold
that NaN path to the JAX package's: the same NaN and inf parameters, the
same saturating int16 field, the same compensated frame, and a batch whose
other pairs are unchanged.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models.gme import gme_pipeline_batch as jax_pipeline_batch
from gme_tpu.ops import affine as jaff
from gme_tpu.ops import warp as jwarp
from gme_tpu_torch.config import GMEConfig
from gme_tpu_torch.models.gme import gme_pipeline_batch, gme_pipeline_step
from gme_tpu_torch.ops import affine as taff
from gme_tpu_torch.ops import warp as twarp
from gme_tpu_torch.utils.guards import CheckError, check, checks_enabled, debug_checks, run_checked
from test_torch_ops import PARAM_ATOL
from test_torch_pipeline import INT_KEYS, _smooth_frame


def _field(nbh=6, nbw=8):
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(-3, 4, (1, nbh, nbw, 2)).astype(np.int32))


def test_empty_inlier_set_raises():
    mask = torch.zeros((1, 6, 8), dtype=torch.bool)
    with pytest.raises(CheckError, match="empty inlier set"):
        run_checked(taff.fit_normal_equations, _field(), mask, (96, 128), 4)


def test_collinear_inliers_raise():
    mask = torch.zeros((1, 6, 8), dtype=torch.bool)
    mask[0, 2, :] = True  # one row: x has no variance -> singular system
    with pytest.raises(CheckError, match="singular"):
        run_checked(taff.fit_normal_equations, _field(), mask, (96, 128), 4)


def test_float_fallback_empty_mask_raises():
    # float-typed field -> the f32 fit; same degenerate input
    mask = torch.zeros((1, 6, 8), dtype=torch.bool)
    with pytest.raises(CheckError):
        run_checked(taff.fit_normal_equations, _field().float(), mask, (96, 128), 4)


def test_healthy_input_passes_and_matches_unchecked():
    mask = torch.ones((1, 6, 8), dtype=torch.bool)
    checked = run_checked(taff.fit_normal_equations, _field(), mask, (96, 128), 4)
    plain = taff.fit_normal_equations(_field(), mask, (96, 128), 4)
    assert torch.equal(checked, plain)


def test_checks_cost_nothing_by_default():
    """Without `debug_checks()` a check does not read its predicate (a meta
    tensor cannot be read), and the degenerate input yields NaN parameters:
    the JAX package's production behaviour."""
    assert not checks_enabled()
    check(torch.zeros(1, dtype=torch.bool, device="meta"), "never read")
    with debug_checks():
        assert checks_enabled()
        with pytest.raises(CheckError, match="read"):
            check(torch.zeros(1, dtype=torch.bool), "read")
    assert not checks_enabled()
    mask = torch.zeros((1, 6, 8), dtype=torch.bool)
    out = taff.fit_normal_equations(_field(), mask, (96, 128), 4)
    assert torch.isnan(out).any()


def test_full_pipeline_step_runs_checked(rng):
    prev = rng.randint(0, 256, (64, 80), np.uint8)
    curr = np.roll(prev, (1, -2), (0, 1))
    out = run_checked(gme_pipeline_step, torch.from_numpy(prev), torch.from_numpy(curr),
                      GMEConfig())
    assert torch.isfinite(out["parameters"]).all()


# ---------------------------------------------------------------------------
# The NaN path against the JAX package's
# ---------------------------------------------------------------------------

def _degenerate_moments():
    """Moments of an empty set, one cell, a row, a column, a diagonal pair
    and a healthy set: every singular kind next to a regular one."""
    fields = np.random.RandomState(1).randint(-5, 6, (6, 4, 6, 2)).astype(np.int32)
    masks = np.zeros((6, 4, 6), bool)
    masks[1, 2, 3] = True
    masks[2, 1, :] = True
    masks[3, :, 4] = True
    masks[4, 0, 0] = masks[4, 3, 3] = True
    masks[5] = True
    return taff.int_moments(torch.from_numpy(fields), torch.from_numpy(masks), 4)


def test_degenerate_fit_matches_jax():
    """The same NaN and inf parameters from the same divisions, next to a
    healthy pair that stays exact."""
    mom = _degenerate_moments()
    got = taff.params_from_moments(mom).numpy()
    want = np.asarray(jax.jit(jax.vmap(jaff.params_from_moments))(jnp.asarray(mom.numpy(), jnp.int32)))
    assert np.isnan(want[:5]).any(axis=1).all() and np.isfinite(want[5]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)  # NaN == NaN, inf == inf
    with debug_checks(), pytest.raises(CheckError):
        taff.params_from_moments(mom)


def test_non_finite_parameters_give_jax_field_and_frame(rng):
    """XLA converts NaN to 0 and saturates beyond the int16 range; the
    field and the compensated frame follow the JAX package's."""
    nan, inf = np.nan, np.inf
    params = np.array([
        [nan] * 6,
        [inf, 0, 0, -inf, 0, 0],
        [1e6, 0, 0, -4e4, 0, 0],
        [0, inf, 0, 0, 0, -inf],   # inf * 0 = NaN at the first row and column
        [2.5, 0.25, -0.5, -3.5, 0.125, 1.0],
        [3, nan, 1, -2, 0, inf],
    ], np.float32)
    shape = (5, 7)
    got = taff.get_motion_field_affine(shape, torch.from_numpy(params))
    frames = rng.randint(0, 256, (len(params), 40, 56), np.uint8)
    comp = twarp.compensate_frame(torch.from_numpy(frames), got)
    for i, p in enumerate(params):
        want = np.asarray(jaff.get_motion_field_affine_jit(shape, jnp.asarray(p)))
        np.testing.assert_array_equal(got[i].numpy(), want)
        want_comp = np.asarray(jwarp.compensate_frame_jit(jnp.asarray(frames[i]), jnp.asarray(want)))
        np.testing.assert_array_equal(comp[i].numpy(), want_comp)


def test_degenerate_pair_in_a_batch_matches_jax():
    """One pair of a batch whose robust fit keeps two collinear cells: its
    parameters are NaN in both packages, its field, frame, diffs and PSNR
    equal JAX's, and the other pairs equal the JAX step's.  Under
    `run_checked` the same batch raises."""
    rng = np.random.RandomState(1)
    a = _smooth_frame(rng, 64, 96)
    noise = rng.randint(0, 256, (2, 64, 96)).astype(np.uint8)
    prev = np.stack([a, noise[0], a])
    curr = np.stack([np.roll(a, (2, -3), (0, 1)), noise[1], np.roll(a, (1, 2), (0, 1))])
    jax_cfg = JaxGMEConfig(search_impl="volume", outlier_fraction=0.9)
    want = {k: np.asarray(v) for k, v in
            jax_pipeline_batch(jnp.asarray(prev), jnp.asarray(curr), jax_cfg).items()}
    nan_pairs = np.isnan(want["parameters"]).any(axis=1)
    assert nan_pairs.tolist() == [False, False, True], want["parameters"]
    cfg = GMEConfig.from_dict(dataclasses.asdict(jax_cfg))
    P, C = torch.from_numpy(prev), torch.from_numpy(curr)
    got = {k: v.numpy() for k, v in gme_pipeline_batch(P, C, cfg).items()}
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.isnan(got["parameters"]), np.isnan(want["parameters"]))
    np.testing.assert_allclose(got["parameters"], want["parameters"], rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    with pytest.raises(CheckError):
        run_checked(gme_pipeline_batch, P, C, cfg)
