"""The port's direct (gradient-descent) GME against the JAX package.

`gme_tpu_torch.models.direct` on the CPU: the 12 tests of
`tests/test_direct.py` (known-motion recovery within the same tolerances,
the warps' contracts, the parameter rules), then each piece held to jitted
JAX on the same numpy inputs:

- warp_forward, the parameter conversions and `project_params`: bit for
  bit, collisions and huge and NaN parameters included (XLA's float -> int
  convert saturates and maps NaN to 0);
- `bilinear_sample`, `warp_backward` and the warped frame of
  `photometric_loss`: bit for bit, XLA:CPU's fused multiply-adds emulated
  by `ops.affine._fma` (exact on FMA hosts; ROADMAP queue C7); the motion
  models alone within an ulp, since which products XLA fuses there depends
  on the fusion around them;
- `photometric_loss` and its gradient, at the identity (every border pixel
  on a clip bound, where XLA gives each side half the gradient) and at a
  random point: relative 1e-5, the sums run in another order;
- `optimize_level` over 20 Adam steps: parameters within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gme_tpu.models import direct as J
from gme_tpu_torch.models import direct as T
from gme_tpu_torch.models.direct import (
    DEFAULT_ITERATIONS,
    bilinear_sample,
    direct_global_motion_estimation,
    direct_motion_compensation,
    identity_params,
    params_from_pixel,
    params_to_pixel,
    project_params,
    warp_backward,
    warp_forward,
)
from gme_tpu_torch.ops.metrics import psnr
from test_direct import _smooth_image
from test_torch_ops import _host_has_fma


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the frames are small, so it is as fast, and it
    keeps this file fast beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = (("perspective", 8), ("affine", 6))
# The motion models alone: which products XLA fuses depends on the fusion
# around them (ROADMAP queue C7); coordinates below 128 (float32 ulp 7.6e-6).
COORD_ATOL = 1.6e-5
GRAD_RTOL = 1e-5
# The FMA-emulated float paths are bit-equal where XLA:CPU emits FMAs, on
# an x86 host with FMA (`test_torch_ops._host_has_fma`).  Elsewhere XLA
# rounds each product: coordinates below 128 (ulp 7.6e-6), pixel values
# below 256 (ulp 1.5e-5), and warp_backward multiplies a coordinate ulp by
# the image gradient.
_FMA = _host_has_fma()
SAMPLE_ATOL = 0.0 if _FMA else 1e-4
WARP_ATOL = 0.0 if _FMA else 1e-3
# `cli direct` over 60 Adam steps: the losses' sums run in another order
# than XLA's (test_cli_direct_matches_jax).  Without FMA every product
# rounds apart as well.
CLI_PARAM_ATOL = 1e-5 if _FMA else 1e-3
CLI_PSNR_ATOL = 1e-4 if _FMA else 0.05


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _p(a):
    return torch.tensor(a, dtype=torch.float32)


def _psnr(a, b):
    return float(psnr(a[None].to(torch.uint8), b[None].to(torch.uint8))[0])


@pytest.fixture(scope="module")
def smooth():
    return _t(_smooth_image())


# ---------------------------------------------------------------------------
# The 12 tests of tests/test_direct.py
# ---------------------------------------------------------------------------

def test_affine_recovers_translation(smooth):
    true = _p([3.0, 0, 0, -4.0, 0, 0])
    curr = warp_backward(smooth, true, "affine")
    est = direct_global_motion_estimation(smooth, curr, "affine").numpy()
    assert abs(est[0] - 3.0) < 0.5 and abs(est[3] + 4.0) < 0.5, est
    assert np.allclose(est, true.numpy(), atol=0.1), est


def test_affine_recovers_zoom_rotation(smooth):
    true = _p([2.0, 0.02, -0.01, -1.5, 0.015, 0.03])
    curr = warp_backward(smooth, true, "affine")
    est = direct_global_motion_estimation(smooth, curr, "affine").numpy()
    assert np.allclose(est, true.numpy(), atol=0.1), est


def test_perspective_recovers_translation(smooth):
    true = _p([3.0, -4.0, 1, 0, 0, 1, 0, 0])
    curr = warp_backward(smooth, true, "perspective")
    est = direct_global_motion_estimation(smooth, curr, "perspective").numpy()
    assert abs(est[0] - 3.0) < 0.5 and abs(est[1] + 4.0) < 0.5, est


def test_perspective_recovers_homography(smooth):
    true = _p([2.0, -1.0, 1.01, 0.02, -0.015, 0.99, 1e-4, -5e-5])
    curr = warp_backward(smooth, true, "perspective")
    est = direct_global_motion_estimation(smooth, curr, "perspective").numpy()
    assert np.allclose(est[:6], true.numpy()[:6], atol=0.1), est
    assert np.allclose(est[6:], true.numpy()[6:], atol=2e-4), est


def test_compensation_improves_psnr(smooth):
    prev = smooth
    curr = torch.roll(prev, (3, -4), (0, 1))
    params, comp = direct_motion_compensation(prev, curr, "affine")
    assert comp.dtype == torch.uint8 and comp.shape == prev.shape
    before, after = _psnr(curr, prev), _psnr(curr, comp)
    assert after > before + 6.0, (before, after)


def test_bilinear_clamps_to_edge():
    img = _t(np.arange(16, dtype=np.uint8).reshape(4, 4))
    assert float(bilinear_sample(img, -10.3, 0.0)) == 0.0
    assert float(bilinear_sample(img, 99.0, 99.0)) == 15.0


def test_warp_forward_collision_last_write_wins():
    frame = _t(np.array([[10, 20], [30, 40]], np.uint8))
    out = warp_forward(frame, torch.zeros(8), "perspective").numpy()
    assert out[0, 0] == 40  # the last row-major source pixel
    assert out[0, 1] == 0 and out[1, 0] == 0 and out[1, 1] == 0


def test_warp_forward_identity():
    frame = _t(_smooth_image(32, 32))
    out = warp_forward(frame, identity_params("perspective"))
    assert torch.equal(out, frame)


def test_backward_forward_roundtrip_translation(smooth):
    t = _p([5.0, 0, 0, 7.0, 0, 0])
    curr = warp_backward(smooth, t, "affine")
    back = warp_forward(curr, t, "affine").numpy()
    ref = smooth.numpy().astype(np.float32)
    interior = (slice(8, -8), slice(8, -8))
    assert np.allclose(back[interior], np.round(ref[interior]), atol=1.0)


def test_project_params_matches_prototype_rule():
    out = project_params(_p([1, 2, 3, 4, 5, 6, 7, 8]), "perspective").numpy()
    assert np.allclose(out, [2, 4, 3, 4, 5, 6, 3.5, 4])  # gd motion.py:95-105
    out = project_params(_p([1, 2, 3, 4, 5, 6]), "affine").numpy()
    assert np.allclose(out, [2, 2, 3, 8, 5, 6])


def test_pixel_normalised_roundtrip():
    for model, n in MODELS:
        p = _t(np.linspace(-1, 1, n).astype(np.float32))
        rt = params_from_pixel(params_to_pixel(p, 96.0, model), 96.0, model)
        assert np.allclose(rt.numpy(), p.numpy(), rtol=1e-6)


def test_iteration_budget_is_static():
    assert DEFAULT_ITERATIONS >= 100 and T.N_MAX_ITERATIONS == J.N_MAX_ITERATIONS
    assert T.DEFAULT_LEARNING_RATE == J.DEFAULT_LEARNING_RATE


# ---------------------------------------------------------------------------
# Each piece against jitted JAX
# ---------------------------------------------------------------------------

def _random_params(rng, model, n, scale=0.05):
    p = np.array(J.identity_params(model)) + rng.randn(n).astype(np.float32) * np.float32(scale)
    if model == "perspective":
        p[6:] *= np.float32(1e-3)
    return p.astype(np.float32)


@pytest.mark.parametrize("model,n", MODELS)
def test_models_match_jitted_jax(model, n):
    rng = np.random.RandomState(0)
    H, W = 48, 64
    xs = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None], (H, W)).copy()
    ys = np.broadcast_to(np.arange(W, dtype=np.float32)[None], (H, W)).copy()
    coords = jax.jit(lambda p, x, y: J._model_coords(model, p, x, y))
    for p in (np.array(J.identity_params(model)), _random_params(rng, model, n)):
        want = coords(p, xs, ys)
        got = T._model_coords(model, _t(p), _t(xs), _t(ys))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.array(w), rtol=0, atol=COORD_ATOL)
    if model == "perspective":  # a vanishing denominator takes the signed 1e-6
        p = np.array([0, 0, 1, 0, 0, 1, -1.0 / 40, 0], np.float32)
        want = coords(p, xs, ys)
        got = T._model_coords(model, _t(p), _t(xs), _t(ys))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.array(w), rtol=1e-6)


def test_parameter_rules_match_jax_exactly():
    rng = np.random.RandomState(1)
    for model, n in MODELS:
        p = rng.randn(n).astype(np.float32)
        assert np.array_equal(project_params(_t(p), model).numpy(),
                              np.array(J.project_params(jnp.asarray(p), model)))
        for scale in (96.0, 1280.0, 7.0):
            assert np.array_equal(params_to_pixel(_t(p), scale, model).numpy(),
                                  np.array(J.params_to_pixel(jnp.asarray(p), scale, model)))
            assert np.array_equal(params_from_pixel(_t(p), scale, model).numpy(),
                                  np.array(J.params_from_pixel(jnp.asarray(p), scale, model)))
        assert np.array_equal(identity_params(model).numpy(), np.array(J.identity_params(model)))


def test_bilinear_sample_matches_jitted_jax():
    """In-frame, out-of-frame, huge, infinite and NaN coordinates."""
    rng = np.random.RandomState(2)
    img = _smooth_image(48, 64)
    x = rng.rand(600).astype(np.float32) * np.float32(80) - np.float32(20)
    y = rng.rand(600).astype(np.float32) * np.float32(100) - np.float32(20)
    x[:5] = [np.nan, 1e30, -1e30, np.inf, -np.inf]
    y[5:10] = [np.nan, 1e30, -1e30, np.inf, -np.inf]
    x[10:20] = np.arange(10, dtype=np.float32) * np.float32(47 / 9)  # on the grid and bounds
    want = np.array(jax.jit(J.bilinear_sample)(jnp.asarray(img), x, y))
    got = bilinear_sample(_t(img), _t(x), _t(y)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("model,n", MODELS)
def test_warps_match_jitted_jax(model, n):
    """warp_backward bit for bit (on FMA hosts); warp_forward bit for bit,
    under collisions (all zeros), huge and NaN parameters."""
    rng = np.random.RandomState(3)
    img = _smooth_image(48, 64)
    backward = jax.jit(J.warp_backward, static_argnums=2)
    forward = jax.jit(J.warp_forward, static_argnums=2)
    p = _random_params(rng, model, n, 0.02)
    np.testing.assert_allclose(warp_backward(_t(img), _t(p), model).numpy(),
                               np.array(backward(jnp.asarray(img), p, model)),
                               rtol=0, atol=WARP_ATOL)
    for q in (p, np.zeros(n, np.float32), p * np.float32(1e9), -p * np.float32(1e12),
              np.full(n, np.nan, np.float32), np.full(n, np.inf, np.float32)):
        got = warp_forward(_t(img), _t(q), model)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), np.array(forward(jnp.asarray(img), q, model))), q


@pytest.mark.parametrize("model,n", MODELS)
def test_photometric_loss_and_gradient_match_jax(model, n):
    """At the identity every border pixel sits on a clip bound, where XLA
    splits the gradient in half (torch.clamp would not)."""
    rng = np.random.RandomState(4)
    prev = _smooth_image(48, 64)
    curr = np.array(J.warp_backward(jnp.asarray(prev), jnp.asarray(_random_params(rng, model, n, 0.02)),
                                    model))
    grad = jax.jit(jax.value_and_grad(J.photometric_loss), static_argnums=(3, 4))
    for p in (np.array(J.identity_params(model)), _random_params(rng, model, n, 0.01)):
        want_l, want_g = grad(jnp.asarray(p), jnp.asarray(prev, jnp.float32), jnp.asarray(curr),
                              model, 64.0)
        pt = _t(p).requires_grad_(True)
        loss = T.photometric_loss(pt, _t(prev).float(), _t(curr), model, 64.0)
        (g,) = torch.autograd.grad(loss, pt)
        np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=GRAD_RTOL)
        want_g = np.array(want_g)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(want_g).max()))


@pytest.mark.parametrize("model,n", MODELS)
@pytest.mark.parametrize("coord_scale", [64.0, 1.0])
def test_photometric_warp_matches_jitted_jax(model, n, coord_scale):
    """The loss's warped frame (normalised grid, model, bilinear sample)
    bit for bit: the loss differs only by the order of its sum."""
    rng = np.random.RandomState(6)
    prev = _smooth_image(48, 64)
    H, W = prev.shape

    def warped(p, img):
        xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0) * (1.0 / coord_scale)
        ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1) * (1.0 / coord_scale)
        x1, y1 = J._model_coords(model, p, xs, ys)
        return J.bilinear_sample(img, x1 * coord_scale, y1 * coord_scale)

    for p in (_random_params(rng, model, n, 0.01), _random_params(rng, model, n, 0.2)):
        want = np.array(jax.jit(warped)(jnp.asarray(p), jnp.asarray(prev, jnp.float32)))
        xs, ys = T._grid(H, W, "cpu")
        x1, y1 = T._model_coords(model, _t(p), xs * (1.0 / coord_scale), ys * (1.0 / coord_scale))
        got = bilinear_sample(_t(prev).float(), x1 * coord_scale, y1 * coord_scale).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("model,n", MODELS)
def test_optimize_level_matches_jax(model, n):
    """20 Adam steps under the cosine schedule: the loss trace and the
    parameters agree with optax's."""
    rng = np.random.RandomState(5)
    prev = _smooth_image(48, 64)
    true = _random_params(rng, model, n, 0.01)
    curr = np.array(J.warp_backward(jnp.asarray(prev), jnp.asarray(true), model))
    p0 = np.array(J.identity_params(model))
    want_p, want_l = J.optimize_level(jnp.asarray(p0), jnp.asarray(prev), jnp.asarray(curr),
                                      model=model, iterations=20)
    got_p, got_l = T.optimize_level(_t(p0), _t(prev), _t(curr), model=model, iterations=20)
    assert got_l.shape == (20,)
    np.testing.assert_allclose(got_l.numpy(), np.array(want_l), rtol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.array(want_p), rtol=0, atol=1e-5)


def test_float_frames_take_the_float_pyramid():
    """A float current frame (a warp's output) takes pyrDown's float32 taps
    and floor((acc + 128) / 256), as in the JAX package."""
    from gme_tpu.ops.pyramid import get_pyramids as jax_pyramids
    from gme_tpu_torch.ops.pyramid import get_pyramids

    img = _smooth_image(48, 64)
    warped = np.array(J.warp_backward(jnp.asarray(img), jnp.asarray([1.3, 0, 0, -0.7, 0, 0],
                                                                     jnp.float32), "affine"))
    want = jax_pyramids(jnp.asarray(warped), 3)
    got = get_pyramids(_t(warped)[None], 3)
    for w, g in zip(want[:-1], got[:-1]):
        assert g.dtype == torch.uint8
        assert np.array_equal(g[0].numpy(), np.array(w))


def test_cli_direct_matches_jax(tmp_path, capsys):
    """`cli direct` prints the JAX command's JSON keys with close values and
    writes direct_<fi>.png.  The losses' pixel sums run in another order
    than XLA's, so the parameters drift with the Adam steps (ROADMAP C7):
    on an FMA host, at 60 steps, 2.4e-7 in the parameters and 3.8e-6 dB in
    `psnr_after`; at the default 300, 1.54e-5 and 0.013 dB.  Held at 60
    steps to CLI_PARAM_ATOL and CLI_PSNR_ATOL."""
    import json
    import os

    from gme_tpu.cli import main as jax_cli
    from gme_tpu_torch.cli import main as torch_cli
    from gme_tpu_torch.io.video import write_y4m

    img = _smooth_image(48, 64)
    curr = T.warp_backward(_t(img), _p([1.5, 0, 0, -1.0, 0, 0]), "affine")
    clip = str(tmp_path / "pair.y4m")
    write_y4m(clip, [img, img, torch.round(curr).clamp(0, 255).to(torch.uint8).numpy()])
    argv = ["direct", "-v", clip, "-fi", "2", "-f", "2", "--model", "affine", "--iterations", "60"]
    jax_cli(argv + ["-o", str(tmp_path / "jax"), "--platform", "cpu"])
    want = json.loads(capsys.readouterr().out)
    torch_cli(argv + ["-o", str(tmp_path / "port"), "--platform", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == ["model", "parameters", "psnr_after", "psnr_before"]
    assert got["model"] == want["model"] == "affine"
    np.testing.assert_allclose(got["parameters"], want["parameters"], rtol=0, atol=CLI_PARAM_ATOL)
    assert abs(got["psnr_before"] - want["psnr_before"]) < 1e-4
    assert abs(got["psnr_after"] - want["psnr_after"]) < CLI_PSNR_ATOL
    assert got["psnr_after"] > got["psnr_before"] + 6
    assert os.listdir(tmp_path / "port") == ["direct_2.png"]


def test_psnr_of_float_frames_matches_jax():
    """PSNR of a float frame (warp_backward's output) against a uint8 frame
    takes the float32 difference, as the JAX psnr does: no truncation."""
    from gme_tpu.ops.metrics import psnr as jax_psnr

    img = _smooth_image(48, 64)
    p = np.array([0.4, 0, 0, -0.3, 0, 0], np.float32)
    warped = np.array(J.warp_backward(jnp.asarray(img), jnp.asarray(p), "affine"))
    assert not np.array_equal(warped, np.trunc(warped))
    for a, b in ((img, warped), (warped, img), (warped, warped)):
        want = float(jax_psnr(jnp.asarray(a), jnp.asarray(b)))
        got = psnr(_t(a)[None], _t(b)[None])
        assert got.dtype == torch.float32
        assert abs(float(got[0]) - want) <= 1e-4, (got, want)
    truncated = float(psnr(_t(img)[None], _t(warped).to(torch.uint8)[None])[0])
    assert abs(truncated - float(jax_psnr(jnp.asarray(img), jnp.asarray(warped)))) > 1e-3
