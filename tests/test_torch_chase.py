"""The volume chase (`cuda_kernels.chase_volume`, its plain version on the
CPU) against the rank-map route it replaces on the search paths.

`chase_volume_plain` must return what `_succ_map_packed` /
`_succ_map_select` followed by `chase_fixpoint_plain` return, and what the
JAX package's `_succ_map` followed by its Pallas `chase_fixpoint` (interpret
mode, a few cases) returns: on random volumes whose cells' clamp bounds lie
inside and outside the volume, where lo > hi on either clamp rule, where
every candidate is +inf, on exact ties, on costs above 2**24 (bs 20, the
select chain), and cut at max_iters 1, 3 and 4096.  Every output is an
integer or a flag, so every comparison is exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gme_tpu.ops import bbme as jbbme
from gme_tpu.ops import pallas_kernels as pk
from gme_tpu_torch.config import MSE
from gme_tpu_torch.ops import bbme as tbbme
from gme_tpu_torch.ops import cuda_kernels as K

ITERS = (1, 3, 4096)


def _bounds(origins, H, W, bs):
    og = origins.reshape(-1, 2)
    return torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                       dim=1).to(torch.int32).contiguous()


def _random_volume(rng, B, H, W, bs, R, kind):
    """(B, nbh, nbw, D*D) float32 volumes with the frame mask applied:
    "random" integer costs below 2**24, "ties" costs in 0..2 (ties
    everywhere), "inf" whole cells of +inf beside random ones, "big" costs
    up to 2**26 (bs 20 sums pass 2**24: floats spaced by 4 and more)."""
    nbh, nbw, D = H // bs, W // bs, 2 * R + 1
    shape = (B, nbh, nbw, D * D)
    if kind == "ties":
        vol = rng.randint(0, 3, shape)
    elif kind == "big":
        vol = rng.randint(2**24 - 2**16, 2**26, shape) & ~3
    else:
        vol = rng.randint(0, 2**24, shape)
    vol = torch.from_numpy(vol.astype(np.float32))
    if kind == "inf":
        vol[:, ::2, 1::2] = float("inf")
    offsets = torch.arange(-R, R + 1, dtype=torch.int32)
    valid_r = tbbme._offset_mask(nbh, bs, H, offsets)
    valid_c = tbbme._offset_mask(nbw, bs, W, offsets)
    mask = (valid_r[:, None, :, None] & valid_c[None, :, None, :]).reshape(nbh, nbw, D * D)
    return vol.masked_fill_(~mask, float("inf"))


def _rank_route(vol, H, W, bs, R, iters, packed):
    """The rank-map route: the map of the packed builder or the select
    chain, then the rank-map chase."""
    D = 2 * R + 1
    origins = tbbme._block_origins(H // bs, W // bs, bs, "cpu")
    build = tbbme._succ_map_packed if packed else tbbme._succ_map_select
    rank = build(vol, origins, H, W, bs, R).reshape(-1, D * D)
    bounds = _bounds(origins.expand(vol.shape[:-1] + (2,)), H, W, bs)
    return K.chase_fixpoint_plain(rank, bounds, D, R, iters), bounds


def _assert_routes_agree(vol, H, W, bs, R, packed):
    D = 2 * R + 1
    for iters in ITERS:
        (want_o, want_t), bounds = _rank_route(vol, H, W, bs, R, iters, packed)
        got_o, got_t = K.chase_volume(vol.reshape(-1, D * D), bounds, D, R, iters, packed)
        assert got_o.dtype == torch.int32 and got_t.dtype == torch.bool
        assert torch.equal(got_o, want_o), iters
        assert torch.equal(got_t, want_t), iters


# (H, W, bs, R): cells whose clamp bounds lie inside the volume (small
# frames, a radius past them), outside it (a large frame, a small radius),
# and lo > hi (H == bs, W == bs).
GEOMETRIES = [(48, 64, 8, 5), (24, 40, 4, 9), (96, 128, 16, 3), (8, 64, 8, 4), (48, 8, 8, 4),
              (16, 16, 16, 3)]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties", "inf"])
@pytest.mark.parametrize("H,W,bs,R", GEOMETRIES)
def test_volume_chase_equals_rank_map_route(H, W, bs, R, kind, packed):
    rng = np.random.RandomState(H * 7 + W + bs + R)
    vol = _random_volume(rng, 2, H, W, bs, R, kind)
    _assert_routes_agree(vol, H, W, bs, R, packed)


@pytest.mark.parametrize("H,W", [(100, 140), (20, 100), (100, 20)])
def test_volume_chase_above_2_24_equals_select_chain(H, W):
    """bs 20: costs pass 2**24, the select chain's route; lo > hi where a
    frame edge is one block."""
    bs, R = 20, 6
    rng = np.random.RandomState(H + W)
    vol = _random_volume(rng, 2, H, W, bs, R, "big")
    assert float(vol[torch.isfinite(vol)].max()) > 2**24
    _assert_routes_agree(vol, H, W, bs, R, packed=bs * bs * 255 * 255 < 2**24)


def test_clamp_rules_differ_where_lo_exceeds_hi():
    """Where H == bs the two rank-map builders differ (a candidate below lo
    reads lo on the packed rule, the clip hi == lo - 1 on the select chain
    when it lands there), and each route of the volume chase follows its
    own builder."""
    H, W, bs, R = 8, 64, 8, 4
    rng = np.random.RandomState(4)
    vol = _random_volume(rng, 1, H, W, bs, R, "random")
    D = 2 * R + 1
    origins = tbbme._block_origins(1, W // bs, bs, "cpu")
    packed = tbbme._succ_map_packed(vol, origins, H, W, bs, R)
    select = tbbme._succ_map_select(vol, origins, H, W, bs, R)
    assert not torch.equal(packed, select)
    bounds = _bounds(origins.expand(vol.shape[:-1] + (2,)), H, W, bs)
    for rank, rule in ((packed, True), (select, False)):
        want = K.chase_fixpoint_plain(rank.reshape(-1, D * D), bounds, D, R, 4096)
        got = K.chase_volume(vol.reshape(-1, D * D), bounds, D, R, 4096, rule)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_all_inf_candidates_stop_the_walk():
    """Every candidate +inf: rank 0, the step stays put, the walk stops at
    the start (unless the clamp moves it), and only the start is tested
    for the ring."""
    H, W, bs, R = 48, 64, 8, 5
    D = 2 * R + 1
    vol = torch.full((1, H // bs, W // bs, D * D), float("inf"))
    origins = tbbme._block_origins(H // bs, W // bs, bs, "cpu")
    bounds = _bounds(origins.expand(vol.shape[:-1] + (2,)), H, W, bs)
    o, t = K.chase_volume(vol.reshape(-1, D * D), bounds, D, R, 4096, True)
    # The last block row and column start clamped to -1 (hi = -1 there).
    start = torch.where(bounds[:, 1] < 0, -1, 0) + R
    start = start * D + torch.where(bounds[:, 3] < 0, -1, 0) + R
    assert torch.equal(o, start.to(torch.int32)) and not t.any()
    for rule in (True, False):
        (want_o, want_t), _ = _rank_route(vol, H, W, bs, R, 4096, rule)
        assert torch.equal(o, want_o) and torch.equal(t, want_t)


def test_real_volume_walks_equal_rank_map_route():
    """Cost volumes of shifted random frames (ring visits and clamps at
    shift 9 > R), the chase of tests/test_torch_cuda.py."""
    for H, W, bs, R, shift in [(48, 64, 8, 5, 9), (60, 80, 2, 16, 3), (64, 96, 16, 32, 20)]:
        rng = np.random.RandomState(shift)
        base = rng.randint(0, 256, (2, H + shift, W + shift)).astype(np.uint8)
        prev = torch.from_numpy(base[:, :H, :W].copy())
        curr = torch.from_numpy(base[:, shift:, shift:].copy())
        vol = tbbme.compute_cost_volume(prev, curr, bs, R, MSE)
        _assert_routes_agree(vol, H, W, bs, R, packed=True)


@pytest.mark.parametrize("case", ["clamps", "lo>hi", "ties", "bs20"])
def test_volume_chase_equals_jax_chase_kernel(case):
    """Against the JAX package's `_succ_map` and its Pallas `chase_fixpoint`
    in interpret mode, on one pair."""
    H, W, bs, R, kind = {"clamps": (48, 64, 8, 5, "random"), "lo>hi": (8, 64, 8, 4, "random"),
                         "ties": (24, 40, 4, 6, "ties"), "bs20": (20, 100, 20, 3, "big")}[case]
    rng = np.random.RandomState(11)
    vol = _random_volume(rng, 1, H, W, bs, R, kind)
    D = 2 * R + 1
    nbh, nbw = H // bs, W // bs
    origins = jbbme._block_origins(nbh, nbw, bs)
    rank = jbbme._succ_map(jnp.asarray(vol[0].numpy()), origins, H, W, bs, R)
    bounds = _bounds(tbbme._block_origins(nbh, nbw, bs, "cpu"), H, W, bs)
    jb = np.concatenate([bounds.numpy(), np.zeros_like(bounds.numpy())], axis=1)
    for iters in ITERS:
        want_o, want_t = pk.chase_fixpoint(jnp.asarray(rank).reshape(nbh * nbw, D * D),
                                           jnp.asarray(jb), D, R, iters, interpret=True)
        got_o, got_t = K.chase_volume(vol.reshape(-1, D * D), bounds, D, R, iters,
                                      tbbme._packed_rule(bs))
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_search_paths_build_no_rank_map(monkeypatch):
    """The volume-engine diamond walks on the volume: no rank map is built
    on the search or GME paths."""
    import gme_tpu_torch

    def refuse(*args, **kwargs):
        raise AssertionError("a rank map was built")

    monkeypatch.setattr(tbbme, "_succ_map_packed", refuse)
    monkeypatch.setattr(tbbme, "_succ_map_select", refuse)
    rng = np.random.RandomState(0)
    prev = torch.from_numpy(rng.randint(0, 256, (2, 64, 80)).astype(np.uint8))
    curr = torch.roll(prev, (2, -3), (1, 2))
    gme_tpu_torch.gme_pipeline_batch(prev, curr)
    for bs in (12, 20):
        tbbme.get_motion_field(prev, curr, block_size=bs, searching_procedure=3, volume_radius=6,
                               search_impl="volume")


def test_chase_volume_checks_inputs():
    vol = torch.zeros((3, 25))
    bounds = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="2R"):
        K.chase_volume(vol, bounds, 5, 3, 10, True)
    with pytest.raises(ValueError, match="dtype"):
        K.chase_volume(vol.double(), bounds, 5, 2, 10, True)
    with pytest.raises(ValueError, match="shape"):
        K.chase_volume(vol, bounds[:2], 5, 2, 10, True)
    with pytest.raises(ValueError, match="device"):
        K.chase_volume(vol.to("meta"), bounds.to("meta"), 5, 2, 10, True)
