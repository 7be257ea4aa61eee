"""The port's meshes against the JAX package's (`tests/test_parallel.py`).

Every mesh runs on the CPU here, its slots all naming the CPU (the
counterpart of the JAX tests' eight virtual XLA devices).  Each case holds
the port's meshed step to JAX's single-device step as `_assert_matches_single`
does (parameters exact on FMA hosts, `PARAM_ATOL` off them; every integer
output exact; PSNR to 1e-4 dB) and to the port's own 1x1 step bit for bit,
PSNR included (both take it from an exact integer SSE).  One case also holds
it to JAX's `make_spatial_pipeline` on the eight virtual devices.  Then the
halo exchange at multi-hop widths, the banded pyramid, the stacking of the
bands into one kernel call a level, and the driver with a mesh.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gme_tpu.config import EXHAUSTIVE, THREESTEP
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.models.gme import gme_pipeline_step_jit
from gme_tpu.ops.pyramid import pyrdown as jax_pyrdown
from gme_tpu.parallel import spatial as jsp
from gme_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gme_tpu_torch.config import GMEConfig, MeshConfig, PipelineConfig
from gme_tpu_torch.io.video import write_y4m
from gme_tpu_torch.models.gme import gme_pipeline_batch
from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.parallel import spatial
from gme_tpu_torch.parallel.data_parallel import make_sharded_pipeline
from gme_tpu_torch.parallel.mesh import make_mesh
from gme_tpu_torch.parallel.spatial import make_spatial_pipeline, validate_spatial_shapes
from test_torch_ops import PARAM_ATOL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the frames are small, so it is as fast, and it
    keeps this file fast beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INT_KEYS = ("model_motion_field", "compensated", "diff_curr_prev", "diff_curr_comp",
            "volume_edge_hits")


def _pairs(rng, B, H, W):
    prev = rng.randint(0, 256, (B, H, W), np.uint8)
    curr = np.stack(
        [np.roll(p, (rng.randint(-2, 3), rng.randint(-2, 3)), (0, 1)) for p in prev]
    )
    return prev, curr


def _cpu_mesh(data, space):
    return make_mesh(data, space, ["cpu"] * (data * space))


def _jax_cfg(cfg: GMEConfig) -> JaxGMEConfig:
    return JaxGMEConfig(**{f: getattr(cfg, f) for f in JaxGMEConfig.__dataclass_fields__})


def _assert_matches_single(out, prev, curr, cfg):
    """The meshed outputs against JAX's single-device step, pair by pair,
    and against the port's own 1x1 batch bit for bit."""
    jcfg = _jax_cfg(cfg)
    for k in range(prev.shape[0]):
        single = jax.device_get(gme_pipeline_step_jit(prev[k], curr[k], jcfg))
        np.testing.assert_allclose(out["parameters"][k].numpy(), single["parameters"],
                                   rtol=0, atol=PARAM_ATOL)
        for key in INT_KEYS[:-1]:
            assert np.array_equal(out[key][k].numpy(), single[key]), (k, key)
        assert abs(float(out["psnr"][k]) - float(single["psnr"])) < 1e-4
    one = gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr), cfg)
    for key in one:
        assert torch.equal(out[key], one[key]), key


def _spatial(rng, cfg, B, H, W, data, space):
    prev, curr = _pairs(rng, B, H, W)
    step = make_spatial_pipeline(_cpu_mesh(data, space), cfg, H, W)
    return step(torch.from_numpy(prev), torch.from_numpy(curr)), prev, curr


def test_data_parallel_matches_single_device(rng):
    cfg = GMEConfig(search_impl="volume")
    prev, curr = _pairs(rng, 8, 64, 80)
    step = make_sharded_pipeline(_cpu_mesh(8, 1), cfg)
    out = step(torch.from_numpy(prev), torch.from_numpy(curr))
    _assert_matches_single(out, prev, curr, cfg)


def test_spatial_full_parity_block_aligned(rng):
    """Bands of 32 rows = 2 block rows of 16; also against JAX's own
    spatial pipeline on the eight virtual devices."""
    cfg = GMEConfig(search_impl="volume")
    out, prev, curr = _spatial(rng, cfg, 2, 128, 80, 2, 4)
    _assert_matches_single(out, prev, curr, cfg)
    jstep = jsp.make_spatial_pipeline(jax_make_mesh(data=2, space=4), _jax_cfg(cfg), 128, 80)
    want = jax.device_get(jstep(jnp.asarray(prev), jnp.asarray(curr)))
    np.testing.assert_allclose(out["parameters"].numpy(), want["parameters"], rtol=0,
                               atol=PARAM_ATOL)
    for key in INT_KEYS:
        assert np.array_equal(out[key].numpy(), want[key]), key
    np.testing.assert_allclose(out["psnr"].numpy(), want["psnr"], rtol=0, atol=1e-4)


def test_spatial_full_parity_straddling_blocks(rng):
    """Bands of 24 rows with 16-px blocks: blocks straddle band edges; the
    W=84 remainder columns exercise partial coverage."""
    cfg = GMEConfig(search_impl="volume")
    out, prev, curr = _spatial(rng, cfg, 2, 96, 84, 2, 4)
    _assert_matches_single(out, prev, curr, cfg)


def test_spatial_exhaustive_parity(rng):
    cfg = GMEConfig(search_impl="volume", searching_procedure=EXHAUSTIVE)
    for H, W in ((128, 80), (96, 84)):
        out, prev, curr = _spatial(rng, cfg, 2, H, W, 2, 4)
        _assert_matches_single(out, prev, curr, cfg)


def test_spatial_space2(rng):
    cfg = GMEConfig(search_impl="volume")
    out, prev, curr = _spatial(rng, cfg, 4, 80, 64, 4, 2)
    _assert_matches_single(out, prev, curr, cfg)


def test_spatial_params_identical_across_devices(rng):
    """Every band solves from the same psum'd moments: one finite parameter
    row per pair."""
    cfg = GMEConfig(search_impl="volume")
    out, _, _ = _spatial(rng, cfg, 2, 128, 80, 2, 4)
    assert out["parameters"].shape == (2, 6)
    assert bool(torch.isfinite(out["parameters"]).all())


def test_spatial_shape_validation():
    with pytest.raises(ValueError, match="divisible"):
        make_spatial_pipeline(_cpu_mesh(2, 4), GMEConfig(), 100, 80)  # 100 % 16 != 0
    with pytest.raises(ValueError, match=">= 4 rows"):
        validate_spatial_shapes(48, 4, GMEConfig())
    with pytest.raises(ValueError, match="2D-log"):
        validate_spatial_shapes(128, 4, GMEConfig(searching_procedure=2))
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(2, 4, ["cpu"] * 4)


def test_process_video_with_mesh(tmp_path, rng):
    """The driver reads PipelineConfig.mesh: meshed runs (spatial and data
    parallel) give the 1x1 run's records exactly and the JAX meshed run's
    to 1e-4 dB."""
    import json

    from gme_tpu.config import MeshConfig as JaxMeshConfig
    from gme_tpu.config import PipelineConfig as JaxPipelineConfig
    from gme_tpu.pipeline.results import process_video as jax_process_video
    from gme_tpu_torch.pipeline.results import process_video

    H, W, N = 64, 48, 6
    frames = [rng.randint(0, 256, (H, W), np.uint8)]
    for i in range(1, N):
        frames.append(np.roll(frames[0], (i, -i), (0, 1)))
    path = str(tmp_path / "tiny.y4m")
    write_y4m(path, frames)

    def records(root):
        with open(os.path.join(root, "tiny", "psnr_records.json")) as f:
            return json.load(f)

    gme = GMEConfig(search_impl="volume")
    base = PipelineConfig(gme=gme, batch_size=4, write_images=False)
    single = process_video(path, str(tmp_path / "single"), base, device="cpu")
    for name, mesh in (("spatial", MeshConfig(data=2, space=4)), ("dp", MeshConfig(data=2))):
        meshed = process_video(path, str(tmp_path / name), base.replace(mesh=mesh), device="cpu")
        assert single["pairs_processed"] == meshed["pairs_processed"] == N - 1
        assert records(str(tmp_path / name)) == records(str(tmp_path / "single"))
        assert meshed["volume_edge_hits"] == single["volume_edge_hits"]
    jax_process_video(path, out_root=str(tmp_path / "jax"), cfg=JaxPipelineConfig(
        gme=_jax_cfg(gme), batch_size=4, write_images=False,
        mesh=JaxMeshConfig(data=2, space=4)))
    want, got = records(str(tmp_path / "jax")), records(str(tmp_path / "spatial"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, k


def test_spatial_validate_rejects_moment_overflow():
    cfg = GMEConfig()
    validate_spatial_shapes(720, 2, cfg, W=1280)  # 720p: fine
    with pytest.raises(ValueError, match="moment bound"):
        validate_spatial_shapes(4096, 2, cfg, W=4096)


def test_spatial_threestep_parity(rng):
    cfg = GMEConfig(search_impl="volume", searching_procedure=THREESTEP)
    for H, W in ((128, 80), (96, 84)):
        out, prev, curr = _spatial(rng, cfg, 2, H, W, 2, 4)
        _assert_matches_single(out, prev, curr, cfg)


def test_spatial_exhaustive_sw8_parity(rng):
    """Exhaustive at the BBME command line's -sw 8: multi-hop halos on
    6-row coarsest bands."""
    cfg = GMEConfig(search_impl="volume", searching_procedure=EXHAUSTIVE, search_window=8)
    out, prev, curr = _spatial(rng, cfg, 2, 96, 84, 2, 4)
    _assert_matches_single(out, prev, curr, cfg)


@pytest.mark.slow
def test_spatial_720p_shape_parity(rng):
    """720x1280 at space 4 and the production radii, one pair."""
    cfg = GMEConfig(search_impl="volume")
    out, prev, curr = _spatial(rng, cfg, 1, 720, 1280, 1, 4)
    _assert_matches_single(out, prev, curr, cfg)


# ---------------------------------------------------------------------------
# The band program's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space,lh,top,bottom", [
    (4, 6, 16, 16),   # the dense init's halo on 6-row coarsest bands: 3 hops
    (4, 6, 8, 17),    # exhaustive at sw 8 (bottom sw + bs - 1 + ext)
    (2, 45, 2, 2),    # the pyramid's 2-row halo
    (4, 45, 32, 50),  # a 720p dense-init band under a level's radius
])
def test_extend_rows_matches_jax_ppermute(space, lh, top, bottom):
    """The halo exchange against JAX's multi-hop ppermute under shard_map
    on the virtual devices: rows from farther bands, zeros past the frame."""
    rng = np.random.RandomState(11)
    W = 7
    frame = rng.randint(0, 256, (1, space * lh, W)).astype(np.float32)
    mesh = jax_make_mesh(data=1, space=space)
    f = jax.shard_map(
        lambda x: jsp.extend_rows(x[0], top, bottom, "space", space)[None],
        mesh=mesh, in_specs=P("data", "space"), out_specs=P("data", "space"), check_vma=False)
    want = np.array(f(jnp.asarray(frame)))[0].reshape(space, lh + top + bottom, W)
    bands = [torch.from_numpy(frame[:, k * lh:(k + 1) * lh]) for k in range(space)]
    got = spatial.extend_rows(bands, top, bottom)
    for k in range(space):
        assert np.array_equal(got[k][0].numpy(), want[k]), k


@pytest.mark.parametrize("H,W,space", [(96, 84, 4), (128, 81, 4), (80, 64, 2), (48, 30, 6)])
def test_pyramid_band_equals_full_frame_pyrdown(H, W, space):
    """The banded pyramid equals the full-frame cv2.pyrDown of the JAX
    package at every level (REFLECT_101 at the frame's edges only)."""
    rng = np.random.RandomState(12)
    frame = rng.randint(0, 256, (2, H, W), np.uint8)
    lh = H // space
    bands = [torch.from_numpy(frame[:, k * lh:(k + 1) * lh]) for k in range(space)]
    pyr = spatial._pyramids_band(bands, 3)
    want = [frame[0]]
    for _ in range(2):
        want.insert(0, np.array(jax_pyrdown(jnp.asarray(want[0]))))
    for level, w in zip(pyr, want):
        assert np.array_equal(torch.cat(level, dim=1)[0].numpy(), w)


def test_spatial_stacks_the_bands_into_one_call_a_level(rng, monkeypatch):
    """Bands on one device make one call of each volume wrapper and of the
    chase a level, as many as the single-device step makes."""
    names = ("cost_volume_small_block", "cost_volume_mse_block", "cost_volume_rowoffset",
             "cost_volume_cross", "chase_volume")
    calls = {}

    def counting(name, fn):
        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    for n in names:
        monkeypatch.setattr(cuda_kernels, n, counting(n, getattr(cuda_kernels, n)))
    cfg = GMEConfig(search_impl="volume")
    prev, curr = _pairs(rng, 2, 96, 84)
    calls.clear()
    make_spatial_pipeline(_cpu_mesh(1, 4), cfg, 96, 84)(torch.from_numpy(prev),
                                                        torch.from_numpy(curr))
    banded = dict(calls)
    calls.clear()
    gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr), cfg)
    assert banded == calls == {"cost_volume_small_block": 1, "cost_volume_mse_block": 2,
                               "chase_volume": 3}, (banded, calls)


@pytest.mark.parametrize("bs,R,T,nbw,gb0,pnorm", [
    (2, 16, 23, 10, 0, 1), (2, 16, 23, 10, 23, 1), (16, 32, 3, 5, 4, 1), (16, 12, 2, 4, 5, 1),
    (12, 5, 2, 3, 1, 0), (4, 3, 4, 6, 2, 0),
])
def test_compute_cost_volume_band_matches_jax(bs, R, T, nbw, gb0, pnorm):
    """The band volume on uint8 bands through the port's kernels' plain
    versions equals JAX's on the same float32 bands, +inf mask included
    (rows past the frame's bottom)."""
    from gme_tpu.ops import bbme as jbbme
    from gme_tpu_torch.ops import bbme

    rng = np.random.RandomState(bs * 100 + R)
    prev = rng.randint(0, 256, (T * bs, nbw * bs)).astype(np.uint8)
    curr = rng.randint(0, 256, (T * bs + 2 * R, nbw * bs + 2 * R)).astype(np.uint8)
    H, W = (gb0 + T) * bs - bs // 2, nbw * bs + 1
    want = jbbme.compute_cost_volume_band(jnp.asarray(prev, jnp.float32),
                                          jnp.asarray(curr, jnp.float32), gb0, (H, W), bs, R,
                                          pnorm)
    got = bbme.compute_cost_volume_band(torch.from_numpy(prev)[None], torch.from_numpy(curr)[None],
                                        gb0, (H, W), bs, R, pnorm)
    assert np.array_equal(got[0].numpy(), np.asarray(want))
    stacked = bbme.compute_cost_volume_band(
        torch.from_numpy(np.stack([prev, prev])), torch.from_numpy(np.stack([curr, curr])),
        torch.tensor([gb0, 0], dtype=torch.int32), (H, W), bs, R, pnorm)
    assert torch.equal(stacked[0], got[0])


def test_diamond_count_mask_and_band_moments_match_jax():
    """`diamond_walk_volume(count_mask=...)` counts only the masked cells'
    ring visits, and `int_moments(row0=...)` offsets the block rows, as the
    JAX functions do; without them the results are unchanged."""
    from gme_tpu.ops import affine as jaff
    from gme_tpu.ops import bbme as jbbme
    from gme_tpu_torch.ops import affine as taff
    from gme_tpu_torch.ops import bbme

    rng = np.random.RandomState(13)
    prev = torch.from_numpy(rng.randint(0, 256, (1, 48, 64)).astype(np.uint8))
    curr = torch.roll(prev, (3, -2), (1, 2))
    R, bs = 2, 8
    volume = bbme.compute_cost_volume(prev, curr, bs, R, 1)
    origins = bbme._block_origins(6, 8, bs, "cpu")
    mask = torch.from_numpy(rng.rand(6, 8) < 0.5)
    best, hits = bbme.diamond_walk_volume(volume, origins, 48, 64, bs, R, count_mask=mask[None])
    best_all, hits_all = bbme.diamond_walk_volume(volume, origins, 48, 64, bs, R)
    want_best, want_hits = jax.jit(lambda v, o, m: jbbme.diamond_walk_volume(
        v, o, 48, 64, bs, R, with_diagnostics=True, count_mask=m))(
        jnp.asarray(volume[0].numpy()), jnp.asarray(origins.numpy()), jnp.asarray(mask.numpy()))
    assert np.array_equal(best[0].numpy(), np.asarray(want_best)) and torch.equal(best, best_all)
    assert int(hits[0]) == int(want_hits) < int(hits_all[0])
    field = torch.from_numpy(rng.randint(-9, 10, (2, 5, 7, 2)).astype(np.int32))
    inl = torch.from_numpy(rng.rand(2, 5, 7) < 0.7)
    got = taff.int_moments(field, inl, 4, row0=torch.tensor([3, 11]))
    for k, r0 in enumerate((3, 11)):
        want = jaff.int_moments(jnp.asarray(field[k].numpy()), jnp.asarray(inl[k].numpy()), 4,
                                row0=r0)
        assert np.array_equal(got[k].numpy(), np.asarray(want))
    assert torch.equal(taff.int_moments(field, inl, 4), taff.int_moments(field, inl, 4, row0=0))


def test_cli_mesh_and_processes(tmp_path, rng, capsys):
    """`results --mesh` and `--num-processes` run from the command line on
    the CPU: the meshed records and the merged shard records equal the 1x1
    run's."""
    import json

    from gme_tpu_torch.cli import main as torch_cli
    from gme_tpu_torch.parallel.multihost import merge_rank_records

    frames = [rng.randint(0, 256, (64, 48), np.uint8)]
    frames += [np.roll(frames[0], (i, -i), (0, 1)) for i in range(1, 6)]
    clip = str(tmp_path / "tiny.y4m")
    write_y4m(clip, frames)
    common = ["results", "-v", clip, "--batch-size", "2", "--no-images", "--platform", "cpu"]

    def records(root, name="psnr_records.json"):
        with open(os.path.join(root, "tiny", name)) as f:
            return json.load(f)

    torch_cli(common + ["-o", str(tmp_path / "one")])
    torch_cli(common + ["-o", str(tmp_path / "mesh"), "--mesh", "data=2,space=2"])
    for r in range(2):
        torch_cli(common + ["-o", str(tmp_path / "procs"), "--num-processes", "2",
                            "--process-id", str(r), "--gop-size", "2"])
    printed = capsys.readouterr().out
    assert printed.count('"pairs_processed"') == 4
    want = records(str(tmp_path / "one"))
    assert records(str(tmp_path / "mesh")) == want
    assert merge_rank_records(str(tmp_path / "procs" / "tiny"), 2) == want
