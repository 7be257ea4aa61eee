"""Package-level contracts of the PyTorch port: no JAX, the configs carried
across from the JAX package, the public API against the JAX package's, a
kernel loader that raises, the configurations off the default path against
the JAX package, and what still raises."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import gme_tpu
import gme_tpu.models.gme as jgme
from gme_tpu.config import BBMEConfig as JaxBBMEConfig
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.config import MeshConfig as JaxMeshConfig
from gme_tpu.config import PipelineConfig as JaxPipelineConfig
from gme_tpu.models.gme import gme_pipeline_batch as jax_pipeline_batch
from gme_tpu.ops import bbme as jbbme
import gme_tpu_torch
import gme_tpu_torch.models.gme as tgme
from gme_tpu_torch.config import (
    DIAMOND, EXHAUSTIVE, MAE, THREESTEP, TWODLOG, BBMEConfig, GMEConfig, MeshConfig,
    PipelineConfig,
)
from gme_tpu_torch.models.gme import gme_pipeline_batch
from gme_tpu_torch.ops import bbme
from gme_tpu_torch.ops import cuda_kernels
from test_torch_ops import PARAM_ATOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = (
        "import sys, gme_tpu_torch, gme_tpu_torch.ops.cuda_kernels, "
        "gme_tpu_torch.ops.bbme, gme_tpu_torch.models.gme, "
        "gme_tpu_torch.models.hierarchical_bbme, gme_tpu_torch.pipeline.results, "
        "gme_tpu_torch.cli, gme_tpu_torch.io.video, gme_tpu_torch.io.writers, "
        "gme_tpu_torch.io.draw, gme_tpu_torch.native.loader, "
        "gme_tpu_torch.utils.profiling, gme_tpu_torch.models.direct, "
        "gme_tpu_torch.parallel.mesh, gme_tpu_torch.parallel.data_parallel, "
        "gme_tpu_torch.parallel.spatial, gme_tpu_torch.parallel.multihost\n"
        "assert gme_tpu_torch.native.loader._TRIED is False  # nothing built at import\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gme_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_from_jax_equals_default_field_by_field():
    ported = GMEConfig.from_dict(dataclasses.asdict(JaxGMEConfig()))
    default = GMEConfig()
    assert [f.name for f in dataclasses.fields(GMEConfig)] == [
        f.name for f in dataclasses.fields(JaxGMEConfig)]
    for f in dataclasses.fields(GMEConfig):
        assert getattr(ported, f.name) == getattr(default, f.name), f.name
    assert ported.fast() == default.fast()
    with pytest.raises(ValueError, match="unknown"):
        GMEConfig.from_dict({"no_such_field": 1})


def test_pipeline_config_from_jax():
    """The whole driver state carries across: nested gme and mesh dicts
    become their configs; every config has the JAX fields, defaults,
    `replace` and (GMEConfig) `bbme()`."""
    for jcls, cls in ((JaxBBMEConfig, BBMEConfig), (JaxGMEConfig, GMEConfig),
                      (JaxMeshConfig, MeshConfig), (JaxPipelineConfig, PipelineConfig)):
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(jcls)]
        assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
    jcfg = JaxPipelineConfig(frame_distance=2, batch_size=24, resume=True, adaptive=True,
                             gme=JaxGMEConfig(block_size=8, volume_radius=20),
                             mesh=JaxMeshConfig(data=2, space=1))
    cfg = PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    assert isinstance(cfg.gme, GMEConfig) and isinstance(cfg.mesh, MeshConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.mesh.shape == jcfg.mesh.shape == (2, 1)
    assert cfg.replace(batch_size=4).batch_size == 4 and cfg.batch_size == 24
    assert dataclasses.asdict(cfg.gme.bbme()) == dataclasses.asdict(jcfg.gme.bbme())
    assert dataclasses.asdict(cfg.gme.bbme(4)) == dataclasses.asdict(jcfg.gme.bbme(4))
    assert BBMEConfig().replace(block_size=9) == BBMEConfig(block_size=9)
    for bad in ({"no_such_field": 1}, {"gme": {"no_such_field": 1}}, {"mesh": {"rows": 2}}):
        with pytest.raises(ValueError, match="unknown"):
            PipelineConfig.from_dict(bad)


def test_public_api_matches_jax():
    """What `gme_tpu` exports, `gme_tpu_torch` exports; the model functions
    have the JAX signatures and defaults."""
    assert set(gme_tpu.__all__) <= set(gme_tpu_torch.__all__)
    for name in ("dense_motion_estimation", "first_parameter_estimation",
                 "best_affine_parameters", "best_affine_parameters_robust",
                 "global_motion_estimation", "motion_compensation"):
        want = inspect.signature(getattr(jgme, name)).parameters
        got = inspect.signature(getattr(tgme, name)).parameters
        assert list(got) == list(want), name
        for param in want:
            a, b = got[param].default, want[param].default
            if dataclasses.is_dataclass(b):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, param)


def _pairs():
    rng = np.random.RandomState(3)
    low = rng.randint(0, 256, (2, 17, 21)).astype(np.float32)
    prev = np.kron(low, np.ones((1, 4, 4), np.float32))[:, :64, :80].astype(np.uint8)
    curr = np.stack([np.roll(prev[0], (2, -3), (0, 1)), np.roll(prev[1], (-4, 5), (0, 1))])
    return prev, curr


@pytest.mark.parametrize("name", ["first_parameter_estimation", "best_affine_parameters",
                                  "global_motion_estimation", "motion_compensation",
                                  "dense_motion_estimation"])
def test_model_functions_equal_jax(name):
    """Each function on a batch equals the JAX function on each pair:
    parameters exactly where the host has FMA (else to 1e-5, ROADMAP queue
    C), integers exactly."""
    prev, curr = _pairs()
    jcfg = JaxGMEConfig(search_impl="volume")
    got = getattr(tgme, name)(torch.from_numpy(prev), torch.from_numpy(curr), GMEConfig())
    jax_fn = getattr(jgme, name)
    want = np.asarray(jax.jit(jax.vmap(lambda p, c: jax_fn(p, c, jcfg)))(
        jnp.asarray(prev), jnp.asarray(curr)))
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PARAM_ATOL, err_msg=name)
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    field, diag = tgme.dense_motion_estimation(torch.from_numpy(prev), torch.from_numpy(curr),
                                               return_diagnostics=True)
    assert field.shape == (2, 32, 40, 2) and diag["volume_edge_hits"].shape == (2,)


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing nvcc raises; the loader never returns None."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_kernels, "_DEFAULT_CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_kernels, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_kernels, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_kernels.load_library()
    assert not (tmp_path / "build").exists()


def _frames():
    g = torch.Generator().manual_seed(0)
    prev = torch.randint(0, 256, (1, 64, 64), dtype=torch.uint8, generator=g)
    return prev, torch.roll(prev, (2, 2), (1, 2))


@pytest.mark.parametrize("cfg,item", [
    (GMEConfig(searching_procedure=EXHAUSTIVE), "A9"),
    (GMEConfig(searching_procedure=THREESTEP), "A9"),
    (GMEConfig(searching_procedure=TWODLOG), "A9"),
    (GMEConfig(search_impl="gather"), "A9"),
    (GMEConfig(volume_radius=60), "B6"),  # bs + D - 1 > 128 at bs 16
    (GMEConfig(dense_volume_radius=3), "B5"),  # D = 7 < 8
])
def test_unported_configs_raise(cfg, item):
    """Configurations off the default path, each labelled with the ROADMAP
    item that carries it (A9 the searches, B5 the row-offset kernel, B6 the
    cross kernel; the name is the raise they met before those landed): the
    whole step equals the JAX package's."""
    prev, curr = _frames()
    jcfg = JaxGMEConfig(**dataclasses.asdict(cfg))
    if jcfg.search_impl == "auto":
        jcfg = jcfg.replace(search_impl="volume")
    want = jax_pipeline_batch(jnp.asarray(prev.numpy()), jnp.asarray(curr.numpy()), jcfg)
    got = gme_pipeline_batch(prev, curr, cfg)
    for k in ("model_motion_field", "compensated", "diff_curr_comp", "volume_edge_hits"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["parameters"].numpy(), np.asarray(want["parameters"]),
                               rtol=0, atol=PARAM_ATOL)


def test_unported_searches_raise():
    """What the port refuses: an unknown engine.  The name recalls the
    volume-engine diamond walk above bs 16, which raised (ROADMAP A9) until
    its select-chain rank map was ported; it now equals JAX's (MAE, where
    both packages' volumes are exact)."""
    prev, curr = _frames()
    kw = dict(block_size=20, searching_procedure=DIAMOND, pnorm_distance=MAE,
              search_impl="volume")
    got = bbme.get_motion_field(prev, curr, **kw)
    want = jbbme.get_motion_field_jit(jnp.asarray(prev[0].numpy()), jnp.asarray(curr[0].numpy()), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    volume = bbme.compute_cost_volume(prev, curr, 20, 2, MAE)
    origins = bbme._block_origins(3, 3, 20, "cpu")
    best, hits = bbme.diamond_walk_volume(volume, origins, 64, 64, 20, 2)
    walk = jax.jit(lambda v, o: jbbme.diamond_walk_volume(v, o, 64, 64, 20, 2, with_diagnostics=True))
    want_best = walk(jnp.asarray(volume[0].numpy()), jnp.asarray(origins.numpy()))
    np.testing.assert_array_equal(best[0].numpy(), np.asarray(want_best[0]))
    assert int(hits[0]) == int(want_best[1])
    for sp in (EXHAUSTIVE, THREESTEP, TWODLOG, DIAMOND):
        with pytest.raises(ValueError, match="search_impl"):
            bbme.get_motion_field(prev, curr, searching_procedure=sp, search_impl="nope")
    field = bbme.get_motion_field(prev, curr, block_size=20, searching_procedure=DIAMOND,
                                  search_impl="gather", pnorm_distance=MAE)
    assert field.shape == (1, 3, 3, 2)
