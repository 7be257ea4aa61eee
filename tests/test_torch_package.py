"""Package-level contracts of the PyTorch port: no JAX, the config carried
across from the JAX package, a kernel loader that raises, and unported
configurations that raise."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu_torch.config import DIAMOND, EXHAUSTIVE, MAE, THREESTEP, TWODLOG, GMEConfig
from gme_tpu_torch.models.gme import gme_pipeline_batch
from gme_tpu_torch.ops import bbme
from gme_tpu_torch.ops import cuda_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = (
        "import sys, gme_tpu_torch, gme_tpu_torch.ops.cuda_kernels, "
        "gme_tpu_torch.ops.bbme, gme_tpu_torch.models.gme\n"
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
    prev, curr = _frames()
    with pytest.raises(NotImplementedError, match=item):
        gme_pipeline_batch(prev, curr, cfg)


def test_unported_searches_raise():
    prev, curr = _frames()
    with pytest.raises(NotImplementedError, match="B5"):  # MAE at bs >= 8
        bbme.get_motion_field(prev, curr, block_size=16, pnorm_distance=MAE)
    with pytest.raises(NotImplementedError, match="B5"):  # MSE at bs > 16
        bbme.get_motion_field(prev, curr, block_size=20, searching_procedure=DIAMOND)
    with pytest.raises(NotImplementedError, match="A9"):  # rank map beyond bs 16
        volume = torch.zeros((1, 3, 3, 25))
        bbme.diamond_walk_volume(volume, bbme._block_origins(3, 3, 20, "cpu"), 64, 64, 20, 2)
    with pytest.raises(ValueError, match="search_impl"):
        bbme.get_motion_field(prev, curr, search_impl="nope")
