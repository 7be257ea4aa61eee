"""The port's multi-process orchestration (`tests/test_multihost.py`): GOP
shards across processes, per-rank manifests, restart and resume, stale
manifests, and a real two-process run on a gloo process group, each held
to the single-process run of the port (records exact) and of the JAX
package (1e-4 dB)."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.config import PipelineConfig as JaxPipelineConfig
from gme_tpu.pipeline.results import process_video as jax_process_video
from gme_tpu_torch.config import GMEConfig, PipelineConfig
from gme_tpu_torch.io.video import get_video_frames, write_y4m
from gme_tpu_torch.parallel.multihost import merge_rank_records, process_video_multihost
from gme_tpu_torch.pipeline.results import process_video


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the frames are small, so it is as fast, and it
    keeps this file fast beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_video(tmp_path, H=48, W=64, N=10, name="tiny.y4m"):
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (H, W), np.uint8)
    frames = [np.roll(base, (i, -2 * i), (0, 1)) for i in range(N)]
    path = str(tmp_path / name)
    write_y4m(path, frames)
    return path


_FAST = GMEConfig(volume_radius=8, dense_volume_radius=8)
_JAX_FAST = JaxGMEConfig(volume_radius=8, dense_volume_radius=8, search_impl="volume")


def _records(root, name="psnr_records.json"):
    with open(os.path.join(root, "tiny", name)) as f:
        return json.load(f)


def _single(tmp_path, path):
    """The single-process records of the port and of the JAX package."""
    cfg = PipelineConfig(gme=_FAST, batch_size=4, write_images=False)
    single = process_video(path, out_root=str(tmp_path / "single"), cfg=cfg, device="cpu")
    assert single["pairs_processed"] == 9
    jax_process_video(path, out_root=str(tmp_path / "jax"),
                      cfg=JaxPipelineConfig(gme=_JAX_FAST, batch_size=4, write_images=False))
    want = _records(str(tmp_path / "jax"))
    got = _records(str(tmp_path / "single"))
    assert sorted(got) == sorted(want) and all(abs(got[k] - want[k]) < 1e-4 for k in want)
    return got


def test_y4m_roundtrip(tmp_path):
    path = _tiny_video(tmp_path)
    frames = get_video_frames(path)
    assert len(frames) == 10 and frames[0].shape == (48, 64)
    base = np.random.RandomState(3).randint(0, 256, (48, 64), np.uint8)
    assert np.array_equal(frames[0], base)


def test_gop_shards_partition_and_merge(tmp_path):
    """Two uncoordinated shard runs merge to the single-process records."""
    path = _tiny_video(tmp_path)
    cfg = PipelineConfig(gme=_FAST, batch_size=4, write_images=False)
    ref = _single(tmp_path, path)
    out2 = str(tmp_path / "sharded")
    done = []
    for pid in range(2):
        s = process_video_multihost(path, out_root=out2, cfg=cfg, num_processes=2,
                                    process_id=pid, gop_size=3, device="cpu")
        done.append(s["pairs_processed"])
    assert done == [6, 3]  # GOPs {0, 2} and {1} of three pairs
    merged = merge_rank_records(os.path.join(out2, "tiny"))
    assert merged == ref


def test_shard_restart_resume(tmp_path):
    """A rank that died mid-run re-processes only its missing pairs."""
    path = _tiny_video(tmp_path)
    cfg = PipelineConfig(gme=_FAST, batch_size=2, write_images=False)
    out = str(tmp_path / "r")
    partial = process_video_multihost(path, out_root=out, cfg=cfg, num_processes=2,
                                      process_id=0, gop_size=2, max_pairs=4, device="cpu")
    assert partial["pairs_processed"] == 2
    first = _records(out, "psnr_records.rank0.json")
    assert len(first) == 2
    resumed = process_video_multihost(path, out_root=out, cfg=cfg.replace(resume=True),
                                      num_processes=2, process_id=0, gop_size=2, device="cpu")
    full = _records(out, "psnr_records.rank0.json")
    assert set(first) <= set(full)
    assert resumed["pairs_processed"] == len(full) - len(first)
    process_video_multihost(path, out_root=out, cfg=cfg, num_processes=2, process_id=1,
                            gop_size=2, device="cpu")
    merged = merge_rank_records(os.path.join(out, "tiny"))
    assert sorted(map(int, merged)) == list(range(1, 10))


_WORKER = textwrap.dedent("""
    import sys
    video, out, pid, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    from gme_tpu_torch.config import GMEConfig, PipelineConfig
    from gme_tpu_torch.parallel.multihost import process_video_multihost
    cfg = PipelineConfig(gme=GMEConfig(volume_radius=8, dense_volume_radius=8),
                         batch_size=4, write_images=False)
    s = process_video_multihost(video, out_root=out, cfg=cfg, num_processes=2, process_id=pid,
                                coordinator_address=f"127.0.0.1:{port}", gop_size=3,
                                device="cpu")
    import torch.distributed as dist
    assert not dist.is_initialized()  # the group is destroyed after the merge
    print("RANK", pid, "done", s["pairs_processed"])
""")


def test_two_process_gloo(tmp_path):
    """Two processes on a gloo process group: GOP shards, the completion
    barrier, rank 0's merge, equal to the single-process records."""
    path = _tiny_video(tmp_path)
    out = str(tmp_path / "dist")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, path, out, str(pid), str(port)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=240)
            outputs.append(stdout.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers hung:\n" + "\n".join(outputs))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, o
    assert "RANK 0 done 6" in outputs[0] and "RANK 1 done 3" in outputs[1], outputs
    merged = _records(out)  # written by rank 0 after the barrier
    assert merged == _single(tmp_path, path)


_SHARE_WORKER = textwrap.dedent("""
    import os, sys
    video, out, pid, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    import gme_tpu_torch.pipeline.results as R
    from gme_tpu_torch.config import GMEConfig, PipelineConfig
    from gme_tpu_torch.parallel.multihost import process_video_multihost
    seen = []
    # No pool: record the cores and the size the call would give it.
    R._get_writer = lambda: seen.append((sorted(os.sched_getaffinity(0)), R._png_workers()))
    cfg = PipelineConfig(gme=GMEConfig(volume_radius=8, dense_volume_radius=8), batch_size=4)
    before = sorted(os.sched_getaffinity(0))
    process_video_multihost(video, out_root=out, cfg=cfg, num_processes=2, process_id=pid,
                            coordinator_address=f"127.0.0.1:{port}", gop_size=3,
                            device="cpu")
    (cores, workers), = seen
    print("RANK", pid, " ".join(map(str, cores)), "WORKERS", workers,
          "RESTORED", sorted(os.sched_getaffinity(0)) == before)
""")


def test_ranks_on_one_host_divide_its_cores(tmp_path):
    """Two coordinated ranks on one host, on the same cores: each runs its
    call on a disjoint half of them, sizes its PNG pool from that half, and
    gets its whole affinity back after the call."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        pytest.skip("one core: nothing to divide")
    path = _tiny_video(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _SHARE_WORKER, path, str(tmp_path / "out"),
                          str(pid), str(port)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=240)
            outputs.append(stdout.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers hung:\n" + "\n".join(outputs))
    shares = []
    for pid, (p, o) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, o
        line = [ln for ln in o.splitlines() if ln.startswith(f"RANK {pid} ")][-1].split()
        share = [int(c) for c in line[2:line.index("WORKERS")]]
        assert int(line[line.index("WORKERS") + 1]) == max(2, len(share))
        assert line[-1] == "True"
        shares.append(share)
    half = len(cores) // 2
    assert shares == [cores[:half], cores[half:]]


def test_merge_rejects_stale_rank_manifests(tmp_path):
    d = tmp_path / "v"
    d.mkdir()
    for r in range(3):  # debris: ranks 0..2
        with open(d / f"psnr_records.rank{r}.json", "w") as f:
            json.dump({str(r + 1): 20.0 + r}, f)
    with pytest.raises(RuntimeError, match="stale rank manifests"):
        merge_rank_records(str(d), num_processes=2)
    merged = merge_rank_records(str(d), num_processes=3)
    assert sorted(merged) == ["1", "2", "3"]
