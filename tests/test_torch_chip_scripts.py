"""The card scripts' helpers on the CPU: `chip_smoke.py`'s bounds, library
yardstick and build-log parsing, and the per-stage profile
(`gme_tpu_torch.tools.profile_stages`) at a small size with
`--device cpu`.  The scripts themselves run only on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gme_tpu_torch.config import MAE, MSE
from gme_tpu_torch.ops import cuda_kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_card_scripts_load_no_jax():
    code = ("import sys, chip_smoke, chip_profile\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gme_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr


def _meta(*shape, dtype=torch.uint8):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel,args,ms,by,binds", [
    # the default 720p step's shapes: the output writes bind the volumes
    ("cost_volume_mse_block", (_meta(24, 720, 1280), _meta(24, 784, 1344), 16, 65), 0.4500, "bytes",
     "bytes"),
    ("cost_volume_small_block", (_meta(24, 180, 320), _meta(24, 212, 352), 2, 33, MSE), 0.4503,
     "bytes", "bytes"),
    ("cost_volume_cross", (_meta(8, 720, 1280), _meta(8, 848, 1408), 16, 129), 0.5773, "bytes",
     "bytes"),
    # SAD has no tensor-core form: int32 operations, 4 terms in 2 SIMD byte
    # instructions, bind the three-step volume
    ("cost_volume_rowoffset", (_meta(8, 720, 1272), _meta(8, 770, 1322), 12, 51, MAE), 0.5696,
     "operations", "int32 ops"),
    ("warp_block_field", (_meta(24, 720, 1280), _meta(24, 45, 80, 2, dtype=torch.int32), 16), 0.0134,
     "bytes", "bytes"),
    # the volume diamond at bs 20 (D 65): int32 operations bind
    ("cost_volume_rowoffset", (_meta(8, 720, 1280), _meta(8, 784, 1344), 20, 65, MAE), 0.9311,
     "operations", "int32 ops"),
    # the exhaustive dense init of `-sp 0` (bs 2, D 6): 4 pixels an output, the
    # output writes bind
    ("cost_volume_rowoffset", (_meta(24, 180, 320), _meta(24, 185, 325), 2, 6, MSE), 0.0157,
     "bytes", "bytes"),
])
def test_bound_of_main_path_shapes(kernel, args, ms, by, binds):
    bound_ms, bound_by, what = chip_smoke.bound(K, kernel, args)
    assert (bound_by, what) == (by, binds) and round(bound_ms, 4) == ms


@pytest.mark.parametrize("launch_ms,binds", [(0.0, "bytes"), (0.0134, "bytes"), (0.0135, "latency")])
def test_launch_floor_binds_above_the_bound(launch_ms, binds):
    """A launch that takes longer than the function's bound binds; the bound
    itself stays the bytes and operations one."""
    args = (_meta(24, 720, 1280), _meta(24, 45, 80, 2, dtype=torch.int32), 16)
    bound_ms, bound_by, what = chip_smoke.bound(K, "warp_block_field", args, launch_ms)
    assert (round(bound_ms, 4), bound_by, what) == (0.0134, "bytes", binds)


def test_chase_bound_counts_the_walk():
    """Each cell reads its bounds and writes its outputs once, and reads one
    rank byte a step up to the step that finds it fixed."""
    rng = np.random.RandomState(0)
    C, R = 50, 4
    D = 2 * R + 1
    rank = torch.from_numpy(rng.randint(0, 9, (C, D * D)).astype(np.int8))
    bounds = torch.tensor([[-R, R, -R, R]] * C, dtype=torch.int32)
    assert chip_smoke.chase_reads(K, rank, bounds, D, R, 1) == C
    reads = chip_smoke.chase_reads(K, rank, bounds, D, R, 64)
    assert C < reads <= 64 * C
    nbytes, ops, _ = chip_smoke.work(K, "chase_fixpoint", (rank, bounds, D, R, 64))
    assert (nbytes, ops) == (21 * C + reads, 0)


def test_chase_chain_is_the_longest_walk():
    """The chase's latency floor: its longest walk of dependent loads, the
    first from device memory, the rest from L1."""
    rng = np.random.RandomState(2)
    C, R = 40, 4
    D = 2 * R + 1
    rank = torch.from_numpy(rng.randint(0, 9, (C, D * D)).astype(np.int8))
    bounds = torch.tensor([[-R, R, -R, R]] * C, dtype=torch.int32)
    loads = chip_smoke.chase_loads(K, rank, bounds, D, R, 64)
    assert int(loads.sum()) == chip_smoke.chase_reads(K, rank, bounds, D, R, 64)
    assert 1 <= int(loads.min()) and int(loads.max()) <= 64
    longest = int(loads.max())
    assert chip_smoke.chain_ms(longest, 6e-4, 2e-5) == pytest.approx(6e-4 + (longest - 1) * 2e-5)
    assert chip_smoke.chain_ms(0, 6e-4, 2e-5) == 0.0


def _volume_chase_case(seed, H=48, W=64, bs=8, R=5, shift=9):
    from gme_tpu_torch.ops import bbme

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (1, H + shift, W + shift)).astype(np.uint8)
    prev = torch.from_numpy(base[:, :H, :W].copy())
    curr = torch.from_numpy(base[:, shift:, shift:].copy())
    volume = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
    origins = bbme._block_origins(H // bs, W // bs, bs, "cpu")
    og = origins.reshape(-1, 2)
    bounds = torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                         dim=1).to(torch.int32).contiguous()
    D = 2 * R + 1
    rank = bbme._succ_map(volume, origins, H, W, bs, R).reshape(-1, D * D)
    return volume.reshape(-1, D * D), bounds, rank, D, R


def test_volume_chase_bound_counts_the_sectors_read():
    """Each cell reads its bounds and writes its outputs once, and the
    walks read each distinct 32-byte sector of the volume that their
    candidate loads touch; the steps are the rank-map chase's loads on the
    same walks."""
    volume, bounds, rank, D, R = _volume_chase_case(5)
    C = volume.shape[0]
    steps, sectors = chip_smoke.chase_volume_reads(K, volume, bounds, D, R, 1, True)
    assert steps.tolist() == [1] * C
    orow = ocol = torch.zeros(C, dtype=torch.int32)
    _, idx, read = K.chase_candidates(volume, bounds, orow, ocol, D, R, True)
    first = {(c * D * D + int(i)) * 4 // 32 for c in range(C) for i, r in zip(idx[c], read[c]) if r}
    assert sectors == len(first)
    steps, sectors = chip_smoke.chase_volume_reads(K, volume, bounds, D, R, 64, True)
    assert torch.equal(steps, chip_smoke.chase_loads(K, rank, bounds, D, R, 64).long())
    assert len(first) < sectors <= 9 * int(steps.sum())
    nbytes, ops, _ = chip_smoke.work(K, "chase_volume", (volume, bounds, D, R, 64, True))
    assert (nbytes, ops) == (21 * C + 32 * sectors, 0)


def test_cell_subset_keeps_whole_cells():
    """`counted()` keeps an evenly spaced subset of a volume chase's cells,
    the last included; the chase of the subset is the subset of the
    chase."""
    volume, bounds, _, D, R = _volume_chase_case(6)
    sub = chip_smoke.cell_subset((volume, bounds, D, R, 64, True), cells=7)
    C = volume.shape[0]
    step = C // 7
    idx = list(range(0, C, step)) + ([C - 1] if (C - 1) % step else [])
    assert torch.equal(sub[0], volume[idx]) and torch.equal(sub[1], bounds[idx])
    assert sub[2:] == [D, R, 64, True]
    full = K.chase_volume_plain(volume, bounds, D, R, 64, True)
    part = K.chase_volume_plain(*sub)
    assert torch.equal(part[0], full[0][idx]) and torch.equal(part[1], full[1][idx])


def test_capturing_keeps_the_ssd_keyword():
    """`counted()` keeps the cross kernel's mode, so that `[paths]` holds
    each capture to the right plain version."""
    rng = np.random.RandomState(3)
    bs, D = 8, 9
    p = torch.from_numpy(rng.randint(0, 256, (1, 16, 24)).astype(np.uint8))
    c = torch.from_numpy(rng.randint(0, 256, (1, 16 + D - 1, 24 + D - 1)).astype(np.uint8))
    captured = {}
    call = chip_smoke.capturing(torch, "cost_volume_cross", K.cost_volume_cross, captured)
    out = call(p, c, bs, D, ssd=True)
    (key, (args, kw)), = captured.items()
    assert key[-1] == ("ssd", True) and kw == {"ssd": True} and args[2:] == [bs, D]
    assert torch.equal(out, K.cost_volume_plain(p, c, bs, D, MSE))


def test_cross_library_equals_the_cross_volume():
    """The grouped conv2d yardstick computes the cross volume exactly."""
    rng = np.random.RandomState(1)
    bs, D = 16, 21
    p = torch.from_numpy(rng.randint(0, 256, (2, 32, 48)).astype(np.uint8))
    c = torch.from_numpy(rng.randint(0, 256, (2, 32 + D - 1, 48 + D - 1)).astype(np.uint8))
    call, to_layout = chip_smoke.cross_library(torch, p, c, bs, D)
    assert torch.equal(to_layout(call()), K.cost_volume_cross_plain(p, c, bs, D))


def test_ptxas_summary_names_template_instantiations():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__ead8bfa7_24_cost_volume_mse_"
        "block_cu_99b544cf28cost_volume_mse_block_kernelILi16EEEvPKhS2_Pfiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function '_ZN59_GLOBAL__N__3e2f8aeb_26_cost_volume_small_"
        "block_cu_0ed86c9730cost_volume_small_block_kernelILi2ELb1EEEvPKhS2_Pfiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 39 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121warp_block_field_kernelEPKhPKiPhiiiiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 18 registers, used 0 barriers",
    ])
    summary = chip_smoke.ptxas_summary(log)
    assert set(summary) == {"cost_volume_mse_block<16>", "cost_volume_small_block<2, 1>",
                            "warp_block_field"}
    assert "64 registers, static smem 32 B" in summary["cost_volume_mse_block<16>"]


SASS_LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_128cost_volume_rowoffset_kernelILi3ELi0EEEvPKhS2_PfiiiiiN7gme_vol10PackedPlanE
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   VABSDIFF4.U8 R8, R9, R10, RZ ;  /* 0x000000090a087246 */
        /*0020*/                   IDP.4A.U8.U8 R5, R8, R11, R5 ;  /* 0x0000000b08057226 */
        /*0030*/              @!P0 IDP.4A.U8.U8 R6, R8, R8, R6 ;  /* 0x0000000808068226 */
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_134cost_volume_rowoffset_wide_kernelILi1EEEvPKhS2_PfiiiiN7gme_vol5TilesE
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD R2, R3, R4, R5 ;           /* 0x0000000403027224 */
\t\tFunction : _ZN12_GLOBAL__N_124cost_volume_cross_kernelILi8ELb0EEEvPKhS2_Pfiiiii
        /*0000*/                   IMMA.16832.U8.U8 R4, R8, R12, R4 ;  /* 0x0000000c08047237 */
"""


def test_sass_counts_per_function():
    """The build phase's SASS reading: the instructions of each kernel
    function, and the counts of an opcode in each (IDP.4A for the packed
    row-offset kernel, IMMA for the tensor-core ones), predicated ones
    included."""
    funcs = chip_smoke.sass_functions(SASS_LISTING)
    assert [len(lines) for lines in funcs.values()] == [4, 2, 1]
    dp4a = chip_smoke.sass_counts(funcs, chip_smoke.DP4A_OPS)
    packed = {f: n for f, n in dp4a.items() if chip_smoke.PACKED_KERNEL in f}
    assert sorted(packed.values()) == [0, 2]  # the wide kernel here holds none
    assert sum(chip_smoke.sass_counts(funcs, chip_smoke.VABSDIFF_OPS).values()) == 1
    tc = chip_smoke.sass_counts(funcs, chip_smoke.TENSOR_CORE_OPS)
    assert [n for f, n in tc.items() if "cost_volume_cross_kernel" in f] == [1]


# ---------------------------------------------------------------------------
# gme_tpu_torch.tools.profile_stages, on the CPU
# ---------------------------------------------------------------------------

# Every stage the tool times: the JAX tool's, then the partition of the step.
PROFILE_STAGES = [
    "pyramids(prev)+pyramids(curr)", "dense init (12x16 bs2 diamond)",
    "cost_volume lvl1 R=32 bs16", "diamond bs16 lvl1 (vol+walk)",
    "cost_volume lvl2 R=32 bs16", "diamond bs16 lvl2 (vol+walk)", "global_motion_estimation",
    "affine field + warp", "gme_pipeline_batch (full; its graph replay)",
    "pyramids(prev)+pyramids(curr)",
] + [f"{lvl}: {stage}" for lvl in ("dense", "lvl1", "lvl2") for stage in (
    ("pad + volume kernel", "+inf mask", "chase", "SDSP + field")
    + (("first parameters",) if lvl == "dense" else
       ("projection + affine grid + outlier mask", "fit")))] + [
    "dense affine field", "warp", "diffs", "metrics (psnr)", "compiled step: input copies",
    "compiled step: output clones"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the frames are tiny, and beside the other test
    workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profile_stages_command_on_the_cpu():
    """`python -m gme_tpu_torch.tools.profile_stages 48x64 2 --device cpu`
    exits 0 and prints every stage, the partition marked, the closing sum
    and a JSON record; it reports no device time on the CPU."""
    proc = subprocess.run([sys.executable, "-m", "gme_tpu_torch.tools.profile_stages", "48x64",
                           "2", "--device", "cpu", "--reps", "2"], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert [r["stage"] for r in result["stages"]] == PROFILE_STAGES
    assert sum(r["partition"] for r in result["stages"]) == 24
    assert all(r["device_ms"] is None and r["ms"] > 0 for r in result["stages"])
    assert result["partition_device_ms"] is None and result["step_busy_ms"] is None
    assert (result["H"], result["W"], result["batch"]) == (48, 64, 2)
    for name in PROFILE_STAGES:
        assert any(name in line and "host ms/pair" in line for line in lines[1:-2]), name
    assert lines[-2].startswith("sum of the 24 disjoint stages:")


def test_profile_stages_outputs_equal_the_eager_step(one_thread):
    """The tool's full-batch outputs (the compiled step, its body on the
    CPU) equal `gme_pipeline_batch_eager`'s on its frames, which are a pan
    of a smooth texture made from the seeded generator."""
    from gme_tpu_torch.config import GMEConfig
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager
    from gme_tpu_torch.tools import profile_stages

    lines = []
    result = profile_stages.run(48, 64, 2, "cpu", reps=1, emit=lines.append)
    prev, curr = profile_stages.pan_frames(48, 64, 2, profile_stages.SEEDS[0], "cpu")
    dy, dx = profile_stages.PAN
    assert torch.equal(prev[:, :-dy, :-dx], curr[:, dy:, dx:])
    want = gme_pipeline_batch_eager(prev, curr, GMEConfig())
    assert set(result["outputs"]) == set(want)
    for k in want:
        assert torch.equal(result["outputs"][k], want[k]), k
    assert len(lines) == 1 + len(PROFILE_STAGES) + 1


def test_profile_stages_needs_the_card_unless_told():
    """Without `--device cpu` the tool runs on the card; with none it
    fails and prints no result."""
    proc = subprocess.run([sys.executable, "-m", "gme_tpu_torch.tools.profile_stages", "48x64",
                           "2"], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
