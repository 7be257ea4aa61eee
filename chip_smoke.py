#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gme_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  It builds the port's seven kernels from the sources in
the checkout (one nvcc per source, side by side, with a one-thread
pointer-chase probe beside them; where the toolkit has cuobjdump, it fails
unless the SASS of cost_volume_mse_block and of cost_volume_cross holds
integer tensor-core instructions and every instantiation of
cost_volume_rowoffset holds IDP.4A, the packed-word path; it fails if ptxas
reports spills in a packed-word volume kernel), holds each kernel to its plain PyTorch
version at the shapes its path gives it (the volume chase also to the
rank-map chase on the rank map, at the 720p level-2, dense-init, radius-64
and bs-20 shapes, cut at 1, 3 and 4096 steps) and times both, with the
bound of the kernel's function there (its bytes at the HBM rate or its
operations at their unit's peak, whichever is larger; for the chases also
their longest chain of dependent loads at the latencies the probe measures)
and, for the cross volume, one PyTorch call for the same function (a
grouped conv2d).  Each kernel's time is read twice: CUDA events around a
loop of wrapper calls, and the device's own duration of the kernel from
torch.profiler, beside the wrapper's host time a call.  Then it drives each
path through the entry points a user calls:

- the block-matching goldens (`bbme_synthetic.npz`, both engines, and
  `hierarchical_bbme.npz`) on the card;
- `get_motion_field` under each procedure at the BBME command line's
  defaults on an 8-pair 720p synthetic pan;
- `gme_pipeline_batch` under `-sp 0/1/2` and a volume radius of 64 on an
  8-pair 720p pan, and all of them on the three pan240 golden pairs against
  the port's own CPU run;
- the default per-pair step on the pan240 golden pairs (against the goldens
  and the CPU run) and on a 24-pair 720p pan;
- the results driver (`process_video`, the port's main entry point) over a
  97-frame 720p y4m pan with images and without, resumed, and with the
  adaptive dispatch on a clip whose pairs partly escape its fast radii,
  each against a plain loop of `gme_pipeline_batch`; the command line
  (`python -m gme_tpu_torch.cli results`, then `stats`) over the bench's
  207-frame 240p pan; and the volume-engine diamond at block size 20;
- direct (gradient-descent) GME at 720p: known affine and perspective
  motions recovered at the defaults, the warps equal to the CPU's bit for
  bit, `cli direct` in its own process;
- meshes on the card, every slot naming it: data parallel on a 24-pair
  720p batch, the spatial step (space 2 and 4; three-step and exhaustive at
  space 4) on one pair, each counted and equal to the 1x1 step with as many
  launches of each kernel, and `process_video` at data=2,space=2; then two
  processes of the command line on a gloo process group, their merged
  records equal to the single-process run's.

Each 720p path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of that path launched and no rank
map was built.  Meanwhile each kernel's arguments are kept at every shape
the path gives it (for the volume chase, a fixed subset of the cells), and
at the end each kernel is held against its plain version on them.  It prints one
line per phase.  The last lines are a JSON record of the kernels, the
card's name and power limit from nvidia-smi, and `{"ok": true, "device":
{...}}`.  Any failure exits non-zero before that last line; without a CUDA
device it fails at once.  It imports neither `jax` nor `gme_tpu`.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "goldens")
GOLDENS = os.path.join(GOLDEN_DIR, "pan240_pipeline.npz")
PAN240_PAIRS = [(10, 11), (60, 61), (150, 151)]
INT_KEYS = ("model_motion_field", "compensated", "diff_curr_prev",
            "diff_curr_comp", "volume_edge_hits")
BATCH_720P = 24          # the 720p batch of bench.py
BATCH_SEARCH = 8         # the 720p batch of the search and GME-option paths
PAN_STEP = (3, 6)        # synthetic pan: (rows, cols) per frame at 720p
KERNEL_REPS, PLAIN_REPS = 10, 3
# The BBME command line's defaults (gme_tpu/cli.py:227-237): MAE, bs 12, sw 8.
CLI_BS, CLI_SW = 12, 8
SEARCH_NAMES = {0: "exhaustive", 1: "three-step", 2: "2D-log", 3: "diamond"}
# The GME options of this path, with the kernels each must launch.
GME_OPTIONS = {
    "sp0": ({"searching_procedure": 0},
            ("cost_volume_rowoffset", "cost_volume_mse_block", "warp_block_field")),
    "sp1": ({"searching_procedure": 1},
            ("cost_volume_small_block", "cost_volume_mse_block", "warp_block_field")),
    "sp2": ({"searching_procedure": 2},
            ("cost_volume_small_block", "cost_volume_mse_block", "warp_block_field")),
    "R64": ({"volume_radius": 64},
            ("cost_volume_small_block", "cost_volume_cross", "chase_volume",
             "warp_block_field")),
}
DEFAULT_KERNELS = ("cost_volume_small_block", "cost_volume_mse_block", "chase_volume",
                   "warp_block_field")
# The results driver: a 97-frame 720p pan (96 pairs, four batches of 24);
# a 25-frame 720p clip that alternately holds still and pans ADAPTIVE_PAN
# for the adaptive dispatch; the bench's 240p synthetic pan (bench.py:75-78,
# 207 frames) through the command line at batch 32.
DRIVER_FRAMES, DRIVER_HW = BATCH_720P * 4 + 1, (720, 1280)
ADAPTIVE_FRAMES, ADAPTIVE_PAN, ADAPTIVE_BAR = BATCH_720P + 1, (10, 14), 64
CLI_FRAMES, CLI_HW, CLI_BATCH = 207, (240, 320), 32
BS20_BATCH, BS20_RADIUS = 8, 32  # the volume diamond at bs 20: get_motion_field's radius
# The step counts at which the chases are held to each other.
CHASE_ITERS = (1, 3, 4096)
# Profiling windows `device_ms` takes before it holds an empty one a failure.
PROFILE_ATTEMPTS = 3
# Cells of a volume-chase call that `counted()` keeps for `[paths]`: a volume
# at radius 64 holds 66.6 KB a cell.
CAPTURE_CELLS = 4096
# The volume chase's bytes: the distinct 32-byte sectors its walks read.
SECTOR_BYTES = 32
STREAMS = ("frames", "compensated", "curr_prev_diff", "curr_comp_diff", "model_motion_field")
# Direct GME at 720p: a smooth frame of 32-px cells, and known motions with
# tests/test_direct.py's tolerances (parameter slice, abs tolerance).
DIRECT_HW, DIRECT_CELL = (720, 1280), 32
DIRECT_MOTIONS = (
    ("affine", [6.0, 0.004, -0.003, -4.5, 0.003, 0.005], ((slice(0, 6), 0.1),)),
    ("perspective", [6.0, -4.5, 1.004, 0.003, -0.002, 0.996, 1e-5, -6e-6],
     ((slice(0, 6), 0.1), (slice(6, 8), 2e-4))),
)
# The kernels each spatial run must launch: the dense init (bs 2) and the
# levels (bs 16) of diamond, three-step (its exact radius, D 11 and 37) and
# exhaustive (D 6 on the row-offset kernel, D 20).
MESH_KERNELS = {
    "diamond": ("cost_volume_small_block", "cost_volume_mse_block", "chase_volume"),
    "three-step": ("cost_volume_small_block", "cost_volume_mse_block"),
    "exhaustive": ("cost_volume_rowoffset", "cost_volume_mse_block"),
}
MULTIHOST_GOP = 4

# Published H100 SXM peaks (NVIDIA's data sheet; 700 W): HBM3 bytes/s and the
# dense int8 tensor-core rate; the int32 rate outside the tensor cores is
# 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_RATE = {"int8 tensor": INT8_TENSOR_OPS_PER_S, "int32": INT32_OPS_PER_S}
SSD_MAX = 16 * 16 * 255 ** 2  # the largest block SSD at bs 16
# The kernels whose SASS must hold integer tensor-core instructions.
TENSOR_CORE_KERNELS = ("cost_volume_mse_block", "cost_volume_cross")
TENSOR_CORE_OPS = r"\bIG?MMA\b"
# The packed-word volume: four pixel terms in one __dp4a (IDP.4A), after one
# __vabsdiffu4 (VABSDIFF4) for MAE and MSE.  Every instantiation of the
# row-offset kernel must hold IDP.4A; ptxas must report no spills in any
# packed-word volume kernel.
PACKED_KERNEL = "cost_volume_rowoffset"
DP4A_OPS, VABSDIFF_OPS = r"\bIDP\.4A\b", r"\bVABSDIFF4\b"
PACKED_KERNELS = ("cost_volume_rowoffset", "cost_volume_cross_tiles", "cost_volume_cross_small",
                  "cost_volume_cross_wide", "cost_volume_small_block")

# One thread following a cycle of dependent int32 loads: the latency of one
# dependent global load, at the cache level the cycle's working set lives in.
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
__global__ void chase_probe_kernel(const int* nxt, int steps, int* out) {
  int p = 0;
  for (int i = 0; i < steps; ++i) p = nxt[p];
  *out = p;
}
extern "C" int gme_chase_probe(const void* nxt, int steps, void* out, void* stream) {
  chase_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), steps, static_cast<int*>(out));
  return cudaGetLastError();
}
"""
# The probe's two working sets: one rank-map row of the main path (D 65:
# 4225 bytes, which stays in L1 once read) and 256 MiB, far past the 50 MB
# L2, one load per 128-byte line.
PROBE_ROW_BYTES, PROBE_COLD_BYTES = 65 * 65, 256 * 2**20

# The Pallas kernel each CUDA kernel replaces (kernel body, file:line).
REPLACES = {
    "cost_volume_small_block": "gme_tpu/ops/pallas_kernels.py:128",
    "cost_volume_mse_block": "gme_tpu/ops/pallas_kernels.py:228",
    "cost_volume_rowoffset": "gme_tpu/ops/pallas_kernels.py:98",
    "cost_volume_cross": "gme_tpu/ops/pallas_kernels.py:71",
    "chase_fixpoint": "gme_tpu/ops/pallas_kernels.py:872",
    "chase_volume": "gme_tpu/ops/pallas_kernels.py:872",
    "warp_block_field": "gme_tpu/ops/pallas_kernels.py:719",
}
# The path whose run gives each kernel's `launches` in the JSON record.
MAIN_PATH = {
    "cost_volume_small_block": "driver 720p", "cost_volume_mse_block": "driver 720p",
    "chase_fixpoint": "driver 720p", "chase_volume": "driver 720p",
    "warp_block_field": "driver 720p",
    "cost_volume_rowoffset": "search three-step", "cost_volume_cross": "gme R64",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def synthetic_pan(n_frames, H, W, step, seed=0):
    """A low-pass texture panned by `step` pixels per frame (a crop, not a
    roll), so frame i+1 is frame i moved by +step: the affine fit should
    find a0 = step[1] (columns) and b0 = step[0] (rows)."""
    rng = np.random.RandomState(seed)
    Hb, Wb = H + step[0] * (n_frames - 1), W + step[1] * (n_frames - 1)
    low = rng.randint(0, 256, (Hb // 8 + 1, Wb // 8 + 1)).astype(np.float32)
    base = np.kron(low, np.ones((8, 8), np.float32))[:Hb, :Wb]
    for _ in range(6):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 1) + 4 * base) / 8
    base = base.astype(np.uint8)
    last = n_frames - 1
    return np.stack([
        base[(last - i) * step[0]:(last - i) * step[0] + H,
             (last - i) * step[1]:(last - i) * step[1] + W]
        for i in range(n_frames)
    ])


def cuda_ms(torch, fn, reps):
    """Mean device time of `fn` over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """(ms, names): the device's own time per call of `fn` over `reps`
    calls after one warm-up call, the sum of the durations of the device
    activity (kernels, fills, copies) that torch.profiler records in the
    window divided by `reps`, and the names of that activity.  No host
    time between launches enters it.  Now and then a profiling window
    comes back with no device activity at all; such a window is profiled
    again, up to PROFILE_ATTEMPTS times, and each retry is logged."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            break
        print(f"[profiler] window {attempt} of {PROFILE_ATTEMPTS} recorded no device activity",
              file=sys.stderr, flush=True)
    check(spans, "the profiler recorded no device activity")
    return sum(us for _, us in spans) / 1e3 / reps, sorted({n for n, _ in spans})


def host_us(torch, fn, reps):
    """Host microseconds a call of `fn` takes to return (the launch is
    queued, not waited for), over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / reps * 1e6


def max_abs_err(torch, a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def ptxas_summary(log):
    """kernel (with its template arguments, if any) -> 'N registers, S B
    stack, spills st/ld' from nvcc -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+)_kernel(I\w*?EE)?", line)
        if m:
            args = re.findall(r"L(?:i|b)(\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = f"stack {m.group(1)} B, spill stores {m.group(2)} B, spill loads {m.group(3)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out[name] += f", {m.group(1)} registers, static smem {smem.group(1) if smem else 0} B"
    return out


def read_sass(K, library):
    """`cuobjdump -sass` of the built library, or None where the toolkit
    has no cuobjdump."""
    tool = os.path.join(os.path.dirname(K.find_nvcc()), "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    res = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    return res.stdout


def sass_functions(sass):
    """{kernel function (mangled): its SASS instruction lines} of a
    `cuobjdump -sass` listing."""
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[fn].append(line)
    return funcs


def sass_counts(funcs, opcode):
    """{kernel function: count of its instructions that match the regex
    `opcode`} (a predicated instruction counts too)."""
    return {fn: sum(1 for line in lines if re.search(opcode, line)) for fn, lines in funcs.items()}


def chase_loads(K, rank, bounds, D, R, iters):
    """(C,) rank-map loads of each cell's walk on these inputs: one a step,
    up to the step that finds it at its fixpoint (at most `iters`), from the
    plain lockstep walk.  Each load's address depends on the one before."""
    final, _ = K.chase_fixpoint_plain(rank, bounds, D, R, iters)
    moves = final.new_zeros(final.shape, dtype=final.dtype)
    for i in range(iters):
        still = K.chase_fixpoint_plain(rank, bounds, D, R, i)[0] != final
        if not bool(still.any()):
            break
        moves += still.to(moves.dtype)
    return (moves + 1).clamp(max=iters)


def chase_reads(K, rank, bounds, D, R, iters):
    """Rank-map bytes the chase must read on these inputs."""
    return int(chase_loads(K, rank, bounds, D, R, iters).sum())


def chase_volume_reads(K, volume, bounds, D, R, iters, packed_rule):
    """((C,) steps, sectors) of the volume chase's walks on these inputs,
    from the plain lockstep walk: a cell takes step i where step i - 1
    moved it (step 0 always, at most `iters`) and reads there each
    candidate whose line lies in the volume (nine loads at most, independent
    of each other, dependent on the step before); `sectors` counts the
    distinct 32-byte sectors of the volume that all the walks read."""
    import torch

    C = volume.shape[0]
    row0 = torch.arange(C, device=volume.device)[:, None] * (D * D)
    steps = torch.zeros(C, dtype=torch.int64, device=volume.device)
    sectors, prev = [], None
    for i in range(iters):
        o, _ = K.chase_volume_plain(volume, bounds, D, R, i, packed_rule)
        walking = torch.ones_like(steps, dtype=torch.bool) if prev is None else o != prev
        if not bool(walking.any()):
            break
        _, idx, read = K.chase_candidates(volume, bounds, o // D - R, o % D - R, D, R, packed_rule)
        sectors.append(((row0 + idx) * 4 // SECTOR_BYTES)[read & walking[:, None]])
        steps += walking
        prev = o
    return steps, int(torch.cat(sectors).unique().numel()) if sectors else 0


def chain_ms(longest, cold_ms, row_ms):
    """The least time of the longest walk of `longest` dependent loads: its
    first load from device memory, the rest from the L1 copy of its row."""
    return cold_ms + (longest - 1) * row_ms if longest else 0.0


def work(K, kernel, args):
    """(bytes, operations, kind of operation) of the kernel's function on
    these arguments: each input read once and each output written once
    (for the chases the bounds, the outputs and what the walks read: a rank
    byte a step on the rank map, each distinct 32-byte sector of the volume
    that the candidate loads touch); for the volumes the instructions a pixel term needs: a u8
    multiply-add, 2 operations, on the int8 tensor cores where the function
    has that form, else a quarter of `__vabsdiffu4` + `__dp4a`, which take 4
    terms in 2 int32 instructions; none counted for the chases and the
    warp, whose work is index arithmetic."""
    if kernel.startswith("cost_volume"):
        p, c, bs, D = args[:4]
        B, Hc, Wc = p.shape
        outputs = B * (Hc // bs) * (Wc // bs) * D * D
        if kernel in ("cost_volume_mse_block", "cost_volume_cross"):
            return p.numel() + c.numel() + 4 * outputs, 2 * outputs * bs * bs, "int8 tensor"
        return p.numel() + c.numel() + 4 * outputs, outputs * bs * bs / 2, "int32"
    if kernel == "chase_fixpoint":
        rank, bounds, D, R, iters = args
        return rank.shape[0] * (16 + 4 + 1) + chase_reads(K, rank, bounds, D, R, iters), 0, None
    if kernel == "chase_volume":
        _, sectors = chase_volume_reads(K, *args)
        return args[0].shape[0] * (16 + 4 + 1) + SECTOR_BYTES * sectors, 0, None
    frame, d, bs = args  # warp_block_field
    B, nbh, nbw, _ = d.shape
    return frame.numel() + 4 * d.numel() + B * nbh * bs * nbw * bs, 0, None


def bound(K, kernel, args, launch_ms=0.0):
    """(bound ms, "bytes" or "operations", what binds): the least time the
    card could take for the kernel's function, the larger of its bytes at
    the HBM rate and its operations at their unit's peak.  What binds is
    "bytes", "int8 tensor ops" or "int32 ops", or "latency" where the
    latency floor (`launch_ms`: one launch, timed as the kernels are, or a
    chain of dependent loads) takes longer still."""
    nbytes, ops, kind = work(K, kernel, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_RATE[kind] * 1e3 if kind else 0.0
    t, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    binds = "latency" if launch_ms > t else "bytes" if by == "bytes" else f"{kind} ops"
    return t, by, binds


def cross_library(torch, p, c, bs, D):
    """One PyTorch call for the cross volume: a grouped float32 conv2d of
    each cell's (bs+D-1)^2 window (built with as_strided on curr_pad, made
    contiguous here, outside the timed call) with its prev block.  Returns
    the call and the reshape of its output to the kernel's layout."""
    B, Hc, Wc = p.shape
    nbh, nbw, Kw = Hc // bs, Wc // bs, bs + D - 1
    Hp, Wp = c.shape[1:]
    n = B * nbh * nbw
    win = c.as_strided((B, nbh, nbw, Kw, Kw), (Hp * Wp, bs * Wp, bs, Wp, 1))
    win = win.reshape(1, n, Kw, Kw).float()
    weight = p.reshape(B, nbh, bs, nbw, bs).permute(0, 1, 3, 2, 4).reshape(n, 1, bs, bs).float()
    return (lambda: torch.nn.functional.conv2d(win, weight, groups=n),
            lambda out: out.reshape(B, nbh, nbw, D * D))


def cell_subset(args, cells=CAPTURE_CELLS):
    """A volume chase's (volume, bounds, ...) on an evenly spaced subset of
    at most about `cells` of its cells, the last one included: each cell's
    walk depends on its own row and bounds only."""
    volume, bounds = args[:2]
    C = volume.shape[0]
    idx = list(range(0, C, max(1, C // cells)))
    idx = idx + [C - 1] if idx[-1] != C - 1 else idx
    idx = bounds.new_tensor(idx).long()
    return [volume[idx], bounds[idx]] + list(args[2:])


def capturing(torch, name, wrapper, captured):
    """`wrapper` that also keeps a host copy of its arguments (and keyword
    arguments, such as the cross kernel's `ssd`) the first time it is called
    at each shape, keyed by (name, shapes and scalars, keywords); of a
    volume chase only `cell_subset`'s cells."""
    def call(*args, **kw):
        key = ((name,) + tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args)
               + tuple(sorted(kw.items())))
        if key not in captured:
            keep = cell_subset(args) if name == "chase_volume" else args
            captured[key] = ([a.cpu() if isinstance(a, torch.Tensor) else a for a in keep], kw)
        return wrapper(*args, **kw)
    return call


RANK_MAP_BUILDERS = ("_succ_map_packed", "_succ_map_select")


def counted(torch, K, path, fn, kernels, launch_log, captured):
    """Run `fn` with every launch count set to 0 just before and read just
    after; fail unless each kernel of `kernels` launched, and if a rank map
    was built (`rank_map_builds`: the volume chase walks the volume itself).
    Every kernel wrapper called meanwhile leaves its arguments in `captured`
    at each new shape, so that each shape the path gives a kernel can later
    be held against the plain version."""
    from gme_tpu_torch.ops import bbme

    originals = {k: getattr(K, k) for k in K.LAUNCHES}
    builders = {b: getattr(bbme, b) for b in RANK_MAP_BUILDERS}
    builds = [0]

    def building(builder):
        def call(*args, **kw):
            builds[0] += 1
            return builder(*args, **kw)
        return call

    for k, wrapper in originals.items():
        setattr(K, k, capturing(torch, k, wrapper, captured))
    for b, builder in builders.items():
        setattr(bbme, b, building(builder))
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
    finally:
        for k, wrapper in originals.items():
            setattr(K, k, wrapper)
        for b, builder in builders.items():
            setattr(bbme, b, builder)
    launches = dict(K.LAUNCHES, rank_map_builds=builds[0])
    launch_log[path] = launches
    missing = [k for k in kernels if launches[k] == 0]
    check(not missing, f"{path}: kernels of the path did not launch: {missing} ({launches})")
    check(builds[0] == 0, f"{path}: the path built a rank map ({launches})")
    return out


def held_still_or_panned(n_frames, H, W, step, bar, seed=0):
    """`synthetic_pan`'s texture, still on even pairs and moved by `step`
    on odd ones, with black bars `bar` px wide at the bottom and right.
    The bars hold the last row and column of blocks (which the reference's
    clamp keeps off offset 0) on flat pixels, so a still pair's walks all
    stay at 0 under the adaptive fast radii, while a pan of (10, 14) takes
    the level-2 walks past the fast radius 12."""
    steps = [(0, 0) if i % 2 == 0 else step for i in range(n_frames - 1)]
    pos = np.cumsum([(0, 0)] + steps, 0)
    last = pos[-1]
    base = synthetic_pan(1, H + last[0], W + last[1], (0, 0), seed)[0]
    frames = np.stack([base[last[0] - p[0]:last[0] - p[0] + H, last[1] - p[1]:last[1] - p[1] + W]
                       for p in pos])
    frames[:, H - bar:] = 0
    frames[:, :, W - bar:] = 0
    return frames


def bench_pan_240p():
    """bench.py's synthetic fallback (bench.py:75-78): a random texture from
    seed 0, 207 frames of 240x320 panned (1, 2) px per frame, the geometry
    of pan240.  The texture is as large as the pan needs: bench.py's own
    480x640 one runs out of columns after frame 160."""
    H, W = CLI_HW
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (H + CLI_FRAMES, W + 2 * CLI_FRAMES), np.uint8)
    return np.stack([base[i:i + H, 2 * i:2 * i + W] for i in range(CLI_FRAMES)])


def write_breakdown(torch, gme_tpu_torch, frames, dev, work, n=8):
    """Host ms per pair of each piece of the driver's image writes, on the
    first `n` pairs: the needle diagram on the path the driver takes and on
    the Bresenham path (taken where cv2 is missing), the BGR needle PNG and
    the four gray PNGs, each written synchronously."""
    from gme_tpu_torch.io import draw
    from gme_tpu_torch.io.writers import write_png

    out = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(frames[:n]).to(dev),
                                           torch.from_numpy(frames[1:n + 1]).to(dev))
    field = out["model_motion_field"].cpu().numpy()
    comp = out["compensated"].cpu().numpy()
    ms = {}

    def clock(name, fn, pairs=range(n)):
        t0 = time.perf_counter()
        for k in pairs:
            fn(k)
        ms[name] = round((time.perf_counter() - t0) * 1e3 / len(pairs), 3)

    needles = {}
    clock("draw", lambda k: needles.__setitem__(k, draw.draw_motion_field(frames[k], field[k])))
    has_cv2 = draw._HAS_CV2
    draw._HAS_CV2 = False
    try:
        clock("draw_bresenham", lambda k: draw.draw_motion_field(frames[k], field[k]), range(2))
    finally:
        draw._HAS_CV2 = has_cv2
    path = os.path.join(work, "breakdown.png")
    clock("needle_png", lambda k: write_png(path, needles[k]))
    clock("gray_pngs_x4", lambda k: [write_png(path, img) for img in (
        frames[k], comp[k], np.abs(frames[k + 1].astype(np.int16) - frames[k]).astype(np.uint8),
        np.abs(frames[k + 1].astype(np.int16) - comp[k]).astype(np.uint8))])
    return ms


def step_loop(torch, gme_tpu_torch, frames, batch, dev, cfg):
    """The plain loop the driver replaces: consecutive pairs in batches of
    `batch`, the last padded by repeating its last pair, each uploaded,
    stepped and its transfer keys copied back.  Returns {idx: psnr}, the
    real pairs' edge hits (one count per pair) and the wall time."""
    idx = list(range(1, len(frames)))
    records, hits = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(idx), batch):
        b = idx[s:s + batch]
        padded = b + [b[-1]] * (batch - len(b))
        out = gme_tpu_torch.gme_pipeline_batch(
            torch.from_numpy(frames[[i - 1 for i in padded]]).to(dev),
            torch.from_numpy(frames[padded]).to(dev), cfg)
        host = {k: out[k].cpu() for k in ("parameters", "model_motion_field", "compensated",
                                          "psnr", "volume_edge_hits")}
        hits += host["volume_edge_hits"][:len(b)].tolist()
        records.update({str(i): float(host["psnr"][k]) for k, i in enumerate(b)})
    return records, hits, time.perf_counter() - t0


def read_records(out_root, video):
    with open(os.path.join(out_root, video, "psnr_records.json")) as f:
        return json.load(f)


def driver_phase(torch, K, card, launch_log, captured, work, dev):
    """The results driver on the card: `process_video` over whole 720p
    clips (images on and off, resume, adaptive), the command line over the
    bench's 240p pan, and the volume-engine diamond at bs 20.  Every video
    and output lives under `work` and is removed by the caller."""
    import gme_tpu_torch
    from gme_tpu_torch.config import MAE, GMEConfig, PipelineConfig
    from gme_tpu_torch.io import draw, writers
    from gme_tpu_torch.io.video import write_y4m
    from gme_tpu_torch.native import loader as native
    from gme_tpu_torch.ops import bbme
    from gme_tpu_torch.pipeline.results import process_video

    cfg = GMEConfig()
    H, W = DRIVER_HW
    n_pairs = DRIVER_FRAMES - 1

    frames = synthetic_pan(DRIVER_FRAMES, H, W, PAN_STEP)
    clip = os.path.join(work, "pan720.y4m")
    write_y4m(clip, list(frames))
    want, want_hits, loop_s = step_loop(torch, gme_tpu_torch, frames, BATCH_720P, dev, cfg)
    phase("driver", f"720p step loop: {n_pairs} pairs in {loop_s:.3f} s, "
          f"{n_pairs / loop_s:.2f} pairs/s ({card})")

    def drive(video, out, pcfg, path=None, kernels=(), **kw):
        """process_video on the card; counted as `path` when one is given."""
        def run_it():
            return process_video(video, os.path.join(work, out), pcfg, device=dev, **kw)
        if path is None:
            return run_it()
        return counted(torch, K, path, run_it, kernels, launch_log, captured)

    pcfg = PipelineConfig(batch_size=BATCH_720P)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with_img = drive(clip, "img", pcfg, "driver 720p", DEFAULT_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    got = read_records(os.path.join(work, "img"), "pan720")
    check(with_img["pairs_processed"] == n_pairs and len(got) == n_pairs,
          f"driver 720p: {len(got)} records, expected {n_pairs}")
    for s in STREAMS:
        n = len(os.listdir(os.path.join(work, "img", "pan720", s)))
        check(n == n_pairs, f"driver 720p: {n} PNGs in {s}, expected {n_pairs}")
    check(got == want, "driver 720p: psnr_records.json differs from the step loop "
          f"(max {max(abs(got[k] - want[k]) for k in want):.3g} dB)")
    check(with_img["volume_edge_hits"] == sum(want_hits),
          f"driver 720p: edge hits {with_img['volume_edge_hits']} != step loop {sum(want_hits)}")
    shutil.rmtree(os.path.join(work, "img"))
    no_img = drive(clip, "noimg", pcfg.replace(write_images=False))
    check(read_records(os.path.join(work, "noimg"), "pan720") == want,
          "driver 720p without images: records differ from the step loop")
    stages = {k: round(v["total_s"], 4) for k, v in with_img["stages"].items()}
    overlap = 1 - (with_img["wall_s"] - loop_s) / with_img["stages"]["write_outputs"]["total_s"]
    writer = "native" if native.available() else ("cv2" if writers._HAS_CV2 else "python")
    phase("driver", f"720p process_video B={BATCH_720P}: {n_pairs} records == the step loop "
          f"(exact), 5 x {n_pairs} PNGs, volume_edge_hits {sum(want_hits)} (ring-visited "
          f"pairs {sum(h > 0 for h in want_hits)}); launches "
          f"{launch_log['driver 720p']}")
    phase("driver", f"720p pairs/s: with images {with_img['pairs_per_s']:.2f} "
          f"(wall {with_img['wall_s']:.3f} s), without images {no_img['pairs_per_s']:.2f} "
          f"(wall {no_img['wall_s']:.3f} s), step loop {n_pairs / loop_s:.2f}; peak "
          f"{peak / 2**30:.2f} GiB ({card})")
    phase("driver", f"720p stages with images (s): {stages}; without images: "
          f"{ {k: round(v['total_s'], 4) for k, v in no_img['stages'].items()} } ({card})")
    phase("driver", f"720p image writes, host ms per pair (synchronous, 8 pairs): "
          f"{write_breakdown(torch, gme_tpu_torch, frames, dev, work)} ({card})")
    phase("driver", f"720p overlap share 1 - (wall - step loop) / write_outputs = {overlap:.4f}; "
          f"png writer {writer}"
          f"{'' if native.available() else ' (native: ' + str(native.build_error()).splitlines()[0] + ')'}"
          f"; draw {'cv2' if draw._HAS_CV2 else 'Bresenham'}; decode pure-Python y4m "
          "parser (streaming)")

    # Resume: half the video, then the rest from the ledger.
    half = n_pairs // 2
    first = drive(clip, "resume", pcfg.replace(write_images=False), max_pairs=half)
    rest = drive(clip, "resume", pcfg.replace(write_images=False, resume=True))
    got = read_records(os.path.join(work, "resume"), "pan720")
    check(first["pairs_processed"] == half and rest["pairs_processed"] == n_pairs - half
          and got == want, f"resume: processed {first['pairs_processed']} + "
          f"{rest['pairs_processed']}, {len(got)} records")
    phase("driver", f"resume: max_pairs={half}, then resume=True processed "
          f"{rest['pairs_processed']}; {len(got)} records == the step loop")
    del frames

    # The adaptive dispatch on pairs that escape the fast radii and pairs
    # that do not.
    alt = held_still_or_panned(ADAPTIVE_FRAMES, H, W, ADAPTIVE_PAN, ADAPTIVE_BAR)
    alt_clip = os.path.join(work, "alt720.y4m")
    write_y4m(alt_clip, list(alt))
    fast = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(alt[:-1]).to(dev),
                                            torch.from_numpy(alt[1:]).to(dev), cfg.fast())
    fast_hits = fast["volume_edge_hits"].cpu().numpy()
    del fast
    escaped = int((fast_hits > 0).sum())
    check(0 < escaped < len(fast_hits), f"adaptive clip: fast-tier edge hits {fast_hits.tolist()} "
          "need pairs that escape and pairs that do not")
    acfg = PipelineConfig(batch_size=BATCH_720P, write_images=False)
    default = drive(alt_clip, "alt_default", acfg)
    adaptive = drive(alt_clip, "alt_adaptive", acfg.replace(adaptive=True), "driver adaptive",
                     DEFAULT_KERNELS)
    check(read_records(os.path.join(work, "alt_adaptive"), "alt720")
          == read_records(os.path.join(work, "alt_default"), "alt720")
          and adaptive["volume_edge_hits"] == default["volume_edge_hits"],
          "adaptive: records or edge hits differ from the default radii")
    phase("driver", f"adaptive 720p B={BATCH_720P}: {escaped}/{len(fast_hits)} pairs escape the "
          f"fast radii (fast-tier hits {fast_hits.tolist()}); records == default radii; "
          f"{ADAPTIVE_FRAMES - 1} pairs in {adaptive['wall_s']:.3f} s against "
          f"{default['wall_s']:.3f} s at the default radii ({card}); launches "
          f"{launch_log['driver adaptive']}")
    del alt

    # The command line over the bench's 240p pan, in its own process.
    pan = bench_pan_240p()
    clip240 = os.path.join(work, "pan240s.y4m")
    write_y4m(clip240, list(pan))
    out240 = os.path.join(work, "cli")
    env = cli_env()
    cli = [sys.executable, "-m", "gme_tpu_torch.cli"]
    platform = "gpu" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    res = subprocess.run(cli + ["results", "-v", clip240, "-o", out240, "--batch-size",
                                str(CLI_BATCH), "--platform", platform],
                         cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"cli results failed ({res.returncode}): {res.stderr[-2000:]}")
    summary = json.loads(res.stdout)
    stats = subprocess.run(cli + ["stats", out240], cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=300)
    check(stats.returncode == 0 and stats.stdout.startswith("video pan240s"),
          f"cli stats failed ({stats.returncode}): {stats.stderr[-2000:]}")
    want240, hits240, loop240 = step_loop(torch, gme_tpu_torch, pan, CLI_BATCH, dev, cfg)
    got240 = read_records(out240, "pan240s")
    check(len(got240) == CLI_FRAMES - 1 and got240 == want240,
          f"cli 240p: {len(got240)} records, equal to the step loop: {got240 == want240}")
    check(summary["volume_edge_hits"] == sum(hits240),
          "cli 240p: edge hits differ from the step loop")
    phase("driver", f"cli results 240p B={CLI_BATCH}: {len(got240)} records == the step loop; "
          f"psnr avg {summary['psnr']['avg']:.4f} min {summary['psnr']['min']:.4f} max "
          f"{summary['psnr']['max']:.4f}; ring-visited pairs {sum(h > 0 for h in hits240)}, "
          f"volume_edge_hits {sum(hits240)}; "
          f"driver {summary['pairs_per_s']:.2f} pairs/s (wall {summary['wall_s']:.3f} s), "
          f"command {cli_s:.1f} s, step loop {(CLI_FRAMES - 1) / loop240:.2f} pairs/s ({card}); "
          f"cli stats: {' '.join(stats.stdout.split())}")
    del pan

    # The volume-engine diamond above bs 16: the select-chain rank map.
    sub = synthetic_pan(BS20_BATCH + 1, H, W, PAN_STEP)
    p20, c20 = torch.from_numpy(sub[:-1]).to(dev), torch.from_numpy(sub[1:]).to(dev)
    kw = dict(block_size=20, searching_procedure=3, pnorm_distance=MAE, search_impl="volume",
              return_diagnostics=True)
    (field, diag), wall, _ = timed(torch, lambda: counted(
        torch, K, "diamond bs20", lambda: bbme.get_motion_field(p20, c20, **kw),
        ("cost_volume_rowoffset", "chase_volume"), launch_log, captured))
    crop = (slice(0, 1), slice(0, 360), slice(0, 640))
    small = bbme.get_motion_field(p20[crop].cpu(), c20[crop].cpu(), **kw)
    on_card = bbme.get_motion_field(p20[crop], c20[crop], **kw)
    check(torch.equal(small[0], on_card[0].cpu())
          and torch.equal(small[1]["volume_edge_hits"], on_card[1]["volume_edge_hits"].cpu()),
          "diamond bs20: the card and the CPU differ on a 360x640 crop")
    inner = field[:, 2:-2, 2:-2].reshape(-1, 2).cpu().numpy()
    found = float((inner == [PAN_STEP[1], PAN_STEP[0]]).all(axis=1).mean())
    check(found >= 0.8, f"diamond bs20: the pan is found in only {found:.3f} of the inner cells")
    phase("driver", f"volume diamond MAE bs=20 B={BS20_BATCH} 720p: {wall * 1e3:.2f} ms, "
          f"{BS20_BATCH / wall:.1f} pairs/s ({card}); inner cells on the pan {found:.3f}; "
          f"volume_edge_hits {diag['volume_edge_hits'].tolist()}; 360x640 crop == CPU; "
          f"launches {launch_log['diamond bs20']}")


def smooth_frame(H, W, seed=0, cell=DIRECT_CELL, passes=3):
    """tests/test_direct.py's smooth frame at `cell`-pixel blocks: a blocky
    random field blurred by repeated (cell+1)-tap box filters (gradient
    descent needs image gradients on the scale of the motion)."""
    rng = np.random.RandomState(seed)
    img = np.kron(rng.rand(-(-H // cell), -(-W // cell)), np.ones((cell, cell)))[:H, :W]
    k = np.ones(cell + 1) / (cell + 1)
    for _ in range(passes):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    img = 255 * (img - img.min()) / (np.ptp(img) + 1e-9)
    return img.astype(np.uint8)


def cli_env():
    """The environment of a command-line subprocess: this checkout first on
    the import path."""
    return dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))


def direct_phase(torch, card, dev, work):
    """Direct (gradient-descent) GME at 720p: known affine and perspective
    motions recovered within tests/test_direct.py's tolerances at the
    defaults, the warps on the card equal to the CPU's bit for bit, and
    `cli direct` in its own process."""
    from gme_tpu_torch.io.video import write_y4m
    from gme_tpu_torch.models import direct

    H, W = DIRECT_HW
    img = smooth_frame(H, W)
    prev_cpu = torch.from_numpy(img)
    prev = prev_cpu.to(dev)
    for model, true, atol in DIRECT_MOTIONS:
        true = torch.tensor(true)
        curr = direct.warp_backward(prev, true.to(dev), model)
        check(torch.equal(curr.cpu(), direct.warp_backward(prev_cpu, true, model)),
              f"direct {model}: warp_backward on the card differs from the CPU")
        est, wall, walls = timed(torch, lambda: direct.direct_global_motion_estimation(
            prev, curr, model), reps=1)
        err = (est.cpu() - true).abs()
        ok = [bool((err[sl] <= tol).all()) for sl, tol in atol]
        check(all(ok), f"direct {model}: estimate {est.cpu().tolist()} misses {true.tolist()} "
              f"(abs err {err.tolist()})")
        phase("direct", f"{model} 720p: recovered {true.tolist()} with abs err max "
              f"{float(err.max()):.3g} (tolerances {[t for _, t in atol]}); "
              f"{direct.DEFAULT_ITERATIONS} x 3 levels in {wall * 1e3:.1f} ms ({card})")
    # The warps on the card against the CPU: sample points out of the frame,
    # huge and NaN parameters.
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(100000).astype(np.float32) * (H + 200) - 100)
    y = torch.from_numpy(rng.rand(100000).astype(np.float32) * (W + 200) - 100)
    x[:3] = torch.tensor([float("nan"), 1e30, float(H - 1)])
    got = direct.bilinear_sample(prev, x.to(dev), y.to(dev)).cpu()
    want = direct.bilinear_sample(prev_cpu, x, y)
    check(torch.equal(got.nan_to_num(), want.nan_to_num())
          and torch.equal(got.isnan(), want.isnan()), "bilinear_sample: card differs from the CPU")
    n_forward = 0
    for model, true, _ in DIRECT_MOTIONS:
        p = torch.tensor(true)
        for q in (p, p * 1e9, torch.full_like(p, float("nan")), torch.zeros_like(p)):
            check(torch.equal(direct.warp_forward(prev, q.to(dev), model).cpu(),
                              direct.warp_forward(prev_cpu, q, model)),
                  f"warp_forward {model} {q.tolist()}: card differs from the CPU")
            n_forward += 1
    phase("direct", f"card == CPU bit for bit: bilinear_sample at 100000 points (out of frame, "
          f"NaN, 1e30), warp_backward under both motions, warp_forward x {n_forward} "
          "(huge, NaN, collapsing parameters)")

    # The command line on a y4m pair, in its own process.
    model, true, atol = DIRECT_MOTIONS[0]
    curr = direct.warp_backward(prev_cpu, torch.tensor(true), model)
    clip = os.path.join(work, "direct720.y4m")
    write_y4m(clip, [img, torch.round(curr).clamp(0, 255).to(torch.uint8).numpy()])
    out = os.path.join(work, "direct_out")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gme_tpu_torch.cli", "direct", "-v", clip,
                          "-fi", "1", "--model", model, "-o", out, "--platform",
                          "gpu" if dev.type == "cuda" else "cpu"],
                         cwd=HERE, env=cli_env(), capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f"cli direct failed ({res.returncode}): {res.stderr[-2000:]}")
    printed = json.loads(res.stdout)
    check(sorted(printed) == ["model", "parameters", "psnr_after", "psnr_before"]
          and printed["psnr_after"] > printed["psnr_before"] + 6
          and os.path.exists(os.path.join(out, "direct_1.png")),
          f"cli direct: {printed}, files {os.listdir(out) if os.path.isdir(out) else None}")
    err = np.abs(np.array(printed["parameters"]) - np.array(true)).max()
    phase("direct", f"cli direct 720p {model}: psnr {printed['psnr_before']:.4f} -> "
          f"{printed['psnr_after']:.4f} dB, parameters abs err max {err:.3g}, direct_1.png "
          f"written; command {cli_s:.1f} s ({card})")


def mesh_phase(torch, K, card, launch_log, captured, dev, work):
    """Meshes on one card, the slots all naming it: data parallel and the
    spatial step (space 2 and 4; three-step and exhaustive at space 4) at
    720p against the 1x1 step, each spatial run counted, and the driver
    with a 2x2 mesh against the 1x1 driver.  On one card a mesh runs its
    slots one after another: the times are the band program's cost."""
    import gme_tpu_torch
    from gme_tpu_torch.config import GMEConfig, MeshConfig, PipelineConfig
    from gme_tpu_torch.io.video import write_y4m
    from gme_tpu_torch.parallel.data_parallel import make_sharded_pipeline
    from gme_tpu_torch.parallel.mesh import make_mesh
    from gme_tpu_torch.parallel.spatial import make_spatial_pipeline
    from gme_tpu_torch.pipeline.results import process_video

    H, W = DRIVER_HW
    frames = synthetic_pan(BATCH_720P + 1, H, W, PAN_STEP)
    prev = torch.from_numpy(frames[:-1]).to(dev)
    curr = torch.from_numpy(frames[1:]).to(dev)

    def same(got, want, what, exact=False):
        for k in want:
            if k == "psnr" and not exact:
                d = float((got[k] - want[k]).abs().max())
                check(d <= 1e-4, f"{what}: psnr differs by {d} dB")
            else:
                check(torch.equal(got[k], want[k]), f"{what}: {k} differs from the 1x1 step")

    cfg = GMEConfig(search_impl="volume")
    one = gme_tpu_torch.gme_pipeline_batch(prev, curr, cfg)
    dp = make_sharded_pipeline(make_mesh(2, 1, [dev] * 2), cfg)
    same(dp(prev, curr), one, "data parallel 2x1", exact=True)
    phase("mesh", f"data parallel data=2 on {[str(dev)] * 2}, B={BATCH_720P} 720p == the 1x1 "
          "step bit for bit (every output, PSNR included)")
    del one

    runs = [(2, cfg, "diamond"), (4, cfg, "diamond"),
            (4, cfg.replace(searching_procedure=1), "three-step"),
            (4, cfg.replace(searching_procedure=0), "exhaustive")]
    p1, c1 = prev[:1], curr[:1]
    for space, scfg, name in runs:
        path = f"mesh spatial s{space} {name}"
        single = f"mesh 1x1 {name}"
        step = make_spatial_pipeline(make_mesh(1, space, [dev] * space), scfg, H, W)
        kernels = MESH_KERNELS[name]
        got = counted(torch, K, path, lambda: step(p1, c1), kernels, launch_log, captured)
        want = counted(torch, K, single, lambda: gme_tpu_torch.gme_pipeline_batch(p1, c1, scfg),
                       kernels, launch_log, captured)
        same(got, want, path, exact=True)
        banded = {k: v for k, v in launch_log[path].items() if k != "warp_block_field"}
        flat = {k: v for k, v in launch_log[single].items() if k != "warp_block_field"}
        check(banded == flat, f"{path}: launches {banded} != the 1x1 step's {flat}")
        _, ms, _ = timed(torch, lambda: step(p1, c1))
        _, ms1, _ = timed(torch, lambda: gme_tpu_torch.gme_pipeline_batch(p1, c1, scfg))
        phase("mesh", f"spatial {name} space={space} on one card, 1 pair 720p == the 1x1 step "
              f"(every output bit for bit, PSNR included); launches {launch_log[path]} == the "
              f"1x1 step's but warp_block_field (a plain gather there); step {ms * 1e3:.1f} ms "
              f"against {ms1 * 1e3:.1f} ms for the 1x1 step ({card}; one card runs the bands in "
              "turn: the band program's cost, no speed-up)")
    del prev, curr

    clip = os.path.join(work, "mesh720.y4m")
    write_y4m(clip, list(frames))
    pcfg = PipelineConfig(gme=cfg, batch_size=BATCH_720P, write_images=False)
    flat = process_video(clip, os.path.join(work, "flat"), pcfg, device=dev)
    meshed = process_video(clip, os.path.join(work, "meshed"),
                           pcfg.replace(mesh=MeshConfig(data=2, space=2)), device=dev,
                           devices=[dev] * 4)
    got, want = (read_records(os.path.join(work, d), "mesh720") for d in ("meshed", "flat"))
    check(len(got) == BATCH_720P and sorted(got) == sorted(want)
          and max(abs(got[k] - want[k]) for k in want) <= 1e-4
          and meshed["volume_edge_hits"] == flat["volume_edge_hits"],
          f"process_video 2x2: records differ from the 1x1 run ({len(got)} records)")
    phase("mesh", f"process_video mesh data=2,space=2 on {[str(dev)] * 4}: {len(got)} 720p "
          f"records == the 1x1 run (max diff {max(abs(got[k] - want[k]) for k in want)} dB); "
          f"wall {meshed['wall_s']:.3f} s against {flat['wall_s']:.3f} s ({card})")
    return clip, want


def multihost_phase(torch, card, dev, work, clip, want):
    """Two processes of the command line on the card, on a gloo process
    group at a free local port: GOP shards, the completion barrier, rank
    0's merge, equal to the single-process records."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(work, "multi")
    cmd = [sys.executable, "-m", "gme_tpu_torch.cli", "results", "-v", clip, "-o", out,
           "--batch-size", "8", "--no-images", "--search-impl", "volume", "--gop-size",
           str(MULTIHOST_GOP), "--num-processes", "2", "--coordinator", f"127.0.0.1:{port}",
           "--platform", "gpu" if dev.type == "cuda" else "cpu"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], cwd=HERE, env=cli_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multihost rank {r} failed ({p.returncode}): {e[-2000:]}")
    done = [json.loads(o)["pairs_processed"] for o, _ in outs]
    got = read_records(out, "mesh720")
    check(sorted(got) == sorted(want) and got == want,
          f"multihost: merged records differ from the single-process run ({len(got)} records)")
    phase("multihost", f"2 processes (gloo at 127.0.0.1:{port}, GOPs of {MULTIHOST_GOP}) on the "
          f"card: {done} pairs, rank 0 merged {len(got)} records == the single-process run "
          f"exactly; {wall:.1f} s for both commands ({card})")


def start_probe_build(K):
    """Start nvcc on LATENCY_PROBE into the kernels' build directory, beside
    the kernels' own builds; returns (process, library path)."""
    os.makedirs(K._BUILD_DIR, exist_ok=True)
    src = os.path.join(K._BUILD_DIR, f"latency_probe.{os.getpid()}.cu")
    with open(src, "w") as f:
        f.write(LATENCY_PROBE)
    lib = src[:-3] + ".so"
    cmd = [K.find_nvcc(), *K._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_latency(torch, dev, lib_path, nbytes, steps=(2000, 6000)):
    """ms per dependent load of one thread following a random cycle through
    `nbytes` of device memory, one int32 per 128-byte line: the slope
    between two chase lengths, so the launch cancels out."""
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.gme_chase_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.gme_chase_probe.restype = ctypes.c_int
    lines = max(nbytes // 128, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = (torch.randperm(lines, device=dev, generator=gen) * 32).to(torch.int32)
    nxt = torch.zeros(lines * 32, dtype=torch.int32, device=dev)
    nxt[perm.long()] = torch.roll(perm, -1)
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def chase(n):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gme_chase_probe(ctypes.c_void_p(nxt.data_ptr()), n,
                                  ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
        check(err == 0, f"the latency probe did not launch ({err})")

    t0, t1 = (cuda_ms(torch, lambda n=n: chase(n), 3) for n in steps)
    return (t1 - t0) / (steps[1] - steps[0])


def timed(torch, fn, reps=3):
    """Median host time of `fn` over `reps` synchronised calls, after one
    warm-up call whose result is returned."""
    out = fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls)), walls


def run(torch):
    import gme_tpu_torch
    from gme_tpu_torch.config import MAE, MSE, GMEConfig
    from gme_tpu_torch.ops import bbme
    from gme_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    cfg = GMEConfig()
    launch_log = {}
    captured = {}  # (kernel, argument shapes) -> host copies of the arguments

    # Phase 1: device.
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("device", f"{name}; device_count={count}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    # Phase 2: build from the checkout's sources (and the latency probe).
    probe, probe_lib = start_probe_build(K)
    built = K.build(force=True)
    probe_log = probe.communicate()[0]
    check(probe.returncode == 0, f"the latency probe did not build: {probe_log[-2000:]}")
    phase("build", f"nvcc {built.seconds:.1f} s -> {os.path.relpath(built.path, HERE)}")
    summary = ptxas_summary(built.log)
    for kernel in K.LAUNCHES:
        check(any(k.split("<")[0] == kernel for k in summary), f"ptxas printed nothing for {kernel}")
    for name_args, line in sorted(summary.items()):
        phase("build", f"{name_args}: {line}")
    spilled = [k for k, line in summary.items() if k.startswith(PACKED_KERNELS)
               and "spill stores 0 B, spill loads 0 B" not in line]
    check(not spilled, f"ptxas reports spills in packed-word volume kernels: {spilled}")
    sass = read_sass(K, built.path)
    funcs = sass_functions(sass) if sass is not None else None
    tc = sass_counts(funcs, TENSOR_CORE_OPS) if funcs is not None else None
    for kernel in TENSOR_CORE_KERNELS:
        if tc is None:
            phase("build", f"no cuobjdump in the toolkit: the SASS of {kernel} is not read")
            continue
        fns = {f: n for f, n in tc.items() if f"{kernel}_kernel" in f}
        n_tc = sum(fns.values())
        phase("build", f"{kernel} SASS: {n_tc} integer tensor-core instructions "
              f"(IMMA/IGMMA) over {len(fns)} instantiations")
        check(n_tc > 0, f"{kernel}'s SASS holds no IMMA/IGMMA: the tensor-core path was not built")
    if funcs is not None:
        dp4a = {f: n for f, n in sass_counts(funcs, DP4A_OPS).items() if PACKED_KERNEL in f}
        vabs = sass_counts(funcs, VABSDIFF_OPS)
        bare = [f for f, n in dp4a.items() if n == 0]
        check(dp4a and not bare, f"{PACKED_KERNEL}: instantiations without IDP.4A: {bare}")
        phase("build", f"{PACKED_KERNEL} SASS: IDP.4A in all {len(dp4a)} instantiations "
              f"({min(dp4a.values())}-{max(dp4a.values())} each), VABSDIFF4 "
              f"{sum(vabs[f] for f in dp4a)} in all; no spills in {len(PACKED_KERNELS)} "
              "packed-word kernel families")
    K.load_library()

    # Inputs at the main path's 720p shapes: the 24-pair synthetic pan.
    frames = synthetic_pan(BATCH_720P + 1, 720, 1280, PAN_STEP)
    prev = torch.from_numpy(frames[:-1]).to(dev)
    curr = torch.from_numpy(frames[1:]).to(dev)
    prev_pyr = gme_tpu_torch.get_pyramids(prev, cfg.pyramid_levels)
    curr_pyr = gme_tpu_torch.get_pyramids(curr, cfg.pyramid_levels)

    # Phase 3: each kernel against its plain version, bit for bit.  The
    # launch floor: one launch of a one-element fill, timed as the kernels
    # are; where it exceeds a function's bound, latency binds.
    fill = torch.zeros(1, device=dev).zero_
    launch_ms = cuda_ms(torch, fill, KERNEL_REPS)
    launch_device_ms, _ = device_ms(torch, fill, KERNEL_REPS)
    phase("kernels", f"launch floor {launch_ms:.4f} ms (one-element fill, events around a loop "
          f"of calls), its device time {launch_device_ms:.4f} ms (torch.profiler), host "
          f"{host_us(torch, fill, KERNEL_REPS):.1f} us a call ({card})")
    # The chase's floor: its longest walk as a chain of dependent loads, the
    # first from device memory, the rest from L1.
    row_ms = load_latency(torch, dev, probe_lib, PROBE_ROW_BYTES)
    cold_ms = load_latency(torch, dev, probe_lib, PROBE_COLD_BYTES)
    phase("kernels", f"dependent load latency (one-thread pointer chase): {row_ms * 1e6:.1f} ns "
          f"in a {PROBE_ROW_BYTES}-byte rank-map row, {cold_ms * 1e6:.1f} ns across "
          f"{PROBE_COLD_BYTES >> 20} MiB ({card})")

    def chain_of(kernel, args):
        """The longest walk of a chase as a chain of dependent loads (ms),
        or None for the other kernels: a rank byte a step on the rank map, a
        step's nine independent candidate loads on the volume."""
        if kernel == "chase_fixpoint":
            return chain_ms(int(chase_loads(K, *args).max()), cold_ms, row_ms)
        if kernel == "chase_volume":
            return chain_ms(int(chase_volume_reads(K, *args)[0].max()), cold_ms, row_ms)
        return None

    def floor_of(kernel, args):
        """(latency floor ms, chain ms or None): one launch; for the chases
        the larger of that and their longest walk of dependent loads."""
        chain = chain_of(kernel, args)
        return (launch_ms, None) if chain is None else (max(launch_ms, chain), chain)

    records = {k: {"max_abs_err": 0.0} for k in K.LAUNCHES}
    # Each wrapper's plain version, called with the wrapper's arguments.
    plain_of = {
        "cost_volume_small_block": K.cost_volume_plain,
        "cost_volume_mse_block": lambda p, c, bs, D: K.cost_volume_plain(p, c, bs, D, MSE),
        "cost_volume_rowoffset": K.cost_volume_plain,
        "cost_volume_cross": K.cost_volume_cross_plain,
        "chase_fixpoint": K.chase_fixpoint_plain,
        "chase_volume": K.chase_volume_plain,
        "warp_block_field": K.warp_block_field_plain,
    }

    def agree(kernel, got, want):
        """Fold the error of `got` against `want` into the kernel's record
        and fail unless they are equal; returns the error."""
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        records[kernel]["max_abs_err"] = max(err, records[kernel]["max_abs_err"])
        check(equal, f"{kernel} disagrees with its plain version (max_abs_err {err})")
        return err

    def compare(kernel, args, shape_note, main=True, library=None, kw=None):
        """Hold the kernel to its plain version on `args` (and keywords
        `kw`) and time both, with the bound of its function there; `library`
        is one PyTorch call computing the same function (checked equal, then
        timed).  The kernel's time is read twice: CUDA events around a loop
        of wrapper calls (`ms`, the host's cost a call included where it is
        the larger) and the device's own duration of the kernel
        (`device_ms`), with the wrapper's host time a call (`host_us`); the
        share is given against each, the device one with the device's own
        launch floor.  The record keeps the figures of the main path's shape
        (`main`)."""
        kw = kw or {}
        run_kernel = lambda: getattr(K, kernel)(*args, **kw)  # noqa: E731
        run_plain = lambda: plain_of[kernel](*args, **kw)  # noqa: E731
        got = run_kernel()
        err = agree(kernel, got, run_plain())
        ms = cuda_ms(torch, run_kernel, KERNEL_REPS)
        dev_ms, dev_names = device_ms(torch, run_kernel, KERNEL_REPS)
        call_us = host_us(torch, run_kernel, KERNEL_REPS)
        plain_ms = cuda_ms(torch, run_plain, PLAIN_REPS)
        chain = chain_of(kernel, args)
        floor = max(launch_ms, chain or 0.0)
        dev_floor = max(launch_device_ms, chain or 0.0)
        bound_ms, bound_by, binds = bound(K, kernel, args, floor)
        share = max(bound_ms, floor) / ms
        device_share = max(bound_ms, dev_floor) / dev_ms
        library_ms, note = None, ""
        if library is not None:
            call, to_layout = library
            check(torch.equal(to_layout(call()), got), f"{kernel}: the library call differs")
            library_ms = cuda_ms(torch, call, PLAIN_REPS)
            note = f", library {library_ms:.4f} ms (equal)"
        del got
        if chain is not None:
            note += f", longest walk {chain:.4f} ms as a chain of dependent loads"
        if main:
            records[kernel].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   binds=binds, launch_ms=launch_ms, share=share,
                                   library_ms=library_ms, device_ms=dev_ms, host_us=call_us,
                                   launch_device_ms=launch_device_ms, device_share=device_share)
            if chain is not None:
                records[kernel]["chain_ms"] = chain
        phase("kernels", f"{kernel} {shape_note}{' ' + str(kw) if kw else ''}: bit-equal=True "
              f"max_abs_err={err} kernel {ms:.4f} ms (events around a loop of calls), device "
              f"{dev_ms:.4f} ms (torch.profiler: {', '.join(n[:48] for n in dev_names)}), host "
              f"{call_us:.1f} us a call, plain {plain_ms:.4f} ms{note}; bound {bound_ms:.4f} ms by "
              f"{bound_by}, {binds} binds, share {share:.4f}, of the device time "
              f"{device_share:.4f} ({card})")

    bs0 = cfg.dense_block_size
    R0 = min(cfg.dense_volume_radius, max(prev_pyr[0].shape[1:]))
    p0, c0 = bbme.volume_inputs(prev_pyr[0], curr_pyr[0], bs0, R0)
    D0 = 2 * R0 + 1
    compare("cost_volume_small_block", (p0, c0, bs0, D0, MSE),
            f"B={BATCH_720P} {tuple(prev_pyr[0].shape[1:])} bs={bs0} D={D0}")
    # The adaptive fast tier's dense init: D 17.
    R0f = cfg.fast_dense_volume_radius
    p0, c0 = bbme.volume_inputs(prev_pyr[0], curr_pyr[0], bs0, R0f)
    compare("cost_volume_small_block", (p0, c0, bs0, 2 * R0f + 1, MSE),
            f"B={BATCH_720P} {tuple(prev_pyr[0].shape[1:])} bs={bs0} D={2 * R0f + 1} "
            "(adaptive fast tier)", main=False)
    # The exhaustive dense init of `-sp 0`: bs 2, D = 2*sw + bs = 6.
    p6, c6 = bbme.exhaustive_inputs(prev_pyr[0], curr_pyr[0], bs0, cfg.search_window)
    D6 = 2 * cfg.search_window + bs0
    compare("cost_volume_rowoffset", (p6, c6, bs0, D6, MSE),
            f"B={BATCH_720P} {tuple(prev_pyr[0].shape[1:])} MSE bs={bs0} "
            f"D={D6} (GME -sp 0 dense init)", main=False)
    del p0, c0, p6, c6

    bs = cfg.block_size
    R2 = min(cfg.volume_radius, max(prev.shape[1:]))
    p2, c2 = bbme.volume_inputs(prev, curr, bs, R2)
    D2 = 2 * R2 + 1
    compare("cost_volume_mse_block", (p2, c2, bs, D2),
            f"B={BATCH_720P} {tuple(prev.shape[1:])} bs={bs} D={D2}")
    # The largest SSD everywhere: all-0 prev blocks against all-255 windows.
    p2, c2 = torch.zeros_like(p2), torch.full_like(c2, 255)
    compare("cost_volume_mse_block", (p2, c2, bs, D2),
            f"B={BATCH_720P} {tuple(prev.shape[1:])} bs={bs} D={D2} (0 against 255)", main=False)
    check(float(K.cost_volume_mse_block(p2, c2, bs, D2).min()) == SSD_MAX,
          "cost_volume_mse_block: 0 against 255 is not 16,646,400 everywhere")
    # The adaptive fast tier's levels: D 25.
    R2f = cfg.fast_volume_radius
    p2, c2 = bbme.volume_inputs(prev, curr, bs, R2f)
    compare("cost_volume_mse_block", (p2, c2, bs, 2 * R2f + 1),
            f"B={BATCH_720P} {tuple(prev.shape[1:])} bs={bs} D={2 * R2f + 1} (adaptive fast tier)",
            main=False)
    del p2, c2

    # The BBME command line's three-step volume: MAE, bs 12, exact radius 25.
    R3 = bbme.threestep_search_radius(CLI_BS, CLI_SW)
    p3, c3 = bbme.volume_inputs(prev[:BATCH_SEARCH], curr[:BATCH_SEARCH], CLI_BS, R3)
    D3 = 2 * R3 + 1
    compare("cost_volume_rowoffset", (p3, c3, CLI_BS, D3, MAE),
            f"B={BATCH_SEARCH} {tuple(prev.shape[1:])} MAE bs={CLI_BS} D={D3} (three-step)")
    del p3, c3
    # The exhaustive search's volume at the same defaults: D = 2 sw + bs = 28.
    pe, ce = bbme.exhaustive_inputs(prev[:BATCH_SEARCH], curr[:BATCH_SEARCH], CLI_BS, CLI_SW)
    De = 2 * CLI_SW + CLI_BS
    compare("cost_volume_rowoffset", (pe, ce, CLI_BS, De, MAE),
            f"B={BATCH_SEARCH} {tuple(prev.shape[1:])} MAE bs={CLI_BS} D={De} (exhaustive)",
            main=False)
    del pe, ce
    # The volume diamond at bs 20: MAE, D 65.
    p20, c20 = bbme.volume_inputs(prev[:BS20_BATCH], curr[:BS20_BATCH], 20, BS20_RADIUS)
    compare("cost_volume_rowoffset", (p20, c20, 20, 2 * BS20_RADIUS + 1, MAE),
            f"B={BS20_BATCH} {tuple(prev.shape[1:])} MAE bs=20 D={2 * BS20_RADIUS + 1} "
            "(volume diamond at bs 20)", main=False)
    del p20, c20

    # The level-2 cross volume of the GME step at volume_radius=64: B 8,
    # bs 16, D 129; its yardstick is one grouped conv2d in float32 (exact:
    # integer sums below 2**24), TF32 off.  Then its SSD mode, against the
    # plain decomposition.
    R64 = 64
    p4, c4 = bbme.volume_inputs(prev[:BATCH_SEARCH], curr[:BATCH_SEARCH], bs, R64)
    D4 = 2 * R64 + 1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        compare("cost_volume_cross", (p4, c4, bs, D4),
                f"B={BATCH_SEARCH} {tuple(prev.shape[1:])} bs={bs} D={D4}",
                library=cross_library(torch, p4, c4, bs, D4))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    compare("cost_volume_cross", (p4, c4, bs, D4),
            f"B={BATCH_SEARCH} {tuple(prev.shape[1:])} bs={bs} D={D4}", main=False,
            kw={"ssd": True})
    # The decomposed MSE (one cross-kernel launch in SSD mode) against the
    # direct MSE volume of the row-offset kernel and the plain version.
    torch.cuda.synchronize()
    K.reset_launch_counts()
    bbme._dfd_cost_volume(p4, c4, bs, D4, MSE)
    torch.cuda.synchronize()
    check(K.LAUNCHES == dict(K.LAUNCHES, cost_volume_cross=1) and sum(K.LAUNCHES.values()) == 1,
          f"the decomposed MSE is not one cost_volume_cross launch: {K.LAUNCHES}")
    ways = {"decomposed": lambda: bbme._dfd_cost_volume(p4, c4, bs, D4, MSE),
            "direct": lambda: K.cost_volume_rowoffset(p4, c4, bs, D4, MSE)}
    want = K.cost_volume_plain(p4, c4, bs, D4, MSE)
    notes = []
    for way, fn in ways.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check(torch.equal(fn(), want), f"the {way} MSE volume differs from the plain one")
        extra = torch.cuda.max_memory_allocated() - base
        notes.append(f"{way} {cuda_ms(torch, fn, KERNEL_REPS):.4f} ms, "
                     f"{extra / 2**30:.2f} GiB above its inputs")
    phase("kernels", f"MSE B={BATCH_SEARCH} bs={bs} D={D4}: decomposed (one cost_volume_cross "
          f"launch, SSD mode) == direct == plain; {'; '.join(notes)} ({card})")
    del p4, c4, want

    # The chases at the shapes the paths give them: the default step's level
    # 2 (the records' shape) and dense init, the radius-64 step's level 2 and
    # the volume diamond at bs 20 (the select chain's clamp rule).  The volume
    # chase is held to its plain version and to the rank-map chase on
    # `_succ_map`'s map, cut at 1, 3 and 4096 steps; the rank-map chase keeps
    # its timed comparison at level 2.
    H, W = prev.shape[1:]
    chase_shapes = [
        ("level 2", prev, curr, bs, R2, MSE, True),
        ("dense init", prev_pyr[0], curr_pyr[0], bs0, R0, MSE, False),
        ("radius 64", prev[:BATCH_SEARCH], curr[:BATCH_SEARCH], bs, R64, MSE, False),
        ("bs 20", prev[:BS20_BATCH], curr[:BS20_BATCH], 20, BS20_RADIUS, MAE, False),
    ]
    for label, p, c, cbs, R, pnorm, main in chase_shapes:
        Hs, Ws = p.shape[1:]
        D = 2 * R + 1
        volume = bbme.compute_cost_volume(p, c, cbs, R, pnorm)
        origins = bbme._block_origins(Hs // cbs, Ws // cbs, cbs, dev)
        rank = bbme._succ_map(volume, origins, Hs, Ws, cbs, R).reshape(-1, D * D)
        og = origins.expand(volume.shape[:-1] + (2,)).reshape(-1, 2)
        bounds = torch.stack([-og[:, 0], (Hs - cbs - 1) - og[:, 0], -og[:, 1],
                              (Ws - cbs - 1) - og[:, 1]], dim=1).to(torch.int32).contiguous()
        volume = volume.reshape(-1, D * D)
        packed = bbme._packed_rule(cbs)
        note = f"{label} B={p.shape[0]} {(Hs, Ws)} C={rank.shape[0]} bs={cbs} D={D}"
        for iters in CHASE_ITERS:
            got = K.chase_volume(volume, bounds, D, R, iters, packed)
            agree("chase_volume", got, K.chase_fixpoint_plain(rank, bounds, D, R, iters))
            agree("chase_volume", got, K.chase_volume_plain(volume, bounds, D, R, iters, packed))
        phase("kernels", f"chase_volume {note} ({'packed' if packed else 'select'} clamp rule): "
              f"== chase_volume_plain == chase_fixpoint_plain on the rank map at max_iters "
              f"{list(CHASE_ITERS)}")
        if main:
            compare("chase_fixpoint", (rank, bounds, D, R, cfg.max_search_iters),
                    f"{label} C={rank.shape[0]} D={D}")
        del rank
        compare("chase_volume", (volume, bounds, D, R, cfg.max_search_iters, packed), note,
                main=main)
        del volume, bounds, got
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.randint(-40, 41, (BATCH_720P, H // bs, W // bs, 2), dtype=torch.int32,
                      device=dev, generator=gen)
    compare("warp_block_field", (prev, d, bs), f"B={BATCH_720P} {(H, W)} bs={bs}")
    del d, prev_pyr, curr_pyr
    torch.cuda.empty_cache()

    # Phase 4: the block-matching goldens on the card, both engines.
    g = np.load(os.path.join(GOLDEN_DIR, "bbme_synthetic.npz"))
    gprev = torch.from_numpy(g["prev"])[None].to(dev)
    gcurr = torch.from_numpy(g["curr"])[None].to(dev)
    n_cases = 0
    for sp in range(4):
        for pn in (MAE, MSE):
            for gbs, gsw in ((4, 2), (8, 4), (12, 8)):
                ref = g[f"mf_sp{sp}_pn{pn}_bs{gbs}_sw{gsw}"]
                for impl in (("volume", "gather") if sp else ("auto",)):
                    f = bbme.get_motion_field(gprev, gcurr, block_size=gbs, search_window=gsw,
                                              searching_procedure=sp, pnorm_distance=pn,
                                              search_impl=impl)
                    check(np.array_equal(f[0].cpu().numpy(), ref),
                          f"bbme golden sp{sp} pn{pn} bs{gbs} sw{gsw} {impl} differs")
                    n_cases += 1
    h = np.load(os.path.join(GOLDEN_DIR, "hierarchical_bbme.npz"))
    hf = gme_tpu_torch.hierarchical_wrapper(torch.from_numpy(h["prev"])[None].to(dev),
                                            torch.from_numpy(h["curr"])[None].to(dev),
                                            block_size=10, search_window=4,
                                            searching_procedure=3)
    check(np.array_equal(hf[0].cpu().numpy(), h["field"]), "hierarchical golden differs")
    phase("goldens", f"bbme_synthetic: 24 cases, {n_cases} (case, engine) runs on the card equal "
          "the goldens; hierarchical_bbme equal")

    # Phase 5: get_motion_field at the BBME command line's defaults, 720p.
    sp_prev, sp_curr = prev[:BATCH_SEARCH], curr[:BATCH_SEARCH]
    crop = (slice(0, 1), slice(0, 360), slice(0, 640))
    for sp in range(4):
        kw = dict(block_size=CLI_BS, search_window=CLI_SW, searching_procedure=sp,
                  pnorm_distance=MAE, return_diagnostics=True)
        path = f"search {SEARCH_NAMES[sp]}"
        kernels = ("cost_volume_rowoffset",) + (("chase_volume",) if sp == 3 else ())
        (field, diag), wall, _ = timed(
            torch, lambda: counted(torch, K, path,
                                   lambda: bbme.get_motion_field(sp_prev, sp_curr, **kw),
                                   kernels, launch_log, captured))
        check(field.shape == (BATCH_SEARCH, H // CLI_BS, W // CLI_BS, 2)
              and field.dtype == torch.int32, f"{path}: unexpected field")
        inner = field[:, 2:-2, 2:-2].reshape(-1, 2).cpu().numpy()
        found = float((inner == [PAN_STEP[1], PAN_STEP[0]]).all(axis=1).mean())
        if sp in (0, 3):  # the step sizes of three-step and 2D-log miss (3, 6)
            check(found >= (0.9 if sp == 0 else 0.8),
                  f"{path}: the pan is found in only {found:.3f} of the inner cells")
        small = bbme.get_motion_field(prev[crop].cpu(), curr[crop].cpu(), **kw)
        on_card = bbme.get_motion_field(prev[crop], curr[crop], **kw)
        check(torch.equal(small[0], on_card[0].cpu())
              and torch.equal(small[1]["volume_edge_hits"], on_card[1]["volume_edge_hits"].cpu()),
              f"{path}: the card and the CPU differ on a 360x640 crop")
        phase("search", f"{SEARCH_NAMES[sp]} MAE bs={CLI_BS} sw={CLI_SW} B={BATCH_SEARCH} 720p: "
              f"{wall * 1e3:.2f} ms, {BATCH_SEARCH / wall:.1f} pairs/s ({card}); inner cells on "
              f"the pan {found:.3f}; volume_edge_hits {diag['volume_edge_hits'].tolist()}; "
              f"360x640 crop == CPU; launches {launch_log[path]}")

    # Phase 6: the GME options on the pan240 golden pairs, card == CPU.
    gp = np.load(GOLDENS)
    pan_prev = torch.from_numpy(np.stack([gp[f"prev_{a}_{b}"] for a, b in PAN240_PAIRS]))
    pan_curr = torch.from_numpy(np.stack([gp[f"curr_{a}_{b}"] for a, b in PAN240_PAIRS]))
    for opt, (kw, _) in GME_OPTIONS.items():
        ocfg = cfg.replace(**kw)
        on_card = gme_tpu_torch.gme_pipeline_batch(pan_prev.to(dev), pan_curr.to(dev), ocfg)
        on_cpu = gme_tpu_torch.gme_pipeline_batch(pan_prev, pan_curr, ocfg)
        for k in INT_KEYS + ("parameters",):
            check(torch.equal(on_card[k].cpu(), on_cpu[k]), f"pan240 {opt}: card {k} differs from the CPU")
        phase("options", f"pan240 {opt}: card == CPU (integers and parameters exact); psnr "
              f"{[round(float(v), 4) for v in on_card['psnr']]}, volume_edge_hits "
              f"{on_card['volume_edge_hits'].tolist()}")

    # Phase 7: the GME options at 720p, 8 pairs.
    for opt, (kw, kernels) in GME_OPTIONS.items():
        ocfg = cfg.replace(**kw)
        path = f"gme {opt}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, wall, walls = timed(torch, lambda: counted(
            torch, K, path, lambda: gme_tpu_torch.gme_pipeline_batch(sp_prev, sp_curr, ocfg),
            kernels, launch_log, captured))
        peak = torch.cuda.max_memory_allocated()
        params = out["parameters"].cpu().numpy()
        check(bool(np.isfinite(params).all()) and bool(torch.isfinite(out["psnr"]).all())
              and out["compensated"].shape == sp_prev.shape, f"{path}: bad outputs")
        found = np.abs(params[:, [0, 3]] - [PAN_STEP[1], PAN_STEP[0]]).max(axis=1) < 0.5
        phase("options", f"{opt} B={BATCH_SEARCH} 720p: step {wall * 1e3:.1f} ms "
              f"(walls {[round(w * 1e3, 1) for w in walls]}), {BATCH_SEARCH / wall:.2f} pairs/s, "
              f"peak {peak / 2**30:.2f} GiB ({card}); pan recovered in {int(found.sum())}/"
              f"{BATCH_SEARCH}; psnr avg {float(out['psnr'].mean()):.4f}; volume_edge_hits "
              f"{out['volume_edge_hits'].tolist()}; launches {launch_log[path]}")
        del out
    del sp_prev, sp_curr
    torch.cuda.empty_cache()

    # Phase 8: the pan240 golden pairs as one batch, default configuration.
    gpu = gme_tpu_torch.gme_pipeline_batch(pan_prev.to(dev), pan_curr.to(dev))
    gpu = {k: v.cpu() for k, v in gpu.items()}
    cpu = gme_tpu_torch.gme_pipeline_batch(pan_prev, pan_curr)
    for i, (a, b) in enumerate(PAN240_PAIRS):
        perr = float(np.abs(gpu["parameters"][i].numpy() - gp[f"params_{a}_{b}"]).max())
        cells = float((gpu["model_motion_field"][i].numpy() != gp[f"mf_{a}_{b}"]).any(-1).mean())
        dpsnr = abs(float(gpu["psnr"][i]) - float(gp[f"psnr_{a}_{b}"]))
        phase("pan240", f"pair {a}-{b}: psnr {float(gpu['psnr'][i]):.4f} dB "
              f"(golden {float(gp[f'psnr_{a}_{b}']):.4f}), params err {perr:.2e}, "
              f"field cells differing {cells:.3f}, volume_edge_hits {int(gpu['volume_edge_hits'][i])}")
        check(perr < 5e-3 and cells <= 0.02 and dpsnr < 0.2,
              f"pan240 pair {a}-{b} outside the reference tolerances")
    for k in INT_KEYS + ("parameters",):
        check(torch.equal(gpu[k], cpu[k]), f"pan240: GPU {k} differs from the CPU plain run")
    dpsnr = float((gpu["psnr"] - cpu["psnr"]).abs().max())
    check(dpsnr <= 1e-4, f"pan240: GPU psnr differs from the CPU run by {dpsnr}")
    phase("pan240", f"GPU run == CPU plain run: integers and parameters exact, psnr within {dpsnr:.2e} dB")

    # Phase 9: the 720p batch through the default step.
    def step():
        return gme_tpu_torch.gme_pipeline_batch(prev, curr, cfg)

    warm = counted(torch, K, "gme default", step, DEFAULT_KERNELS, launch_log, captured)
    launches = launch_log["gme default"]
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    hits = out["volume_edge_hits"].cpu().numpy()
    params = out["parameters"].cpu().numpy()
    phase("720p", f"B={BATCH_720P} step {wall * 1e3:.1f} ms (walls {[round(w * 1e3, 1) for w in walls]}), "
          f"{BATCH_720P / wall:.2f} pairs/s, peak {peak / 2**30:.2f} GiB ({card})")
    phase("720p", f"volume_edge_hits per pair {hits.tolist()}; ring-visited pairs {int((hits > 0).sum())}")
    phase("720p", f"psnr avg {float(out['psnr'].mean()):.4f} min {float(out['psnr'].min()):.4f} "
          f"max {float(out['psnr'].max()):.4f}; launches {launches}")
    check(out["compensated"].shape == prev.shape and out["parameters"].shape == (BATCH_720P, 6),
          "720p: unexpected output shapes")
    check(bool(np.isfinite(params).all()) and bool(torch.isfinite(out["psnr"]).all()),
          "720p: non-finite parameters or psnr")
    for k in warm:
        check(torch.equal(warm[k], out[k]), f"720p: {k} differs between two runs")
    found = np.abs(params[:, [0, 3]] - [PAN_STEP[1], PAN_STEP[0]]).max(axis=1) < 0.5
    phase("720p", f"pan {PAN_STEP} recovered (|a0-{PAN_STEP[1]}|, |b0-{PAN_STEP[0]}| < 0.5) "
          f"in {int(found.sum())}/{BATCH_720P} pairs")
    check(found.mean() >= 0.9, "720p: the synthetic pan is not recovered")
    one = gme_tpu_torch.gme_pipeline_batch(prev[:1].cpu(), curr[:1].cpu(), cfg)
    for k in INT_KEYS + ("parameters",):
        check(torch.equal(one[k][0], out[k][0].cpu()), f"720p pair 0: GPU {k} differs from the CPU run")
    phase("720p", "pair 0: GPU run == CPU plain run (integers and parameters exact)")
    del warm, out, prev, curr
    torch.cuda.empty_cache()

    # Phase 10: the results driver and the command line over whole videos.
    # Its videos and outputs go to a directory of its own under chiprun_out/,
    # removed afterwards.
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_driver_", dir=out_dir)
    try:
        driver_phase(torch, K, card, launch_log, captured, work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # Phases 11-13: direct GME, meshes on the card, two processes.
    work = tempfile.mkdtemp(prefix="smoke_mesh_", dir=out_dir)
    try:
        direct_phase(torch, card, dev, work)
        torch.cuda.empty_cache()
        clip, want = mesh_phase(torch, K, card, launch_log, captured, dev, work)
        torch.cuda.empty_cache()
        multihost_phase(torch, card, dev, work, clip, want)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # Phase 14: each kernel against its plain version at every shape the
    # counted paths gave it, on the paths' own inputs; the cross kernel in
    # both modes.
    for key in sorted(captured, key=str):
        kernel = key[0]
        host_args, kw = captured.pop(key)
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in host_args]
        modes = ([{"ssd": False}, {"ssd": True}] if kernel == "cost_volume_cross" and args[2] <= 16
                 else [kw])
        for mode in modes:
            err = agree(kernel, getattr(K, kernel)(*args, **mode), plain_of[kernel](*args, **mode))
            ms = cuda_ms(torch, lambda: getattr(K, kernel)(*args, **mode), PLAIN_REPS)
            floor, _ = floor_of(kernel, args)
            bound_ms, bound_by, binds = bound(K, kernel, args, floor)
            phase("paths", f"{kernel} {key[1:]}{' ' + str(mode) if mode else ''}: bit-equal=True "
                  f"max_abs_err={err} kernel {ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}, "
                  f"{binds} binds, share {max(bound_ms, floor) / ms:.4f} ({card})")
        del args
    for k in K.LAUNCHES:
        check("ms" in records[k], f"{k}: no main-path shape was timed")

    kernels = [
        {"name": k, "route": "cuda", "source": f"gme_tpu_torch/csrc/{k}.cu",
         "replaces": REPLACES[k], "launches": launch_log[MAIN_PATH[k]][k], **records[k]}
        for k in K.LAUNCHES
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    return {"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device; this smoke run needs the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "gme_tpu_torch")):
        print("chip_smoke: FAIL: gme_tpu_torch/ is not beside chip_smoke.py; "
              "run it from the repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        result = run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
