#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gme_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  It builds the port's kernels from the sources in the
checkout, holds each kernel to its plain PyTorch version at the main path's
720p shapes, runs the per-pair step on the three pan240 golden pairs
(against the goldens and against the port's own CPU run) and on a 24-pair
720p synthetic pan, and prints one line per phase.  The last lines are a
JSON record of the kernels, the card's name and power limit from
nvidia-smi, and `{"ok": true, "device": {...}}`.  Any failure exits
non-zero before that last line; without a CUDA device it fails at once.
It imports neither `jax` nor `gme_tpu`.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens", "pan240_pipeline.npz")
PAN240_PAIRS = [(10, 11), (60, 61), (150, 151)]
INT_KEYS = ("model_motion_field", "compensated", "diff_curr_prev",
            "diff_curr_comp", "volume_edge_hits")
BATCH_720P = 24          # the 720p batch of bench.py
PAN_STEP = (3, 6)        # synthetic pan: (rows, cols) per frame at 720p
KERNEL_REPS, PLAIN_REPS = 10, 3

# The Pallas kernel each CUDA kernel replaces (kernel body, file:line).
REPLACES = {
    "cost_volume_small_block": "gme_tpu/ops/pallas_kernels.py:128",
    "cost_volume_mse_block": "gme_tpu/ops/pallas_kernels.py:228",
    "chase_fixpoint": "gme_tpu/ops/pallas_kernels.py:872",
    "warp_block_field": "gme_tpu/ops/pallas_kernels.py:719",
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


def max_abs_err(torch, a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def ptxas_summary(log):
    """kernel -> 'N registers, S B stack, spills st/ld' from nvcc -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+([a-z_]+)_kernel", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = f"stack {m.group(1)} B, spill stores {m.group(2)} B, spill loads {m.group(3)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out[name] += f", {m.group(1)} registers, static smem {smem.group(1) if smem else 0} B"
    return out


def run(torch):
    import gme_tpu_torch
    from gme_tpu_torch.config import MSE, GMEConfig
    from gme_tpu_torch.ops import bbme
    from gme_tpu_torch.ops import cuda_kernels as K

    dev = torch.device("cuda", 0)
    cfg = GMEConfig()

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

    # Phase 2: build from the checkout's sources.
    built = K.build(force=True)
    phase("build", f"nvcc {built.seconds:.1f} s -> {os.path.relpath(built.path, HERE)}")
    summary = ptxas_summary(built.log)
    for kernel in K.LAUNCHES:
        check(kernel in summary, f"ptxas printed nothing for {kernel}")
        phase("build", f"{kernel}: {summary[kernel]}")
    K.load_library()

    # Inputs at the main path's 720p shapes: the 24-pair synthetic pan.
    frames = synthetic_pan(BATCH_720P + 1, 720, 1280, PAN_STEP)
    prev = torch.from_numpy(frames[:-1]).to(dev)
    curr = torch.from_numpy(frames[1:]).to(dev)
    prev_pyr = gme_tpu_torch.get_pyramids(prev, cfg.pyramid_levels)
    curr_pyr = gme_tpu_torch.get_pyramids(curr, cfg.pyramid_levels)

    # Phase 3: each kernel against its plain version, bit for bit.
    records = {}

    def compare(kernel, run_kernel, run_plain, shape_note):
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        ms = cuda_ms(torch, run_kernel, KERNEL_REPS)
        plain_ms = cuda_ms(torch, run_plain, PLAIN_REPS)
        records[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        phase("kernels", f"{kernel} {shape_note}: bit-equal={equal} max_abs_err={err} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        check(equal, f"{kernel} disagrees with its plain version (max_abs_err {err})")

    R0 = min(cfg.dense_volume_radius, max(prev_pyr[0].shape[1:]))
    p0, c0 = bbme.volume_inputs(prev_pyr[0], curr_pyr[0], cfg.dense_block_size, R0)
    D0 = 2 * R0 + 1
    compare("cost_volume_small_block",
            lambda: K.cost_volume_small_block(p0, c0, cfg.dense_block_size, D0, MSE),
            lambda: K.cost_volume_plain(p0, c0, cfg.dense_block_size, D0, MSE),
            f"B={BATCH_720P} {tuple(prev_pyr[0].shape[1:])} bs={cfg.dense_block_size} D={D0}")
    del p0, c0

    R2 = min(cfg.volume_radius, max(prev.shape[1:]))
    p2, c2 = bbme.volume_inputs(prev, curr, cfg.block_size, R2)
    D2 = 2 * R2 + 1
    compare("cost_volume_mse_block",
            lambda: K.cost_volume_mse_block(p2, c2, cfg.block_size, D2),
            lambda: K.cost_volume_plain(p2, c2, cfg.block_size, D2, MSE),
            f"B={BATCH_720P} {tuple(prev.shape[1:])} bs={cfg.block_size} D={D2}")
    del p2, c2

    H, W = prev.shape[1:]
    bs = cfg.block_size
    volume = bbme.compute_cost_volume(prev, curr, bs, R2, MSE)
    origins = bbme._block_origins(H // bs, W // bs, bs, dev)
    rank = bbme._succ_map_packed(volume, origins, H, W, bs, R2).reshape(-1, D2 * D2)
    del volume
    og = origins.expand((BATCH_720P,) + origins.shape).reshape(-1, 2)
    bounds = torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                         dim=1).to(torch.int32).contiguous()
    it = cfg.max_search_iters
    compare("chase_fixpoint",
            lambda: K.chase_fixpoint(rank, bounds, D2, R2, it),
            lambda: K.chase_fixpoint_plain(rank, bounds, D2, R2, it),
            f"C={rank.shape[0]} D={D2}")
    del rank, bounds

    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.randint(-40, 41, (BATCH_720P, H // bs, W // bs, 2), dtype=torch.int32,
                      device=dev, generator=gen)
    compare("warp_block_field",
            lambda: K.warp_block_field(prev, d, bs),
            lambda: K.warp_block_field_plain(prev, d, bs),
            f"B={BATCH_720P} {(H, W)} bs={bs}")
    del d, prev_pyr, curr_pyr
    torch.cuda.empty_cache()

    # Phase 4: the pan240 golden pairs as one batch.
    g = np.load(GOLDENS)
    gp = np.stack([g[f"prev_{a}_{b}"] for a, b in PAN240_PAIRS])
    gc = np.stack([g[f"curr_{a}_{b}"] for a, b in PAN240_PAIRS])
    gpu = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(gp).to(dev), torch.from_numpy(gc).to(dev))
    gpu = {k: v.cpu() for k, v in gpu.items()}
    cpu = gme_tpu_torch.gme_pipeline_batch(torch.from_numpy(gp), torch.from_numpy(gc))
    for i, (a, b) in enumerate(PAN240_PAIRS):
        perr = float(np.abs(gpu["parameters"][i].numpy() - g[f"params_{a}_{b}"]).max())
        cells = float((gpu["model_motion_field"][i].numpy() != g[f"mf_{a}_{b}"]).any(-1).mean())
        dpsnr = abs(float(gpu["psnr"][i]) - float(g[f"psnr_{a}_{b}"]))
        phase("pan240", f"pair {a}-{b}: psnr {float(gpu['psnr'][i]):.4f} dB "
              f"(golden {float(g[f'psnr_{a}_{b}']):.4f}), params err {perr:.2e}, "
              f"field cells differing {cells:.3f}, volume_edge_hits {int(gpu['volume_edge_hits'][i])}")
        check(perr < 5e-3 and cells <= 0.02 and dpsnr < 0.2,
              f"pan240 pair {a}-{b} outside the reference tolerances")
    for k in INT_KEYS + ("parameters",):
        check(torch.equal(gpu[k], cpu[k]), f"pan240: GPU {k} differs from the CPU plain run")
    dpsnr = float((gpu["psnr"] - cpu["psnr"]).abs().max())
    check(dpsnr <= 1e-4, f"pan240: GPU psnr differs from the CPU run by {dpsnr}")
    phase("pan240", f"GPU run == CPU plain run: integers and parameters exact, psnr within {dpsnr:.2e} dB")

    # Phase 5: the 720p batch through the main path.
    def step():
        out = gme_tpu_torch.gme_pipeline_batch(prev, curr, cfg)
        torch.cuda.synchronize()
        return out

    warm = step()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = step()
    walls = [time.perf_counter() - t0]
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    hits = out["volume_edge_hits"].cpu().numpy()
    params = out["parameters"].cpu().numpy()
    phase("720p", f"B={BATCH_720P} step {wall * 1e3:.1f} ms (walls {[round(w * 1e3, 1) for w in walls]}), "
          f"{BATCH_720P / wall:.2f} pairs/s, peak {peak / 2**30:.2f} GiB ({card})")
    phase("720p", f"volume_edge_hits per pair {hits.tolist()}; ring-visited pairs {int((hits > 0).sum())}")
    phase("720p", f"psnr avg {float(out['psnr'].mean()):.4f} min {float(out['psnr'].min()):.4f} "
          f"max {float(out['psnr'].max()):.4f}; launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path did not launch: {launches}")
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

    kernels = [
        {"name": k, "route": "cuda", "source": f"gme_tpu_torch/csrc/{k}.cu",
         "replaces": REPLACES[k], "launches": launches[k], **records[k]}
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
