#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths, on one CUDA card (and across cards).

    python3 chip_profile.py [--reps 5]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  For each 720p path of `chip_smoke.py` (the searches at
the BBME command line's defaults, the GME step under `-sp 0/1/2` and a
volume radius of 64 on 8 pairs, the default step on 24 pairs), run eagerly
(`get_motion_field`, `gme_pipeline_batch_eager`) and compiled into CUDA
graphs (`get_motion_field_jit`, `gme_pipeline_batch`), it prints:

- the host time of one call (median of `--reps` synchronised calls after two
  warm-up calls, no profiler attached), and the time a call of `--reps`
  calls back to back with no synchronise between them (CUDA events);
- the device's busy time in one profiled call: the union of the intervals of
  the device's own activity (kernels, copies, fills) that `torch.profiler`
  records, not the CPU-side operator rows, which hold their kernels' time a
  second time;
- the idle share, 1 - busy / host time, and the largest device items;
- the peak device memory of that call, and the memory the allocator holds
  then (a compiled path's graph pools are reserved, not allocated, between
  replays).

Then it reads the latency-bound kernels at the default step's 720p shapes
(the rank-map chase `chase_fixpoint`, the volume chase `chase_volume` where
the package has it, and `warp_block_field`) and the launch floor (a
one-element fill) three ways: CUDA events around a loop of wrapper calls,
the device's own duration from torch.profiler, and the wrapper's host time
a call.  Where more than one card is visible, `[cards]`: the spatial band
program over min(4, cards) distinct cards for one 720p pair under
diamond, three-step and exhaustive, eager and compiled (per-card graphs
split at the collectives), each held to the 1x1 step bit for bit, then in
turns, with the host time, the back-to-back time, the host's own time by
name (operators and CUDA runtime calls) in the profiled call, each card's
busy time, idle share, peak memory and device activities, and the
compiled program's graphs, collective steps, copies and event pairs a
call.  With `--parent DIR` (a checkout of
the parent commit inside the repository, e.g. unpacked with `git archive`
into a gitignored directory), `[cards]` runs the parent tree and this one
in turns, parent, change, change, parent, each in a process of its own;
`--cards-only` runs `[cards]` alone.  Then `[stages]`: the default 720p
step at batch 24 stage by stage
(`gme_tpu_torch.tools.profile_stages`, `2 * --reps` timed replays a
stage), with the sum of its disjoint stages against the compiled step's
busy time.  Then it runs the volume kernels at their paths' shapes while
nvidia-smi samples the SM clock: the packed-word `cost_volume_rowoffset` at
the three-step (bs 12, D 51), 2D-log/diamond (bs 12, D 65) and bs-20
diamond (D 65) shapes, the tensor-core `cost_volume_cross` in both modes at
level 2 and level 1 of the radius-64 step, and `cost_volume_mse_block` at
level 1 of the default step, each against the bound of `chip_smoke.bound`
(int32 operations or bytes), with its device time from torch.profiler and
the wrapper's host time a call.  Where the toolkit has cuobjdump, it writes the SASS of the
row-offset kernel's three-step instantiation (`<3, 0>`: three words a block
row, MAE) to chiprun_out/ and prints its instruction mix.  The last line is
one JSON object with every number printed.  It imports neither `jax` nor
`gme_tpu`, and needs the card.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import (BATCH_720P, BATCH_SEARCH, BS20_BATCH, BS20_RADIUS, CLI_BS, CLI_SW, HERE,
                        GME_OPTIONS, PAN_STEP, SEARCH_NAMES, bound, busy_intervals, cuda_ms,
                        device_ms, host_us, synthetic_pan)

# The row-offset kernel's three-step instantiation: 3 words a block row, MAE.
THREE_STEP_SASS = "cost_volume_rowoffset_kernelILi3ELi0E"


def smi(*fields):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def profile_path(torch, fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # Back to back: CUDA events around `reps` calls with no synchronise
    # between them, the rate a caller that keeps the card fed gets.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    events_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    busy_us, by_name = busy_intervals(torch, prof)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device activity")
    wall_ms = float(np.median(walls)) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "walls_ms": [w * 1e3 for w in walls], "events_ms": events_ms,
            "device_busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e3 / wall_ms,
            "peak_gib": peak / 2**30, "reserved_gib": reserved / 2**30, "top_ms": [[name[:60], us / 1e3] for name, us in top]}


def clocked(torch, fn, seconds=2.0):
    """Run `fn` back to back for about `seconds` while nvidia-smi samples the
    SM clock every 100 ms; (median MHz under load, max MHz)."""
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        sampler.terminate()
        out, _ = sampler.communicate(timeout=30)
    mhz = [float(v) for v in out.split() if v.strip().replace(".", "").isdigit()]
    if len(mhz) < 3:
        raise RuntimeError(f"nvidia-smi gave too few SM clock samples: {out!r}")
    under_load = float(np.median(mhz[1:-1]))
    return under_load, float(smi("clocks.max.sm").split()[0])


def sass_mix(K):
    """Instruction counts of the row-offset kernel's three-step instantiation
    by opcode, its SASS written to chiprun_out/; None where the toolkit has no
    cuobjdump or the library has no such function."""
    import chip_smoke

    sass = chip_smoke.read_sass(K, K.build().path)
    if sass is None:
        return None
    funcs = chip_smoke.sass_functions(sass)
    fn = next((f for f in funcs if THREE_STEP_SASS in f), None)
    if fn is None:
        return None
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sass_cost_volume_rowoffset_w3_mae.txt"), "w") as f:
        f.write("\n".join(funcs[fn]) + "\n")
    mix = collections.Counter()
    for line in funcs[fn]:
        op = line.split("*/", 1)[1].split(";")[0].split()
        op = op[1] if op and op[0].startswith("@") and len(op) > 1 else (op[0] if op else "?")
        mix[op.split(".")[0]] += 1
    return dict(mix.most_common())


def profile_cards(torch, fn, reps, cards):
    """`profile_path` over several cards: the host time of a call
    synchronised on every card, and per card the busy time (the union of
    that card's device events in one profiled call), idle share and peak
    memory."""
    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    for _ in range(2):
        fn()
    sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    # Back to back: CUDA events on card 0 around `reps` calls with no
    # synchronise between them (every call ends on card 0's stream).
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    events_ms = start.elapsed_time(end) / reps
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync()
    # The host's own time by name in the profiled call (operators and CUDA
    # runtime calls), largest first.
    host = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name] += e.self_cpu_time_total / 1e3
    per = {}
    for d in cards:
        busy_us, _ = busy_intervals(torch, prof, d.index)
        if busy_us <= 0:
            raise RuntimeError(f"the profiler recorded no device activity on {d}")
        items = sum(e.device_type == torch.autograd.DeviceType.CUDA and e.device_index == d.index
                    for e in prof.events())
        per[str(d)] = {"busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e3 / wall_ms,
                       "peak_gib": torch.cuda.max_memory_allocated(d) / 2**30,
                       "device_items": items}
    return {"wall_ms": wall_ms, "walls_ms": [w * 1e3 for w in walls], "events_ms": events_ms,
            "host_top_ms": [[n[:60], ms] for n, ms in host.most_common(6)], "cards": per}


def band_program_across_cards(torch, prev, curr, reps, card, label="change"):
    """`[cards]`: the spatial band program over min(4, visible) distinct
    cards, one 720p pair (on card 0) under diamond, three-step and
    exhaustive: the eager program and the compiled one (per-card graphs
    split at the collectives), each first held to the 1x1 step on card 0
    bit for bit, then in turns, eager, compiled, compiled, eager; the
    compiled program's graphs, collective steps, copies and event pairs a
    call, and whether peer access was enabled.  `label` names the tree in
    the lines (`--parent`)."""
    import gme_tpu_torch
    from gme_tpu_torch.config import GMEConfig
    from gme_tpu_torch.parallel import spatial as SP
    from gme_tpu_torch.parallel.mesh import make_mesh
    from gme_tpu_torch.utils import compiled as CP

    S = min(4, torch.cuda.device_count())
    cards = [torch.device("cuda", i) for i in range(S)]
    H, W = prev.shape[1:]
    base = GMEConfig(search_impl="volume")
    out = {}
    for name, cfg in (("diamond", base), ("three-step", base.replace(searching_procedure=1)),
                      ("exhaustive", base.replace(searching_procedure=0))):
        mesh = make_mesh(1, S, cards)
        fns = {"eager": SP.make_spatial_pipeline_eager(mesh, cfg, H, W),
               "compiled": SP.make_spatial_pipeline(mesh, cfg, H, W)}
        want = gme_tpu_torch.gme_pipeline_batch(prev, curr, cfg)
        for kind, fn in fns.items():
            got = fn(prev, curr)
            differ = [k for k in want if not torch.equal(got[k], want[k])]
            if differ:
                raise RuntimeError(f"[cards] {label} {name} {kind}: {differ} differ from the 1x1 "
                                   "step on card 0")
        for turn, kind in enumerate(("eager", "compiled", "compiled", "eager")):
            r = profile_cards(torch, lambda fn=fns[kind]: fn(prev, curr), reps, cards)
            out[f"{name} s{S} {kind} {turn}"] = r
            per = "; ".join(f"{d} busy {c['busy_ms']:.3f} ms idle {c['idle_share']:.3f} peak "
                            f"{c['peak_gib']:.2f} GiB, {c['device_items']} device activities"
                            for d, c in r["cards"].items())
            top = ", ".join(f"{n} {ms:.3f}" for n, ms in r["host_top_ms"])
            print(f"[cards] {label} {name} space={S} {kind} (turn {turn}): host "
                  f"{r['wall_ms']:.3f} ms, back to back {r['events_ms']:.3f} ms a call; {per}; "
                  f"host ms by name in the profiled call: {top} ({card})", flush=True)
        steps = SP.spatial_program_segmented.last_entry.steps
        plan = {"graphs": len(SP.spatial_program_segmented.last_entry.graphs),
                "steps": len(steps), "copies": sum(len(s.copies) for s in steps),
                "event_pairs": sum(getattr(s, "pairs", 0) for s in steps)}
        out[f"{name} s{S} plan"] = plan
        print(f"[cards] {label} {name} space={S}: == the 1x1 step on card 0 bit for bit, eager "
              f"and compiled; compiled a call: {plan['graphs']} graphs, {plan['steps']} collective "
              f"steps, {plan['copies']} copies, {plan['event_pairs']} event pairs ({card})",
              flush=True)
        SP.spatial_program_segmented.clear()
        torch.cuda.empty_cache()
    enabled = getattr(CP, "PEER_ACCESS", None)
    out["peer_enabled"] = None if enabled is None else {f"{i}->{j}": v for (i, j), v in
                                                         sorted(enabled.items())}
    print(f"[cards] {label}: peer access enabled by the program: "
          f"{out['peer_enabled'] if enabled is not None else 'no such record (copy_)'}", flush=True)
    return out


def cards_in_turns(args, card):
    """`[cards]` of the `--parent` tree and of this one in turns, parent,
    change, change, parent, each in a process of its own that imports its
    tree's `gme_tpu_torch`."""
    out = {}
    trees = (("parent", args.parent), ("change", HERE), ("change", HERE), ("parent", args.parent))
    for turn, (label, tree) in enumerate(trees):
        cmd = [sys.executable, os.path.join(HERE, "chip_profile.py"), "--cards-only",
               "--package", tree, "--reps", str(args.reps)]
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"[cards] {label} {turn} failed ({proc.returncode}): "
                               f"{proc.stderr[-3000:]}")
        out[f"{label} {turn}"] = json.loads(lines[-1])["cards"]
    return out


def latency_bound_kernels(torch, K, bbme, prev, curr, cfg, dev, card, reps=10):
    """{name: {ms, device_ms, host_us}} of the launch floor and the
    latency-bound kernels at the default step's level-2 shapes."""
    from gme_tpu_torch.config import MSE

    H, W = prev.shape[1:]
    bs, R = cfg.block_size, cfg.volume_radius
    D = 2 * R + 1
    volume = bbme.compute_cost_volume(prev, curr, bs, R, MSE)
    origins = bbme._block_origins(H // bs, W // bs, bs, dev)
    rank = bbme._succ_map(volume, origins, H, W, bs, R).reshape(-1, D * D)
    og = origins.expand(volume.shape[:-1] + (2,)).reshape(-1, 2)
    bounds = torch.stack([-og[:, 0], (H - bs - 1) - og[:, 0], -og[:, 1], (W - bs - 1) - og[:, 1]],
                         dim=1).to(torch.int32).contiguous()
    volume = volume.reshape(-1, D * D)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.randint(-40, 41, (prev.shape[0], H // bs, W // bs, 2), dtype=torch.int32,
                      device=dev, generator=gen)
    iters = cfg.max_search_iters
    calls = {"launch floor": torch.zeros(1, device=dev).zero_,
             "chase_fixpoint": lambda: K.chase_fixpoint(rank, bounds, D, R, iters)}
    if "chase_volume" in K.LAUNCHES:
        calls["chase_volume"] = lambda: K.chase_volume(volume, bounds, D, R, iters, True)
    calls["warp_block_field"] = lambda: K.warp_block_field(prev, d, bs)
    out = {}
    for name, fn in calls.items():
        ms = cuda_ms(torch, fn, reps)
        dev_ms, names = device_ms(torch, fn, reps)
        us = host_us(torch, fn, reps)
        out[name] = {"ms": ms, "device_ms": dev_ms, "host_us": us, "device_items": names}
        print(f"[latency] {name}: {ms:.4f} ms (events around a loop of {reps} calls), device "
              f"{dev_ms:.4f} ms (torch.profiler: {', '.join(n[:48] for n in names)}), host "
              f"{us:.1f} us a call; C={bounds.shape[0]} D={D}, warp B={prev.shape[0]} "
              f"{(H, W)} bs={bs} ({card})", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", help="a checkout of the parent commit: [cards] then runs it and "
                    "this tree in turns, each in a process of its own")
    ap.add_argument("--cards-only", action="store_true", help="run [cards] alone")
    ap.add_argument("--package", help="the tree whose gme_tpu_torch to import (default: this one)")
    args = ap.parse_args()
    tree_is_here = not args.package or os.path.samefile(args.package, HERE)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: FAIL: no CUDA device", file=sys.stderr)
        return 1
    import gme_tpu_torch
    from gme_tpu_torch.config import MAE, MSE, GMEConfig
    from gme_tpu_torch.ops import bbme
    from gme_tpu_torch.ops import cuda_kernels as K

    card = smi("name", "power.limit")
    print(f"[device] {card}; {torch.cuda.device_count()} cards; gme_tpu_torch from "
          f"{os.path.relpath(os.path.dirname(gme_tpu_torch.__file__), HERE)}", flush=True)
    K.load_library()
    dev = torch.device("cuda", 0)
    frames = synthetic_pan(BATCH_720P + 1, 720, 1280, PAN_STEP)
    prev = torch.from_numpy(frames[:-1]).to(dev)
    curr = torch.from_numpy(frames[1:]).to(dev)
    if args.cards_only:
        if torch.cuda.device_count() < 2:
            print("chip_profile: FAIL: [cards] needs two or more cards", file=sys.stderr)
            return 1
        cards = (cards_in_turns(args, card) if args.parent else
                 band_program_across_cards(torch, prev[:1], curr[:1], args.reps, card,
                                           "change" if tree_is_here else "parent"))
        print(json.dumps({"card": card, "cards": cards}))
        return 0
    sp_prev, sp_curr = prev[:BATCH_SEARCH], curr[:BATCH_SEARCH]
    cfg = GMEConfig()

    # Each path eager (op by op) and compiled (CUDA graph replays), in turns.
    paths = {}
    for sp in range(4):
        kw = dict(block_size=CLI_BS, search_window=CLI_SW, searching_procedure=sp,
                  pnorm_distance=MAE)
        for kind, fn in (("eager", bbme.get_motion_field), ("compiled", bbme.get_motion_field_jit)):
            paths[f"search {SEARCH_NAMES[sp]} {kind}"] = (
                lambda kw=kw, fn=fn: fn(sp_prev, sp_curr, **kw))
    steps = (("eager", gme_tpu_torch.gme_pipeline_batch_eager),
             ("compiled", gme_tpu_torch.gme_pipeline_batch))
    for opt, (kw, _) in GME_OPTIONS.items():
        for kind, fn in steps:
            paths[f"gme {opt} {kind}"] = (lambda ocfg=cfg.replace(**kw), fn=fn:
                                          fn(sp_prev, sp_curr, ocfg))
    for kind, fn in steps:
        paths[f"gme default {kind}"] = lambda fn=fn: fn(prev, curr, cfg)

    result = {"card": card, "paths": {}, "kernels": {}}
    for path, fn in paths.items():
        r = profile_path(torch, fn, args.reps)
        result["paths"][path] = r
        top = ", ".join(f"{n} {ms:.2f}" for n, ms in r["top_ms"])
        print(f"[path] {path}: host {r['wall_ms']:.2f} ms, back to back {r['events_ms']:.2f} ms a "
              f"call, device busy {r['device_busy_ms']:.2f} ms, "
              f"idle {r['idle_share']:.3f}, peak {r['peak_gib']:.2f} GiB, reserved "
              f"{r['reserved_gib']:.2f} GiB ({card}); largest: {top}",
              flush=True)
        torch.cuda.empty_cache()

    if torch.cuda.device_count() > 1:
        result["cards"] = (cards_in_turns(args, card) if args.parent else
                           band_program_across_cards(torch, prev[:1], curr[:1], args.reps, card))
    result["latency"] = latency_bound_kernels(torch, K, bbme, prev, curr, cfg, dev, card)
    torch.cuda.empty_cache()

    # The default step stage by stage (gme_tpu_torch.tools.profile_stages).
    from gme_tpu_torch.tools import profile_stages

    for fn in (gme_tpu_torch.gme_pipeline_batch, bbme.get_motion_field_jit):
        fn.clear()
    torch.cuda.empty_cache()
    stages = profile_stages.run(720, 1280, BATCH_720P, dev, args.reps * 2,
                                emit=lambda line: print(f"[stages] {line}", flush=True))
    stages.pop("outputs")
    result["stages"] = stages
    profile_stages.clear()
    gme_tpu_torch.gme_pipeline_batch.clear()
    torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    R3 = bbme.threestep_search_radius(CLI_BS, CLI_SW)
    p3, c3 = bbme.volume_inputs(sp_prev, sp_curr, CLI_BS, R3)
    p20, c20 = bbme.volume_inputs(prev[:BS20_BATCH], curr[:BS20_BATCH], 20, BS20_RADIUS)
    D20 = 2 * BS20_RADIUS + 1
    p64, c64 = bbme.volume_inputs(sp_prev, sp_curr, cfg.block_size, 64)
    # Level 1 (the half-size pyramid level) of the default step and of the
    # R64 step, and the 2D-log/diamond searches' volume (D 65).
    lvl1_prev, lvl1_curr = (gme_tpu_torch.get_pyramids(x, cfg.pyramid_levels)[1]
                            for x in (prev, curr))
    p1, c1 = bbme.volume_inputs(lvl1_prev, lvl1_curr, cfg.block_size, cfg.volume_radius)
    p164, c164 = bbme.volume_inputs(lvl1_prev[:BATCH_SEARCH], lvl1_curr[:BATCH_SEARCH],
                                    cfg.block_size, 64)
    p65, c65 = bbme.volume_inputs(sp_prev, sp_curr, CLI_BS, 32)
    shapes = {
        "cost_volume_rowoffset": (p3, c3, CLI_BS, 2 * R3 + 1,
                                  lambda: K.cost_volume_rowoffset(p3, c3, CLI_BS, 2 * R3 + 1, MAE)),
        "cost_volume_rowoffset bs20": (p20, c20, 20, D20,
                                       lambda: K.cost_volume_rowoffset(p20, c20, 20, D20, MAE)),
        "cost_volume_cross": (p64, c64, cfg.block_size, 129,
                              lambda: K.cost_volume_cross(p64, c64, cfg.block_size, 129)),
        "cost_volume_cross ssd": (p64, c64, cfg.block_size, 129,
                                  lambda: K.cost_volume_cross(p64, c64, cfg.block_size, 129,
                                                              ssd=True)),
        "cost_volume_mse_block lvl1": (p1, c1, cfg.block_size, 65,
                                       lambda: K.cost_volume_mse_block(p1, c1, cfg.block_size, 65)),
        "cost_volume_rowoffset D65": (p65, c65, CLI_BS, 65,
                                      lambda: K.cost_volume_rowoffset(p65, c65, CLI_BS, 65, MAE)),
        "cost_volume_cross lvl1": (p164, c164, cfg.block_size, 129,
                                   lambda: K.cost_volume_cross(p164, c164, cfg.block_size, 129)),
        "cost_volume_cross ssd lvl1": (p164, c164, cfg.block_size, 129,
                                       lambda: K.cost_volume_cross(p164, c164, cfg.block_size,
                                                                   129, ssd=True)),
    }
    for kernel, (p, c, bs, D, fn) in shapes.items():
        ms = cuda_ms(torch, fn, 10)
        dev_ms, _ = device_ms(torch, fn, 10)
        us = host_us(torch, fn, 10)
        mhz, max_mhz = clocked(torch, fn)
        args = (p, c, bs, D) + ((MAE,) if kernel.startswith("cost_volume_rowoffset") else ())
        bound_ms, by, binds = bound(K, kernel.split()[0], args)
        rec = {"shape": [list(p.shape), bs, D], "ms": ms, "device_ms": dev_ms, "host_us": us,
               "sm_mhz_under_load": mhz, "sm_mhz_max": max_mhz, "sms": sms, "bound_ms": bound_ms,
               "bound_by": by, "share_of_bound": bound_ms / ms, "device_share": bound_ms / dev_ms}
        if kernel.startswith("cost_volume_rowoffset"):
            rec["terms_per_s"] = p.numel() * D * D / (dev_ms * 1e-3)
        result["kernels"][kernel] = rec
        print(f"[kernel] {kernel} B={p.shape[0]} {tuple(p.shape[1:])} bs={bs} D={D}: {ms:.4f} ms "
              f"(events), device {dev_ms:.4f} ms, host {us:.1f} us a call; bound {bound_ms:.4f} ms by {by} ({binds}), "
              f"{bound_ms / ms:.3f} of it, {bound_ms / dev_ms:.3f} of the device time; SM clock "
              f"under load {mhz:.0f} MHz (max {max_mhz:.0f}), {sms} SMs ({card})", flush=True)
    mix = sass_mix(K)
    result["sass_three_step"] = mix
    print(f"[sass] cost_volume_rowoffset<3, 0> (three-step: bs 9-12, MAE) instructions by opcode: "
          f"{mix if mix is not None else 'not read (no cuobjdump, or no such instantiation)'}",
          flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
