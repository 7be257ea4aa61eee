"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from process start): imports, the CUDA
context of every card the cell uses, the clips written as y4m into a
directory of this run's own under TMPDIR, and one `process_video` over one
batch of the first clip, which loads the kernel library (built by nvcc
into `gme_tpu_torch/_build/` inside the checkout on its first run there)
and captures the step's CUDA graph at the cell's batch shape.

The window: a closed loop with one caller, `process_video` over one whole
clip after another, the clips in turn, each into an output directory of
its own, until the first clip that ends `--seconds` after the window
opened.  With images, as each call returns, the pairs whose PNGs the
check reads are drawn from the seed and the call's index, and the call's
other PNGs are deleted, so that a run's disk use does not grow with the
writer's speed; that pause is left out of the window.  Where one of the
cell's end-to-end metrics comes from the device's trace
(`kernel_ms_per_pair`), `torch.profiler` records the cards' own activity
(CUDA only) over the whole window, started once set-up has been timed and
read after the window has closed.  With `--trace 1`
the first clip to start past half the window is profiled (`torch.profiler`,
CPU and CUDA), and the per-layer metrics are read instead of the
end-to-end ones.

After the window: the peak device memory is read, the program's graphs are
freed, and every clip of the window is held to the plain reference
(`check.py`).  The numbers compared go to standard error, each beside its
limit, and into the result line under `checks`, its last key.

Exit codes: 0 with a result line (`correct` true or false); 2 without a
card, or with fewer than the cell asks for; 3 where the profiler recorded
no device activity; 4 where a module of JAX or of the JAX package was
loaded.  No result line is printed with any of them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import check, clips, nojax, spec, trace  # noqa: E402
from benchmark.window import Window  # noqa: E402

PROFILE_TRIES = 3
CLIP_RANGE = "benchmark.clip"
IMAGE_STREAMS = ("frames", "compensated", "curr_prev_diff", "curr_comp_diff",
                 "model_motion_field")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_limits() -> str:
    """The cards' names and power limits, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError):
        return "not read"


def write_clips(cell: spec.Cell, seed: int, workdir: str):
    """(frames of each clip, y4m paths, bytes written)."""
    t, (H, W) = cell.traffic, (cell.config["frame"]["height"], cell.config["frame"]["width"])
    drawn = clips.draw_clips(seed, t["speeds"])
    frames, paths, nbytes = [], [], 0
    for c, d in enumerate(drawn):
        f = clips.synthetic_pan(t["frames"], H, W, d["step"], d["texture_seed"])
        path = os.path.join(workdir, f"pan{c}.y4m")
        nbytes += clips.write_y4m(path, f)
        frames.append(f)
        paths.append(path)
    return frames, paths, nbytes, drawn


def image_sample(seed: int, k: int, n_pairs: int, fd: int, count: int):
    """Pair indices of call `k` whose PNGs are kept and checked: `count`
    drawn from the seed and the call's index."""
    if not count:
        return []
    rng = np.random.default_rng([seed, 1, k])
    return sorted(int(p) + fd for p in rng.choice(n_pairs, size=min(count, n_pairs),
                                                  replace=False))


def prune_images(out_dir: str, keep, fd: int) -> int:
    """Delete every PNG of a call but those of the pairs in `keep`, named
    as the driver names them (frames and compensated by idx - 5); returns
    the bytes deleted."""
    names = {s: {f"{i - 5 if s in ('frames', 'compensated') else i}.png" for i in keep}
             for s in IMAGE_STREAMS}
    deleted = 0
    for stream, kept in names.items():
        d = os.path.join(out_dir, stream)
        if os.path.isdir(d):
            for entry in os.scandir(d):
                if entry.name not in kept:
                    deleted += entry.stat().st_size
                    os.unlink(entry.path)
    return deleted


def du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device=None,
             t0: float = None):
    """Run `cell` once; returns (exit code, result dict or None, lines for
    standard error).  `device` None means the cards (the look for them is
    the caller's); "cpu" runs the program on the CPU, which only the
    harness's tests do."""
    import torch

    from gme_tpu_torch.config import PipelineConfig
    from gme_tpu_torch.models.gme import gme_pipeline_batch
    from gme_tpu_torch.pipeline.results import process_video

    t0 = T0 if t0 is None else t0
    on_cuda = device is None
    cfg = PipelineConfig.from_dict(spec.pipeline_settings(cell.config, cell.traffic))
    fd, bsz = cfg.frame_distance, cfg.batch_size
    dev = "cuda" if on_cuda else device
    devices = None if on_cuda else [torch.device(device)] * (cfg.mesh.data * cfg.mesh.space)
    cards = list(range(cell.chips)) if on_cuda else []
    notes = []
    workdir = tempfile.mkdtemp(prefix="gme-bench-")
    try:
        for c in cards:
            torch.cuda.init()
            torch.empty(1, device=f"cuda:{c}")
        frames, paths, clip_bytes, drawn = write_clips(cell, seed, workdir)
        notes.append(f"clips {[d['step'] for d in drawn]} ({clip_bytes} bytes of y4m)")

        def call(c: int, out_root: str, max_pairs=None):
            return process_video(paths[c], out_root=out_root, cfg=cfg, max_pairs=max_pairs,
                                 device=dev, devices=devices)

        call(0, os.path.join(workdir, "warm"), max_pairs=bsz)
        for c in cards:
            torch.cuda.synchronize(c)
        setup_s = time.perf_counter() - t0
        window_prof = None
        if on_cuda and not traced and any(m.source == "device_trace" for m in cell.end_to_end):
            t_prof = time.perf_counter()
            window_prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            window_prof.start()
            notes.append(f"profiler started in {time.perf_counter() - t_prof!r} s")

        n_pairs = cell.traffic["frames"] - fd
        per_call = cell.traffic["image_pairs_per_call"] if cfg.write_images else 0
        win = Window(time.perf_counter(), seconds)
        calls, sample, profiled, tries, pruned = [], [], None, 0, 0
        while not win.closed:
            k = len(calls)
            out_root = os.path.join(workdir, "out", str(k))
            profile = (traced and profiled is None and tries < PROFILE_TRIES
                       and time.perf_counter() - win.opened >= seconds / 2)
            start = time.perf_counter()
            if profile:
                tries += 1
                acts = [torch.profiler.ProfilerActivity.CPU]
                if on_cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=acts) as prof:
                    with torch.profiler.record_function(CLIP_RANGE):
                        summary = call(k % len(paths), out_root)
                events, ranges = trace.read_profile(
                    prof, trace.HOST_RANGES + (CLIP_RANGE,))
                if events:
                    profiled = (k, events, ranges)
                else:
                    notes.append(f"[profiler] clip {k}: no device activity recorded")
            else:
                summary = call(k % len(paths), out_root)
            end = time.perf_counter()
            win.add(start, end, summary["pairs_processed"])
            calls.append(check.Call(k % len(paths),
                                    os.path.join(out_root, summary["video"]), summary))
            if per_call:
                picks = image_sample(seed, k, n_pairs, fd, per_call)
                pruned += prune_images(calls[-1].out_dir, picks, fd)
                sample += [(k, i) for i in picks]
                win.pause(time.perf_counter() - end)

        kernel_ms = None
        if window_prof is not None:
            for c in cards:
                torch.cuda.synchronize(c)
            t_read = time.perf_counter()
            window_prof.stop()
            spans = trace.read_device_spans(window_prof)
            del window_prof
            kernel_ms = trace.device_ms_per_pair(spans, cards, win.pairs, ("kernel",))
            notes.append(f"kernels {kernel_ms!r} ms a pair over the window, every activity "
                         f"{trace.device_ms_per_pair(spans, cards, win.pairs)!r}, copies "
                         f"{trace.device_ms_per_pair(spans, cards, win.pairs, ('copy',))!r}; "
                         f"{sum(map(len, spans.values()))} device spans stopped and read in "
                         f"{time.perf_counter() - t_read!r} s")
            del spans
        peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)
        out_bytes = du(os.path.join(workdir, "out"))
        notes.append(f"window {win.length!r} s, {len(calls)} clips, {win.pairs} pairs; "
                     f"outputs {out_bytes + pruned} bytes written, {pruned} of them deleted "
                     f"as their calls returned; y4m {clip_bytes} bytes")
        if traced and profiled is None:
            return 3, None, notes + ["the profiler recorded no device activity"]

        if on_cuda:
            gme_pipeline_batch.clear()
            torch.cuda.empty_cache()
        keep = {}
        for k, idx in sample:
            keep.setdefault(calls[k].clip, set()).add(idx)
        ref_device = "cuda:0" if on_cuda else device
        t_ref = time.perf_counter()
        refs = check.reference_clips(frames, cell.config["gme"], fd, bsz, ref_device, keep)
        verdict = check.judge(calls, frames, refs, fd, cell.config["gme"]["block_size"], sample)
        notes.append(f"reference {time.perf_counter() - t_ref!r} s")

        if traced:
            metrics = per_layer(cell, calls, profiled, win, cards)
        else:
            metrics = {"setup_s": setup_s, "pairs_per_s": win.pairs_per_s(),
                       "kernel_ms_per_pair": kernel_ms}
        units = {m.name: m.unit for m in (cell.per_layer if traced else cell.end_to_end)}
        result = {
            "correct": verdict.correct,
            "attempted": verdict.attempted,
            "failed": verdict.failed,
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                        if k in units and v is not None},
            "device": device_block(torch, on_cuda, cards, peak),
        }
        if traced:
            k, events, ranges = profiled
            span = next(r for r in ranges if r.name == CLIP_RANGE)
            result["device"]["busy_s"] = (
                sum(trace.busy_intervals(events, c)[0] for c in cards or [0])
                / max(len(cards), 1) / 1e6)
            result["device"]["window_s"] = (span.end_us - span.start_us) / 1e6
            result["breakdown"] = trace.breakdown(events, ranges, cards or [0],
                                                  (span.start_us, span.end_us))
        result["checks"] = verdict.as_json()
        return 0, result, notes + verdict.lines()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def device_block(torch, on_cuda: bool, cards, peak: int) -> dict:
    if not on_cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(cards),
            "memory_peak_bytes": int(peak)}


def per_layer(cell: spec.Cell, calls, profiled, win: Window, cards) -> dict:
    """Each per-layer metric of the cell, from its reader: the window's
    clips (the profiled clip left out), their StageTimer totals, and the
    profiled clip's device events."""
    k, events, ranges = profiled
    span = next(r for r in ranges if r.name == CLIP_RANGE)
    ctx = {
        "config": cell.config,
        "clip_walls": [c.seconds for i, c in enumerate(win.clips) if i != k],
        "window": {"pairs": win.pairs - win.clips[k].pairs,
                   "seconds": win.length - win.clips[k].seconds},
        "summaries": [c.summary for i, c in enumerate(calls) if i != k],
        "traced": {
            "events": events,
            "ranges": ranges,
            "span_us": (span.start_us, span.end_us),
            "pairs": calls[k].summary["pairs_processed"],
            "cards": cards or [0],
        },
    }
    return {m.name: m.read(ctx) for m in cell.per_layer}


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except KeyError:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {n} visible", file=sys.stderr)
        return 2
    print(f"cards: {card_limits()}", file=sys.stderr)
    rc, result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = nojax.loaded()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    if result is None:
        return rc
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
