"""Command-line entry points of the port, with the JAX package's flags and
defaults (`gme_tpu/cli.py`):

- `python -m gme_tpu_torch.cli results -v <video> [-f <frame_distance>]`
  (reference results.py:114-138)
- `python -m gme_tpu_torch.cli bbme -p <video> -fi <idx> [-pn 0] [-bs 12]
  [-sw 8] [-sp 1]` (reference bbme.py:653-714)
- `python -m gme_tpu_torch.cli direct -v <video> -fi <idx> [-f 1]
  [--model perspective|affine]` (direct gradient-descent GME of one pair)
- `python -m gme_tpu_torch.cli stats [results_dir]`
  (reference utils.some_data __main__ walker, utils.py:169-188)

`--platform` is `gpu` (the default: CUDA, raising without it) or `cpu`;
nothing falls back from one to the other.  `results --mesh data=D,space=S`
runs over D*S slots: the visible cards on the card, the CPU in every slot
on the CPU.  `--num-processes N --process-id K --coordinator host:port`
runs process K's GOP shard and joins a gloo process group for the final
barrier; rank 0 merges the records.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

_PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def _parse_mesh(spec: str):
    """Parse "data=2,space=4" into a MeshConfig."""
    from gme_tpu_torch.config import MeshConfig

    kw = {}
    for part in spec.split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        if key not in ("data", "space"):
            raise SystemExit(f"unknown mesh axis {key!r} (use data=,space=)")
        kw[key] = int(val)
    return MeshConfig(**kw)


def _cmd_results(args) -> None:
    from gme_tpu_torch.config import GMEConfig, PipelineConfig
    from gme_tpu_torch.pipeline.results import process_video

    gme = GMEConfig(
        block_size=args.block_size,
        pyramid_levels=args.levels,
        outlier_fraction=args.outlier_fraction,
        coord_stride=args.coord_stride,
        searching_procedure=args.searching_procedure,
        pnorm_distance=args.pnorm,
        search_impl=args.search_impl,
        volume_radius=args.volume_radius,
    )
    cfg = PipelineConfig(
        frame_distance=int(args.fd) if args.fd else 1,
        gme=gme,
        mesh=_parse_mesh(args.mesh),
        batch_size=args.batch_size,
        resume=args.resume,
        write_images=not args.no_images,
        adaptive=args.adaptive,
    )
    if args.num_processes > 1:
        from gme_tpu_torch.parallel.multihost import process_video_multihost

        summary = process_video_multihost(
            args.path, out_root=args.out, cfg=cfg,
            num_processes=args.num_processes, process_id=args.process_id,
            coordinator_address=args.coordinator, gop_size=args.gop_size,
            max_pairs=args.max_pairs, device=_PLATFORMS[args.platform],
        )
    else:
        summary = process_video(
            args.path, out_root=args.out, cfg=cfg, profile_dir=args.profile_dir,
            max_pairs=args.max_pairs, device=_PLATFORMS[args.platform],
        )
    print(json.dumps(summary, indent=2))


def _cmd_bbme(args) -> None:
    import torch

    from gme_tpu_torch.io.draw import draw_motion_field
    from gme_tpu_torch.io.video import get_video_frames
    from gme_tpu_torch.io.writers import write_png
    from gme_tpu_torch.models.hierarchical_bbme import hierarchical_wrapper
    from gme_tpu_torch.ops.bbme import get_motion_field
    from gme_tpu_torch.pipeline.results import resolve_device

    dev = resolve_device(_PLATFORMS[args.platform])
    frames = get_video_frames(args.path)
    previous = frames[args.fi - 3]  # reference's hard-coded distance 3 (bbme.py:620)
    current = frames[args.fi]
    prev_t = torch.from_numpy(np.ascontiguousarray(previous))[None].to(dev)
    curr_t = torch.from_numpy(np.ascontiguousarray(current))[None].to(dev)

    motion_field = get_motion_field(
        prev_t, curr_t,
        block_size=args.block_size,
        search_window=args.search_window,
        searching_procedure=args.searching_procedure,
        pnorm_distance=args.pnorm,
    )[0].cpu().numpy()
    hier = hierarchical_wrapper(
        prev_t, curr_t,
        block_size=args.block_size,
        search_window=args.search_window,
        searching_procedure=args.searching_procedure,
    )[0].cpu().numpy()
    out_dir = os.path.join(args.out, "images")
    os.makedirs(out_dir, exist_ok=True)
    write_png(
        os.path.join(out_dir, f"{args.searching_procedure}-res.png"),
        draw_motion_field(current, motion_field),
    )
    write_png(
        os.path.join(out_dir, f"{args.searching_procedure}h-res.png"),
        draw_motion_field(previous, hier),
    )
    print(f"wrote needle diagrams to {out_dir}")


def _cmd_direct(args) -> None:
    """Direct (gradient-descent) GME between two frames; prints the model,
    its parameters and the PSNR before and after compensation, and with -o
    writes the compensated frame as direct_<fi>.png."""
    import torch

    from gme_tpu_torch.io.video import get_video_frames
    from gme_tpu_torch.models.direct import direct_motion_compensation
    from gme_tpu_torch.ops.metrics import psnr
    from gme_tpu_torch.pipeline.results import resolve_device

    dev = resolve_device(_PLATFORMS[args.platform])
    frames = get_video_frames(args.path)
    previous = torch.from_numpy(np.ascontiguousarray(frames[args.fi - args.fd])).to(dev)
    current = torch.from_numpy(np.ascontiguousarray(frames[args.fi])).to(dev)
    params, comp = direct_motion_compensation(
        previous, current, model=args.model, levels=args.levels,
        iterations=args.iterations, learning_rate=args.lr,
    )
    out = {
        "model": args.model,
        "parameters": [float(p) for p in params.cpu()],
        "psnr_before": float(psnr(current[None], previous[None])[0]),
        "psnr_after": float(psnr(current[None], comp[None])[0]),
    }
    if args.out:
        from gme_tpu_torch.io.writers import write_png

        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, f"direct_{args.fi}.png"), comp.cpu().numpy())
    print(json.dumps(out, indent=2))


def _cmd_stats(args) -> None:
    from gme_tpu_torch.pipeline.results import summarize_results

    for row in summarize_results(args.results):
        print(f"video {row['video']}")
        for k in ("avg", "var", "std", "max", "min"):
            if k in row:
                print(f"  {k}: {row[k]:.3f}")
        print("=" * 22)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="gme_tpu_torch",
        description="global motion estimation on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("results", help="run the full GME pipeline over a video")
    p.add_argument("-v", "--video-path", dest="path", required=True)
    p.add_argument("-f", "--frame-distance", dest="fd", default=None)
    p.add_argument("-o", "--out", default="results")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-images", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    # GME model knobs (defaults = reference constants, motion.py:9-10 etc.)
    p.add_argument("--block-size", type=int, default=16,
                   help="GME block size (reference BBME_BLOCK_SIZE=16)")
    p.add_argument("--levels", type=int, default=3,
                   help="pyramid levels (reference utils.py:34)")
    p.add_argument("--outlier-fraction", type=float, default=0.3,
                   help="robust-fit outlier fraction (reference motion.py:10)")
    p.add_argument("--coord-stride", type=int, default=4,
                   help="normal-equation cell stride (reference quirk: 4)")
    p.add_argument("-sp", "--searching-procedure", type=int, default=3,
                   help="0=exhaustive 1=three-step 2=2D-log 3=diamond")
    p.add_argument("-pn", "--p-norm", dest="pnorm", type=int, default=1,
                   help="0=MAE 1=MSE")
    p.add_argument("--search-impl", choices=("auto", "gather", "volume"),
                   default="auto")
    p.add_argument("--volume-radius", type=int, default=32)
    p.add_argument("--adaptive", action="store_true",
                   help="escape-guarded adaptive volume radius: try tight "
                        "radii first, recompute escaped pairs at full "
                        "radius (equal results; wins when motion stays small)")
    p.add_argument("--mesh", default="data=1,space=1",
                   help='device mesh, e.g. "data=2,space=4": pairs shard '
                        'over data, frame rows over space (halo exchange)')
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--platform", choices=tuple(_PLATFORMS), default="gpu",
                   help="gpu (CUDA, the default) or cpu")
    # multi-process: GOPs shard across processes (gme_tpu_torch.parallel.multihost)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="host:port of the gloo process group (rank 0 serves it)")
    p.add_argument("--gop-size", type=int, default=16)
    p.set_defaults(func=_cmd_results)

    p = sub.add_parser("bbme", help="motion field between two frames")
    p.add_argument("-p", "--video-path", dest="path", required=True)
    p.add_argument("-fi", "--frame-index", dest="fi", type=int, required=True)
    p.add_argument("-pn", "--p-norm", dest="pnorm", type=int, default=0)
    p.add_argument("-bs", "--block-size", dest="block_size", type=int, default=12)
    p.add_argument("-sw", "--search-window", dest="search_window", type=int, default=8)
    p.add_argument(
        "-sp", "--searching-procedure", dest="searching_procedure", type=int, default=1
    )
    p.add_argument("-o", "--out", default="resources")
    p.add_argument("--platform", choices=tuple(_PLATFORMS), default="gpu",
                   help="gpu (CUDA, the default) or cpu")
    p.set_defaults(func=_cmd_bbme)

    p = sub.add_parser("direct", help="direct (gradient-descent) GME on one pair")
    p.add_argument("-v", "--video-path", dest="path", required=True)
    p.add_argument("-fi", "--frame-index", dest="fi", type=int, required=True)
    p.add_argument("-f", "--frame-distance", dest="fd", type=int, default=1)
    p.add_argument("--model", choices=("affine", "perspective"),
                   default="perspective")
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("-o", "--out", default=None,
                   help="write the compensated frame PNG here")
    p.add_argument("--platform", choices=tuple(_PLATFORMS), default="gpu",
                   help="gpu (CUDA, the default) or cpu")
    p.set_defaults(func=_cmd_direct)

    p = sub.add_parser("stats", help="aggregate PSNR stats over results")
    p.add_argument("results", nargs="?", default="results")
    p.set_defaults(func=_cmd_stats)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
