"""The port's four hand-written Hopper kernels: build, binding, wrappers and
their plain PyTorch versions.

Counterpart of `gme_tpu/ops/pallas_kernels.py`.  Each Pallas kernel on the
main path has a CUDA C++ kernel under `gme_tpu_torch/csrc/` (the source
note at the top of each `.cu` file says what bounds it on the H100 and how
its design answers that):

=========================  ==========================  ======================
wrapper                    replaces (pallas_kernels)   source
=========================  ==========================  ======================
cost_volume_small_block    _planes_kernel              cost_volume_small_block.cu
cost_volume_mse_block      _hankel_mse_kernel          cost_volume_mse_block.cu
chase_fixpoint             _chase_kernel               chase_fixpoint.cu
warp_block_field           _warp_kernel                warp_block_field.cu
=========================  ==========================  ======================

Dispatch is by device: a CPU tensor takes the plain version beside the
wrapper; a CUDA tensor launches the kernel or raises.  A failed build, a
missing `nvcc` or a refused launch raises; nothing falls back.  Wrappers
check device, dtype, shape and contiguity, allocate outputs with
`torch.empty`, launch on the current stream and do not synchronise.
`LAUNCHES[name]` counts the kernel's launches (and nothing else), so a run
can show that it went through the kernels.

The sources build at first use with nvcc into one shared library with a
plain C interface (`gme_tpu_torch/_build/`, keyed by a hash of the sources
and flags), loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple, Optional, Tuple

import torch

from gme_tpu_torch.config import MAE, MSE

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_DEFAULT_CUDA_HOME = "/usr/local/cuda"
_SOURCES = (
    "cost_volume_small_block.cu",
    "cost_volume_mse_block.cu",
    "chase_fixpoint.cu",
    "warp_block_field.cu",
    "errors.cu",
)
_HEADERS = ("gme_kernels.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "cost_volume_small_block": 0,
    "cost_volume_mse_block": 0,
    "chase_fixpoint": 0,
    "warp_block_field": 0,
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

class BuildResult(NamedTuple):
    path: str
    log: str  # nvcc's output, including -Xptxas -v; "" when cached
    seconds: float


def find_nvcc() -> str:
    """`nvcc` from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", _DEFAULT_CUDA_HOME), "bin", "nvcc"),
        os.path.join(_DEFAULT_CUDA_HOME, "bin", "nvcc"),
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin and "
        f"{_DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(force: bool = False) -> BuildResult:
    """Compile the kernels into `_build/libgme_kernels_<hash>.so` unless
    that library exists (or `force`).  Raises on any failure."""
    path = os.path.join(_BUILD_DIR, f"libgme_kernels_{_source_key()}.so")
    if os.path.exists(path) and not force:
        return BuildResult(path, "", 0.0)
    nvcc = find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp] + [
        os.path.join(_CSRC_DIR, s) for s in _SOURCES
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return BuildResult(path, log, seconds)


def load_library() -> ctypes.CDLL:
    """Build if needed and bind the launchers; cached per process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build().path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gme_cost_volume_small_block.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gme_cost_volume_mse_block.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.gme_chase_fixpoint.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gme_warp_block_field.argtypes = [p, p, p, i, i, i, i, i, i, p]
        for fn in (lib.gme_cost_volume_small_block, lib.gme_cost_volume_mse_block,
                   lib.gme_chase_fixpoint, lib.gme_warp_block_field):
            fn.restype = ctypes.c_int
        lib.gme_error_string.argtypes = [ctypes.c_int]
        lib.gme_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Wrapper plumbing
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...]):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU inputs (plain version), False for CUDA inputs on one
    device (kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = load_library().gme_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_volume_inputs(prev_crop, curr_pad, bs: int, D: int):
    if not isinstance(prev_crop, torch.Tensor) or prev_crop.dim() != 3:
        raise ValueError("prev_crop: expected a (B, Hc, Wc) tensor")
    B, Hc, Wc = prev_crop.shape
    if Hc % bs or Wc % bs:
        raise ValueError(f"prev_crop: {Hc}x{Wc} is not a whole number of {bs}-blocks")
    _check(prev_crop, "prev_crop", torch.uint8, (B, Hc, Wc))
    _check(curr_pad, "curr_pad", torch.uint8, (B, Hc + D - 1, Wc + D - 1))
    return B, Hc // bs, Wc // bs


# ---------------------------------------------------------------------------
# Cost volumes
# ---------------------------------------------------------------------------

def cost_volume_plain(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, pnorm: int
) -> torch.Tensor:
    """Plain version of both volume kernels: (B, nbh, nbw, D*D) float32,
    entry dr*D + dc = block MAE/MSE of prev against
    curr_pad[dr:dr+Hc, dc:dc+Wc].  One row offset at a time, all column
    offsets of it at once (a (B, Hc, D, Wc) tensor).  Exact in float32:
    every term and block sum is an integer below 2**24."""
    B, Hc, Wc = prev_crop.shape
    nbh, nbw = Hc // bs, Wc // bs
    prev = prev_crop.to(torch.float32)[:, :, None, :]
    curr = curr_pad.to(torch.float32)
    out = torch.empty((B, nbh, nbw, D, D), dtype=torch.float32, device=prev.device)
    for dr in range(D):
        diff = curr[:, dr:dr + Hc, :].unfold(2, Wc, 1) - prev  # (B, Hc, D, Wc)
        per_px = diff.abs_() if pnorm == MAE else diff.mul_(diff)
        sums = per_px.reshape(B, nbh, bs, D, nbw, bs).sum(dim=(2, 5))
        out[:, :, :, dr, :] = sums.permute(0, 1, 3, 2)
    return out.reshape(B, nbh, nbw, D * D)


def cost_volume_small_block(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, pnorm: int
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 MAE/MSE volume for bs < 8, 8 % bs == 0,
    D >= 8 from uint8 (B, Hc, Wc) prev and (B, Hc+D-1, Wc+D-1) curr_pad.

    Replaces pallas_kernels.py:_planes_kernel; bound by its output writes on
    the H100 (see csrc/cost_volume_small_block.cu)."""
    if not (bs < 8 and 8 % bs == 0 and D >= 8):
        raise ValueError(f"cost_volume_small_block takes bs < 8, 8 % bs == 0, D >= 8; got bs={bs}, D={D}")
    if pnorm not in (MAE, MSE):
        raise ValueError(f"unknown pnorm index {pnorm}")
    B, nbh, nbw = _check_volume_inputs(prev_crop, curr_pad, bs, D)
    if _on_cpu(prev_crop, curr_pad):
        return cost_volume_plain(prev_crop, curr_pad, bs, D, pnorm)
    out = torch.empty((B, nbh, nbw, D * D), dtype=torch.float32, device=prev_crop.device)
    if out.numel():
        Hc, Wc = prev_crop.shape[1:]
        _launch("cost_volume_small_block", load_library().gme_cost_volume_small_block,
                prev_crop.device, _ptr(prev_crop), _ptr(curr_pad), _ptr(out),
                B, Hc, Wc, bs, D, pnorm)
    return out


def cost_volume_mse_block(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 MSE volume for 8 <= bs <= 16,
    bs + D - 1 <= 128, D >= 8 (the JAX dispatch's Hankel branch).

    Replaces pallas_kernels.py:_hankel_mse_kernel; bound by integer
    multiply-adds on the H100 (see csrc/cost_volume_mse_block.cu)."""
    if not (8 <= bs <= 16 and D >= 8 and bs + D - 1 <= 128):
        raise ValueError(f"cost_volume_mse_block takes 8 <= bs <= 16, D >= 8, bs + D - 1 <= 128; got bs={bs}, D={D}")
    B, nbh, nbw = _check_volume_inputs(prev_crop, curr_pad, bs, D)
    if _on_cpu(prev_crop, curr_pad):
        return cost_volume_plain(prev_crop, curr_pad, bs, D, MSE)
    out = torch.empty((B, nbh, nbw, D * D), dtype=torch.float32, device=prev_crop.device)
    if out.numel():
        Hc, Wc = prev_crop.shape[1:]
        _launch("cost_volume_mse_block", load_library().gme_cost_volume_mse_block,
                prev_crop.device, _ptr(prev_crop), _ptr(curr_pad), _ptr(out),
                B, Hc, Wc, bs, D)
    return out


# ---------------------------------------------------------------------------
# Chase
# ---------------------------------------------------------------------------

# LDSP candidate offsets (row, col) in the reference's scan order
# (gme_tpu/ops/bbme.py _LDSP; the kernel holds the same table).
LDSP = ((0, 0), (2, 0), (1, 1), (0, 2), (-1, 1), (-2, 0), (-1, -1), (0, -2), (1, -1))


def chase_fixpoint_plain(
    rank_map: torch.Tensor, bounds: torch.Tensor, D: int, R: int, max_iters: int
):
    """Plain version: the JAX package's lockstep loop (bbme.py:1059-1082)
    — every cell steps until no cell moves or after `max_iters` steps."""
    C = rank_map.shape[0]
    dev = rank_map.device
    ldsp = torch.tensor(LDSP, dtype=torch.int32, device=dev)
    lo_r, hi_r, lo_c, hi_c = bounds.unbind(1)
    o = torch.full((C,), R * D + R, dtype=torch.int32, device=dev)
    touched = torch.zeros(C, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        orow, ocol = o // D - R, o % D - R
        touched |= torch.maximum(orow.abs(), ocol.abs()) >= R - 1
        k = rank_map.gather(1, o[:, None].long())[:, 0].long()
        er = torch.minimum(torch.maximum(orow + ldsp[k, 0], lo_r), hi_r)
        ec = torch.minimum(torch.maximum(ocol + ldsp[k, 1], lo_c), hi_c)
        nxt = (er + R) * D + (ec + R)
        moved = bool((nxt != o).any())
        o = nxt
        if not moved:
            break
    return o, touched


def chase_fixpoint(
    rank_map: torch.Tensor, bounds: torch.Tensor, D: int, R: int, max_iters: int
):
    """Chase every cell's diamond walk on the (C, D*D) int8 rank map from
    o0 = R*D + R to its fixpoint, with (C, 4) int32 per-cell clamp bounds
    (lo_r, hi_r, lo_c, hi_c).  Returns (C,) int32 offsets and (C,) bool
    ring-visited flags (max |o| >= R - 1).

    Replaces pallas_kernels.py:_chase_kernel; latency bound on the H100,
    one thread per cell with its own exit (see csrc/chase_fixpoint.cu)."""
    if D != 2 * R + 1:
        raise ValueError(f"D must be 2R+1, got D={D}, R={R}")
    if not isinstance(rank_map, torch.Tensor) or rank_map.dim() != 2:
        raise ValueError("rank_map: expected a (C, D*D) tensor")
    C = rank_map.shape[0]
    _check(rank_map, "rank_map", torch.int8, (C, D * D))
    _check(bounds, "bounds", torch.int32, (C, 4))
    if _on_cpu(rank_map, bounds):
        return chase_fixpoint_plain(rank_map, bounds, D, R, max_iters)
    out_o = torch.empty(C, dtype=torch.int32, device=rank_map.device)
    out_t = torch.empty(C, dtype=torch.bool, device=rank_map.device)
    if C:
        _launch("chase_fixpoint", load_library().gme_chase_fixpoint, rank_map.device,
                _ptr(rank_map), _ptr(bounds), _ptr(out_o), _ptr(out_t),
                C, D, R, max_iters)
    return out_o, out_t


# ---------------------------------------------------------------------------
# Warp
# ---------------------------------------------------------------------------

def warp_block_field_plain(frame: torch.Tensor, d: torch.Tensor, bs: int) -> torch.Tensor:
    """Plain version: per-pixel gather with clipped sources (the JAX
    package's `_warped_covered_gather`, warp.py:40-49), batched."""
    B, H, W = frame.shape
    _, nbh, nbw, _ = d.shape
    dev = frame.device
    d_px = d.repeat_interleave(bs, dim=1).repeat_interleave(bs, dim=2)
    rr = torch.arange(nbh * bs, device=dev)[:, None]
    cc = torch.arange(nbw * bs, device=dev)[None, :]
    gr = (rr - d_px[..., 1]).clamp(0, H - 1).long()
    gc = (cc - d_px[..., 0]).clamp(0, W - 1).long()
    b = torch.arange(B, device=dev)[:, None, None]
    return frame[b, gr, gc]


def warp_block_field(frame: torch.Tensor, d: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, nbh*bs, nbw*bs) uint8 warp of (B, H, W) uint8 frames by the
    (B, nbh, nbw, 2) int32 block field (channel 0 column shift, channel 1
    row shift), sources clipped into the frame; the caller masks
    out-of-frame sources.

    Replaces pallas_kernels.py:_warp_kernel; bound by bytes on the H100,
    one thread per output pixel (see csrc/warp_block_field.cu)."""
    if not isinstance(frame, torch.Tensor) or frame.dim() != 3:
        raise ValueError("frame: expected a (B, H, W) tensor")
    if not isinstance(d, torch.Tensor) or d.dim() != 4:
        raise ValueError("d: expected a (B, nbh, nbw, 2) tensor")
    B, H, W = frame.shape
    nbh, nbw = d.shape[1], d.shape[2]
    if nbh * bs > H or nbw * bs > W or bs < 1:
        raise ValueError(f"field {nbh}x{nbw} of {bs}-blocks exceeds the {H}x{W} frame")
    _check(frame, "frame", torch.uint8, (B, H, W))
    _check(d, "d", torch.int32, (B, nbh, nbw, 2))
    if _on_cpu(frame, d):
        return warp_block_field_plain(frame, d, bs)
    out = torch.empty((B, nbh * bs, nbw * bs), dtype=torch.uint8, device=frame.device)
    if out.numel():
        _launch("warp_block_field", load_library().gme_warp_block_field, frame.device,
                _ptr(frame), _ptr(d), _ptr(out), B, H, W, nbh, nbw, bs)
    return out
