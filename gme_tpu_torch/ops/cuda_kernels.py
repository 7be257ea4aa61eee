"""The port's hand-written Hopper kernels: build, binding, wrappers and
their plain PyTorch versions.

Counterpart of `gme_tpu/ops/pallas_kernels.py`.  Each Pallas kernel has a
CUDA C++ kernel under `gme_tpu_torch/csrc/` (the source note at the top of
each `.cu` file says what bounds it on the H100 and how its design answers
that); the chase has two, one on the rank map as the Pallas kernel takes
it and one that reads the cost volume itself (the one the searches run):

=========================  ==========================  ======================
wrapper                    replaces (pallas_kernels)   source
=========================  ==========================  ======================
cost_volume_small_block    _planes_kernel              cost_volume_small_block.cu
cost_volume_mse_block      _hankel_mse_kernel          cost_volume_mse_block.cu
cost_volume_rowoffset      _cost_volume_kernel         cost_volume_rowoffset.cu
cost_volume_cross          _cross_volume_kernel        cost_volume_cross.cu
chase_fixpoint             _chase_kernel               chase_fixpoint.cu
chase_volume               _chase_kernel + rank map    chase_volume.cu
warp_block_field           _warp_kernel                warp_block_field.cu
=========================  ==========================  ======================

Dispatch is by device: a CPU tensor takes the plain version beside the
wrapper; a CUDA tensor launches the kernel or raises.  A failed build, a
missing `nvcc` or a refused launch raises; nothing falls back.  Wrappers
check device, dtype, shape and contiguity, allocate outputs with
`torch.empty`, launch on the current stream and do not synchronise.
`LAUNCHES[name]` counts the kernel's launches (and nothing else), so a run
can show that it went through the kernels.

The sources build at first use with nvcc, one compiler process per source,
all started together, linked into one shared library with a plain C
interface (`gme_tpu_torch/_build/`, keyed by a hash of the sources and
flags) and loaded with ctypes.  The library also holds the graph control
of `utils.compiled.while_loop` (`graph_conditional.cu`: a WHILE node and
the one-thread kernel that sets its condition) and the peer copies of a
split entry's collective steps (`peer_copy.cu`), which port no kernel.
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
    "cost_volume_rowoffset.cu",
    "cost_volume_cross.cu",
    "chase_fixpoint.cu",
    "chase_volume.cu",
    "warp_block_field.cu",
    "graph_conditional.cu",
    "peer_copy.cu",
    "errors.cu",
)
_HEADERS = ("gme_kernels.cuh", "cost_volume_small_block.cuh", "cost_volume_tiles.cuh",
            "cost_volume_mma.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "cost_volume_small_block": 0,
    "cost_volume_mse_block": 0,
    "cost_volume_rowoffset": 0,
    "cost_volume_cross": 0,
    "chase_fixpoint": 0,
    "chase_volume": 0,
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


def _run_all(cmds):
    """Run the commands side by side; (returncode, output) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build(force: bool = False) -> BuildResult:
    """Compile the kernels into `_build/libgme_kernels_<hash>.so` unless
    that library exists (or `force`): one nvcc per source, all at once,
    then one link.  Raises on any failure."""
    key = _source_key()
    path = os.path.join(_BUILD_DIR, f"libgme_kernels_{key}.so")
    if os.path.exists(path) and not force:
        return BuildResult(path, "", 0.0)
    nvcc = find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [os.path.join(_BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o") for s in _SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC_DIR, s), "-o", o]
                for s, o in zip(_SOURCES, objs)]
    tmp = f"{path}.{os.getpid()}.tmp"
    link = [nvcc, *_ARCH, "-shared", "-o", tmp, *objs]
    t0 = time.perf_counter()
    log = ""
    try:
        for cmds in (compiles, [link]):  # the link starts once every object is built
            for cmd, (rc, out) in zip(cmds, _run_all(cmds)):
                log += out
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)
    return BuildResult(path, log, time.perf_counter() - t0)


def load_library() -> ctypes.CDLL:
    """Build if needed and bind the launchers; cached per process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build().path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gme_cost_volume_small_block.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gme_cost_volume_mse_block.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.gme_cost_volume_rowoffset.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gme_cost_volume_cross.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gme_chase_fixpoint.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gme_chase_volume.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.gme_warp_block_field.argtypes = [p, p, p, i, i, i, i, i, i, p]
        for fn in (lib.gme_cost_volume_small_block, lib.gme_cost_volume_mse_block,
                   lib.gme_cost_volume_rowoffset, lib.gme_cost_volume_cross,
                   lib.gme_chase_fixpoint, lib.gme_chase_volume, lib.gme_warp_block_field):
            fn.restype = ctypes.c_int
        # Graph control for `utils.compiled.while_loop` (no TPU kernel).
        u64 = ctypes.c_ulonglong
        lib.gme_while_handle.argtypes = [p, ctypes.POINTER(u64)]
        lib.gme_while_set.argtypes = [u64, p, p]
        lib.gme_while_begin.argtypes = [p, p, u64]
        lib.gme_while_end.argtypes = [p]
        # Peer copies for `utils.compiled`'s collective steps (no TPU kernel).
        pp, pi = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.gme_enable_peer.argtypes = [i, i]
        lib.gme_run_step.argtypes = [i, pi, pi, pi, pp, pp, pp, pp,
                                     ctypes.POINTER(ctypes.c_size_t), pp]
        for fn in (lib.gme_while_handle, lib.gme_while_set, lib.gme_while_begin,
                   lib.gme_while_end, lib.gme_enable_peer, lib.gme_run_step):
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

# Largest block edge whose sums stay below 2**31 in the volume kernels'
# int32 accumulators: MAE 255 * bs**2, MSE and cross 255**2 * bs**2.
MAX_BS = {MAE: 2901, MSE: 181}


def _volume_plain(prev_crop, curr_pad, bs: int, D: int, term) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 block sums of term(curr, prev) in int32,
    rounded to float32 once.  One row offset at a time, all column offsets of
    it at once (a (B, Hc, D, Wc) tensor)."""
    B, Hc, Wc = prev_crop.shape
    nbh, nbw = Hc // bs, Wc // bs
    prev = prev_crop.to(torch.int32)[:, :, None, :]
    curr = curr_pad.to(torch.int32)
    out = torch.empty((B, nbh, nbw, D, D), dtype=torch.float32, device=prev.device)
    for dr in range(D):
        per_px = term(curr[:, dr:dr + Hc, :].unfold(2, Wc, 1), prev)  # (B, Hc, D, Wc)
        sums = per_px.reshape(B, nbh, bs, D, nbw, bs).sum(dim=(2, 5), dtype=torch.int32)
        out[:, :, :, dr, :] = sums.permute(0, 1, 3, 2)
    return out.reshape(B, nbh, nbw, D * D)


def _abs_diff(a, b):
    return (a - b).abs_()


def _sq_diff(a, b):
    d = a - b
    return d.mul_(d)


def cost_volume_plain(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, pnorm: int
) -> torch.Tensor:
    """Plain version of the MAE/MSE volume kernels: (B, nbh, nbw, D*D)
    float32, entry dr*D + dc = block MAE/MSE of prev against
    curr_pad[dr:dr+Hc, dc:dc+Wc].  Exact integer sums rounded to float32
    once: exact wherever the sum is below 2**24 (MAE to bs 256, MSE to
    bs 16), the correctly rounded sum above."""
    return _volume_plain(prev_crop, curr_pad, bs, D, _abs_diff if pnorm == MAE else _sq_diff)


def cost_volume_cross_plain(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, ssd: bool = False
) -> torch.Tensor:
    """Plain version of the cross kernel: entry dr*D + dc = block sum of
    prev * curr_pad[dr:dr+Hc, dc:dc+Wc], the same layout and rounding.

    With `ssd`, the MSE volume as the JAX package decomposes it
    (pallas_kernels.py:511): sum a^2 - 2 sum ab + sum b^2, the cross term
    as without `ssd`, sum b^2 by block pooling and sum a^2 by a sliding box
    sum of curr^2 read at (t*bs + dr, j*bs + dc).  Combined in int32 and
    rounded to float32 once; |sum a^2 - 2 sum ab| < 2**24 because it equals
    the SSD minus sum b^2, so at bs <= 16 it is bit-equal to the direct MSE
    volume."""
    if not ssd:
        return _volume_plain(prev_crop, curr_pad, bs, D, torch.mul)
    B, Hc, Wc = prev_crop.shape
    nbh, nbw = Hc // bs, Wc // bs
    dev = prev_crop.device
    i32 = torch.int32
    p = prev_crop.to(i32)
    sb = (p * p).reshape(B, nbh, bs, nbw, bs).sum(dim=(2, 4), dtype=i32)
    c = curr_pad.to(i32)
    c2 = c * c
    sa_full = c2.unfold(1, bs, 1).sum(-1, dtype=i32).unfold(2, bs, 1).sum(-1, dtype=i32)
    offs = torch.arange(D, device=dev)
    rows = (torch.arange(nbh, device=dev) * bs)[:, None] + offs  # (nbh, D)
    cols = (torch.arange(nbw, device=dev) * bs)[:, None] + offs  # (nbw, D)
    sa = sa_full[:, rows][:, :, :, cols]  # (B, nbh, D_dr, nbw, D_dc)
    vol = sa.permute(0, 1, 3, 2, 4).reshape(B, nbh, nbw, D * D)
    del sa
    cross = _volume_plain(prev_crop, curr_pad, bs, D, torch.mul)
    vol.sub_(cross.to(i32).mul_(2)).add_(sb[..., None])
    return vol.to(torch.float32)


def cost_volume_small_block(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, pnorm: int
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 MAE/MSE volume for bs < 8, 8 % bs == 0,
    D >= 8 from uint8 (B, Hc, Wc) prev and (B, Hc+D-1, Wc+D-1) curr_pad.

    Replaces pallas_kernels.py:_planes_kernel; bound by its output writes on
    the H100, four outputs a thread in one 16-byte store (see
    csrc/cost_volume_small_block.cu)."""
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

    Replaces pallas_kernels.py:_hankel_mse_kernel; bound by its output
    writes on the H100, the cross term on the u8 tensor cores (see
    csrc/cost_volume_mse_block.cu)."""
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


def _check_block_sum(bs: int, pnorm: int, D: int) -> None:
    if bs < 1 or D < 1:
        raise ValueError(f"block size and offsets must be positive; got bs={bs}, D={D}")
    if bs > MAX_BS[pnorm]:
        raise ValueError(
            f"bs={bs} > {MAX_BS[pnorm]}: the {'MAE' if pnorm == MAE else 'MSE'} block "
            "sums could overflow the kernel's int32 accumulators")


def cost_volume_rowoffset(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, pnorm: int
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 MAE/MSE volume for any bs and any D
    (MAE to bs 2901, MSE to bs 181) from uint8 (B, Hc, Wc) prev and
    (B, Hc+D-1, Wc+D-1) curr_pad.

    Replaces pallas_kernels.py:_cost_volume_kernel; integer-op bound at large
    bs and output bound at small bs on the H100: pixels packed four to a
    word (`__vabsdiffu4` + `__dp4a`), 4 x 4 register tiles of offsets at
    bs 3 and 5..32, the small-block body at bs 1, 2, 4 (see
    csrc/cost_volume_rowoffset.cu)."""
    if pnorm not in (MAE, MSE):
        raise ValueError(f"unknown pnorm index {pnorm}")
    _check_block_sum(bs, pnorm, D)
    B, nbh, nbw = _check_volume_inputs(prev_crop, curr_pad, bs, D)
    if _on_cpu(prev_crop, curr_pad):
        return cost_volume_plain(prev_crop, curr_pad, bs, D, pnorm)
    out = torch.empty((B, nbh, nbw, D * D), dtype=torch.float32, device=prev_crop.device)
    if out.numel():
        Hc, Wc = prev_crop.shape[1:]
        _launch("cost_volume_rowoffset", load_library().gme_cost_volume_rowoffset,
                prev_crop.device, _ptr(prev_crop), _ptr(curr_pad), _ptr(out),
                B, Hc, Wc, bs, D, pnorm)
    return out


def cost_volume_cross(
    prev_crop: torch.Tensor, curr_pad: torch.Tensor, bs: int, D: int, ssd: bool = False
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 block cross-correlation: entry dr*D + dc is
    the block sum of prev * curr_pad[dr:dr+Hc, dc:dc+Wc], for any D and
    bs <= 181; exact to bs 16.  With `ssd` (bs <= 16), the MSE volume
    sum a^2 - 2 sum ab + sum b^2, formed in the kernel's epilogue.

    Replaces pallas_kernels.py:_cross_volume_kernel; bound by its output
    writes on the H100, the cross term on the u8 tensor cores in bands of
    offset rows at 8 <= bs <= 16, the packed-word routes of
    `cost_volume_rowoffset` at other block sizes (see
    csrc/cost_volume_cross.cu)."""
    _check_block_sum(bs, MSE, D)
    if ssd and bs > 16:
        raise ValueError(f"cost_volume_cross takes ssd only to bs 16, where it is exact; got bs={bs}")
    B, nbh, nbw = _check_volume_inputs(prev_crop, curr_pad, bs, D)
    if _on_cpu(prev_crop, curr_pad):
        return cost_volume_cross_plain(prev_crop, curr_pad, bs, D, ssd)
    out = torch.empty((B, nbh, nbw, D * D), dtype=torch.float32, device=prev_crop.device)
    if out.numel():
        Hc, Wc = prev_crop.shape[1:]
        _launch("cost_volume_cross", load_library().gme_cost_volume_cross,
                prev_crop.device, _ptr(prev_crop), _ptr(curr_pad), _ptr(out),
                B, Hc, Wc, bs, D, int(bool(ssd)))
    return out


# ---------------------------------------------------------------------------
# Chase
# ---------------------------------------------------------------------------

# LDSP candidate offsets (row, col) in the reference's scan order
# (gme_tpu/ops/bbme.py _LDSP; the kernel holds the same table).
LDSP = ((0, 0), (2, 0), (1, 1), (0, 2), (-1, 1), (-2, 0), (-1, -1), (0, -2), (1, -1))


def _lockstep_chase(rank_at, bounds: torch.Tensor, D: int, R: int, max_iters: int):
    """The JAX package's lockstep chase (bbme.py:1059-1082): from
    o0 = R*D + R every cell takes the LDSP step `rank_at(o)` names, clamped
    to its bounds, until no cell moves or after `max_iters` steps; the ring
    flag is tested at each offset before its step."""
    C = bounds.shape[0]
    dev = bounds.device
    ldsp = torch.tensor(LDSP, dtype=torch.int32, device=dev)
    lo_r, hi_r, lo_c, hi_c = bounds.unbind(1)
    o = torch.full((C,), R * D + R, dtype=torch.int32, device=dev)
    touched = torch.zeros(C, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        orow, ocol = o // D - R, o % D - R
        touched |= torch.maximum(orow.abs(), ocol.abs()) >= R - 1
        k = rank_at(o).long()
        er = torch.minimum(torch.maximum(orow + ldsp[k, 0], lo_r), hi_r)
        ec = torch.minimum(torch.maximum(ocol + ldsp[k, 1], lo_c), hi_c)
        nxt = (er + R) * D + (ec + R)
        moved = bool((nxt != o).any())
        o = nxt
        if not moved:
            break
    return o, touched


def chase_fixpoint_plain(
    rank_map: torch.Tensor, bounds: torch.Tensor, D: int, R: int, max_iters: int
):
    """Plain version: the lockstep loop with each rank read from the rank
    map."""
    return _lockstep_chase(lambda o: rank_map.gather(1, o[:, None].long())[:, 0],
                           bounds, D, R, max_iters)


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


def _clamp_line(e, lo, hi, R: int, packed_rule: bool):
    """(line, inside) of LDSP candidates on one axis at raw offsets `e`,
    by the rank map's clamp rule: the packed builder's (lo below lo, hi
    above hi), or the select chain's, which differs where lo > hi (e itself
    where its clip min(max(e, lo), hi) is e, and the clip must lie inside
    the volume too)."""
    line = torch.where(e < lo, lo, torch.where(e > hi, hi, e))
    if packed_rule:
        return line, line.abs() <= R
    clip = torch.minimum(torch.maximum(e, lo), hi)
    line = torch.where(clip == e, e, line)
    return line, (line.abs() <= R) & (clip.abs() <= R)


def chase_candidates(volume, bounds, orow, ocol, D: int, R: int, packed_rule: bool):
    """(C, 9) float32 costs of each cell's LDSP candidates at offsets
    (orow, ocol), the rank map's frame clamps applied, +inf where a
    candidate's line lies outside the volume; the (C, 9) int64 entries of
    the cell's volume row they come from; and the (C, 9) bool mask of the
    candidates read from the volume."""
    ldsp = torch.tensor(LDSP, dtype=torch.int32, device=volume.device)
    lo_r, hi_r, lo_c, hi_c = (b[:, None] for b in bounds.unbind(1))
    r, ok_r = _clamp_line(orow[:, None] + ldsp[:, 0], lo_r, hi_r, R, packed_rule)
    c, ok_c = _clamp_line(ocol[:, None] + ldsp[:, 1], lo_c, hi_c, R, packed_rule)
    read = ok_r & ok_c
    idx = ((r.clamp(-R, R) + R) * D + (c.clamp(-R, R) + R)).long()
    cost = volume.gather(1, idx)
    return torch.where(read, cost, float("inf")), idx, read


def chase_volume_plain(
    volume: torch.Tensor, bounds: torch.Tensor, D: int, R: int, max_iters: int,
    packed_rule: bool,
):
    """Plain version: the lockstep loop of `chase_fixpoint_plain`, with each
    rank taken from the nine candidates gathered from the volume at the
    visited offset (`chase_candidates`; `torch.argmin` gives the first
    minimum, so all-+inf candidates give rank 0) instead of the rank map."""
    def rank_at(o):
        cost, _, _ = chase_candidates(volume, bounds, o // D - R, o % D - R, D, R, packed_rule)
        return torch.argmin(cost, dim=1)

    return _lockstep_chase(rank_at, bounds, D, R, max_iters)


def chase_volume(
    volume: torch.Tensor, bounds: torch.Tensor, D: int, R: int, max_iters: int,
    packed_rule: bool,
):
    """Chase every cell's diamond walk from o0 = R*D + R to its fixpoint on
    the (C, D*D) float32 cost volume itself, with (C, 4) int32 per-cell
    clamp bounds (lo_r, hi_r, lo_c, hi_c).  Returns what `chase_fixpoint`
    returns on the rank map of that volume: (C,) int32 offsets and (C,)
    bool ring-visited flags.  `packed_rule` picks the rank map's clamp rule
    where lo > hi: the packed builder's (True; `bbme._succ_map` takes it
    where bs*bs*255*255 < 2**24) or the select chain's.

    Replaces pallas_kernels.py:_chase_kernel and the rank map before it;
    bound on the H100 by the volume sectors its walks read, one thread per
    cell whose nine candidate loads a step are issued together (see
    csrc/chase_volume.cu)."""
    if D != 2 * R + 1:
        raise ValueError(f"D must be 2R+1, got D={D}, R={R}")
    if not isinstance(volume, torch.Tensor) or volume.dim() != 2:
        raise ValueError("volume: expected a (C, D*D) tensor")
    C = volume.shape[0]
    _check(volume, "volume", torch.float32, (C, D * D))
    _check(bounds, "bounds", torch.int32, (C, 4))
    if _on_cpu(volume, bounds):
        return chase_volume_plain(volume, bounds, D, R, max_iters, packed_rule)
    out_o = torch.empty(C, dtype=torch.int32, device=volume.device)
    out_t = torch.empty(C, dtype=torch.bool, device=volume.device)
    if C:
        _launch("chase_volume", load_library().gme_chase_volume, volume.device,
                _ptr(volume), _ptr(bounds), _ptr(out_o), _ptr(out_t),
                C, D, R, max_iters, int(bool(packed_rule)))
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
    one thread per cell row segment of bs bytes at bs 4, 8, 12 and 16 (one
    16-byte store at bs 16), one thread per output byte at other block
    sizes (see csrc/warp_block_field.cu)."""
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
