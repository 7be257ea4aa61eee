// Diamond-walk chase to its fixpoint on the LDSP rank map.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_chase_kernel (reached through
// chase_fixpoint): every diamond search of the main path, once per pyramid
// level.
//
// Contract: rank (C, D*D) int8 with entries 0..8 (the index into the LDSP
// table of the winning candidate at each volume offset), bounds (C, 4) int32
// per-cell frame-clamp bounds in offset space (lo_r, hi_r, lo_c, hi_c) ->
// out_o (C,) int32 final offset index, out_touched (C,) bool set when the
// walk visited the volume's boundary-adjacent ring (max |o| >= R - 1).  The
// walk starts at o0 = R*D + R and stops when the step leaves it in place or
// after max_iters steps.  A fixpoint absorbs, so stopping each cell at its
// own fixpoint gives the results of the TPU kernel's lockstep loop, which
// runs every cell until the last one stops.
//
// Bound on the H100: neither bytes nor operations.  Each step is one
// dependent byte load at a data-dependent offset, so the kernel is latency
// bound; a walk takes a few to a few tens of steps.  Design: one thread per
// cell with its own early exit, so a converged cell costs nothing while its
// neighbours walk on, and enough cells (86,400 for a 24-pair 720p batch at
// level 2) keep the card's warps busy to hide the load latency.
#include "gme_kernels.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) chase_fixpoint_kernel(
    const int8_t* __restrict__ rank, const int* __restrict__ bounds,
    int* __restrict__ out_o, bool* __restrict__ out_touched, int C, int D,
    int R, int max_iters) {
  // LDSP offsets in the reference's scan order (gme_tpu/ops/bbme.py _LDSP).
  const int ldsp_r[9] = {0, 2, 1, 0, -1, -2, -1, 0, 1};
  const int ldsp_c[9] = {0, 0, 1, 2, 1, 0, -1, -2, -1};
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= C) return;
  const int8_t* row = rank + (size_t)cell * D * D;
  const int lo_r = bounds[4 * cell + 0], hi_r = bounds[4 * cell + 1];
  const int lo_c = bounds[4 * cell + 2], hi_c = bounds[4 * cell + 3];
  int o = R * D + R;
  bool touched = false;
  for (int it = 0; it < max_iters; ++it) {
    const int orow = o / D - R, ocol = o % D - R;
    touched |= max(abs(orow), abs(ocol)) >= R - 1;
    const int k = row[o];
    const int er = min(max(orow + ldsp_r[k], lo_r), hi_r);
    const int ec = min(max(ocol + ldsp_c[k], lo_c), hi_c);
    const int nxt = (er + R) * D + (ec + R);
    if (nxt == o) break;
    o = nxt;
  }
  out_o[cell] = o;
  out_touched[cell] = touched;
}

}  // namespace

GME_API int gme_chase_fixpoint(const void* rank, const void* bounds,
                               void* out_o, void* out_touched, int C, int D,
                               int R, int max_iters, void* stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  chase_fixpoint_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rank), static_cast<const int*>(bounds),
      static_cast<int*>(out_o), static_cast<bool*>(out_touched), C, D, R,
      max_iters);
  return cudaGetLastError();
}
