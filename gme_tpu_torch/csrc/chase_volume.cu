// Diamond-walk chase to its fixpoint, reading the cost volume itself.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_chase_kernel (reached through
// chase_fixpoint) together with the rank map that feeds it
// (gme_tpu/ops/bbme.py _succ_map_packed / _succ_map_select): every diamond
// search of the main path, once per pyramid level.  A Mosaic kernel cannot
// gather at a data-dependent offset, so the TPU builds a dense int8 rank map
// of the winning LDSP candidate at every offset of every cell beforehand and
// looks each rank up with a one-hot masked sum.  An H100 thread can gather:
// this kernel computes the rank only at the offsets the walk visits, from
// the nine candidate costs in the cell's own volume row.
//
// Contract: volume (C, D*D) float32 (entry (dr + R) * D + (dc + R), +inf
// where the candidate block leaves the frame), bounds (C, 4) int32 per-cell
// frame-clamp bounds in offset space (lo_r, hi_r, lo_c, hi_c) -> out_o (C,)
// int32 final offset index, out_touched (C,) bool set when the walk visited
// the volume's boundary-adjacent ring (max |o| >= R - 1).  The walk starts at
// offset (0, 0) and stops when the step leaves it in place or after
// max_iters steps; the ring test runs at each visited offset before the
// step, so the offset a walk cut by max_iters ends on is not tested.  These
// are the results of chase_fixpoint on the rank map, whose entry at each
// offset is the rank computed here:
//
//   each LDSP candidate (a, b) lands on (r', c'), each axis by the rank
//   map's clamp rule (e = orow + a; packed rule: r' = lo if e < lo, else hi
//   if e > hi, else e; the select chain, which differs only where lo > hi,
//   takes e itself where min(max(e, lo), hi) == e and needs that clip inside
//   the volume too); its cost is V[r', c'] when r' and c' lie in [-R, R],
//   else +inf; the rank is the first candidate in LDSP order whose cost is
//   strictly below every earlier one (all +inf: 0, and the walk stops).
//
// Float costs are compared, not packed as cost * 16 + rank, so the rule is
// exact at every block size (above bs 16 costs pass 2^24).
//
// Bound on the H100: the distinct 32-byte sectors of the volume its walks
// read, with the latency of its longest walk below that.  A walk is a chain
// of steps; each step's nine loads are independent of each other, so they
// are issued together before any compare (one load latency a step, not
// nine).  A walk touches a few dozen of its row's D*D entries, so nothing
// is staged in shared memory; one thread per cell, its bounds in registers,
// its own early exit.  Each thread reads its own row, so a warp's loads
// scatter over 32 rows.
#include "gme_kernels.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

// The line a candidate reads on one axis, by the rank map's clamp rule;
// clears `ok` where that line (or, for the select chain, its clip) lies
// outside the volume.
template <bool kPacked>
__device__ __forceinline__ int clamp_line(int e, int lo, int hi, int R, bool& ok) {
  int sel = e < lo ? lo : (e > hi ? hi : e);
  if (!kPacked) {
    const int clip = min(max(e, lo), hi);
    if (clip == e) sel = e;
    ok = ok && abs(clip) <= R;
  }
  ok = ok && abs(sel) <= R;
  return sel;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads) chase_volume_kernel(
    const float* __restrict__ volume, const int* __restrict__ bounds,
    int* __restrict__ out_o, bool* __restrict__ out_touched, int C, int D,
    int R, int max_iters) {
  // LDSP offsets in the reference's scan order (gme_tpu/ops/bbme.py _LDSP);
  // every index below is a constant once the loops are unrolled.
  const int kLdspR[9] = {0, 2, 1, 0, -1, -2, -1, 0, 1};
  const int kLdspC[9] = {0, 0, 1, 2, 1, 0, -1, -2, -1};
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= C) return;
  // The cell's row, at offset (0, 0).
  const float* centre = volume + (size_t)cell * D * D + (size_t)R * D + R;
  const int lo_r = __ldg(bounds + 4 * cell + 0), hi_r = __ldg(bounds + 4 * cell + 1);
  const int lo_c = __ldg(bounds + 4 * cell + 2), hi_c = __ldg(bounds + 4 * cell + 3);
  int orow = 0, ocol = 0;
  bool touched = false;
  for (int it = 0; it < max_iters; ++it) {
    touched |= max(abs(orow), abs(ocol)) >= R - 1;
    float cost[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      bool ok = true;
      const int r = clamp_line<kPacked>(orow + kLdspR[k], lo_r, hi_r, R, ok);
      const int c = clamp_line<kPacked>(ocol + kLdspC[k], lo_c, hi_c, R, ok);
      cost[k] = ok ? __ldg(centre + r * D + c) : CUDART_INF_F;
    }
    float best = cost[0];
    int dr = kLdspR[0], dc = kLdspC[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      if (cost[k] < best) {
        best = cost[k];
        dr = kLdspR[k];
        dc = kLdspC[k];
      }
    }
    const int er = min(max(orow + dr, lo_r), hi_r);
    const int ec = min(max(ocol + dc, lo_c), hi_c);
    if (er == orow && ec == ocol) break;
    orow = er;
    ocol = ec;
  }
  out_o[cell] = (orow + R) * D + (ocol + R);
  out_touched[cell] = touched;
}

}  // namespace

GME_API int gme_chase_volume(const void* volume, const void* bounds, void* out_o,
                             void* out_touched, int C, int D, int R,
                             int max_iters, int packed_rule, void* stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(volume);
  const auto* b = static_cast<const int*>(bounds);
  auto* o = static_cast<int*>(out_o);
  auto* t = static_cast<bool*>(out_touched);
  if (packed_rule) {
    chase_volume_kernel<true><<<blocks, kThreads, 0, s>>>(v, b, o, t, C, D, R, max_iters);
  } else {
    chase_volume_kernel<false><<<blocks, kThreads, 0, s>>>(v, b, o, t, C, D, R, max_iters);
  }
  return cudaGetLastError();
}
