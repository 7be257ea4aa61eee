// Block cross-correlation volume: sum over each block of prev * curr.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_cross_volume_kernel (reached through
// _dfd_cost_volume_rowoffset(cross=True) from _dfd_cost_volume_mse_decomp):
// the offset-dependent term of the MSE volume at 8 <= bs <= 16 when
// bs + D - 1 > 128, where the specialised MSE kernel keeps too large a window.
// The GME step reaches it at a volume radius of 57 or more (bs = 16, D = 129
// at a radius of 64); the diamond and 2D-log searches at large radii.
// gme_tpu_torch/ops/bbme.py adds the offset-independent terms in int32:
// sum (a - b)^2 = sum a^2 - 2 sum ab + sum b^2.
//
// Bound on the H100: integer work, one multiply-add and two shared-memory
// byte loads per pixel.  At bs = 16, D = 129 that is 15.3 G pixel terms per
// 720p pair.  Design: the offset tiles of cost_volume_tiles.cuh, one cell of
// 16 x 16 offsets per warp row, eight cells per CUDA block, so any D is taken
// with a few KB of shared memory per block.
//
// Exactness: int32 sums from uint8, rounded to float32 once; at bs <= 16 every
// sum is at most 16 * 16 * 255^2 = 16,646,400 < 2**24, so the volume is exact.
#include "cost_volume_tiles.cuh"

namespace {

using gme_tiles::Tiles;

__global__ void __launch_bounds__(gme_tiles::kThreads) cost_volume_cross_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, Tiles tl) {
  gme_tiles::volume_tile<gme_tiles::kCross>(prev, curr, out, Hc, Wc, bs, D, tl);
}

}  // namespace

GME_API int gme_cost_volume_cross(const void* prev, const void* curr_pad, void* out,
                                  int B, int Hc, int Wc, int bs, int D, void* stream) {
  return gme_tiles::launch_tiles(
      cost_volume_cross_kernel, B, Hc, Wc, bs, D, stream,
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(curr_pad),
      static_cast<float*>(out), Hc, Wc, bs, D);
}
