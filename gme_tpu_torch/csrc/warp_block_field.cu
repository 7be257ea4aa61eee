// Block-constant warp of a uint8 frame with clipped sources.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_warp_kernel (reached through
// warp_block_field): the motion compensation of the main path.  The TPU
// kernel selects rows and columns with one-hot matrix products because its
// vector unit cannot gather; on the H100 this is a plain gather.
//
// Contract: frame (B, H, W) uint8, d (B, nbh, nbw, 2) int32 with channel 0 the
// column shift and channel 1 the row shift -> out (B, nbh*bs, nbw*bs) uint8,
// out[r, c] = frame[clip(r - d[r/bs, c/bs, 1], 0, H-1),
//                   clip(c - d[r/bs, c/bs, 0], 0, W-1)].
// The out-of-bounds-keeps-original mask is the caller's
// (gme_tpu_torch/ops/warp.py compensate_frame), as in the JAX package.
//
// Bound on the H100: bytes, one frame read and one frame written per pair
// (0.9 MB each at 720p) plus the small field.  Design: one thread per output
// pixel, a warp per 32 neighbouring pixels of one row, so stores are
// coalesced and the gathered loads of a block-constant shift are contiguous
// within each block.
#include "gme_kernels.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) warp_block_field_kernel(
    const uint8_t* __restrict__ frame, const int* __restrict__ d,
    uint8_t* __restrict__ out, int H, int W, int nbh, int nbw, int bs) {
  const int cov_w = nbw * bs;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y, b = blockIdx.z;
  if (c >= cov_w) return;
  const int* dv = d + (((size_t)b * nbh + r / bs) * nbw + c / bs) * 2;
  const int sr = min(max(r - dv[1], 0), H - 1);
  const int sc = min(max(c - dv[0], 0), W - 1);
  out[((size_t)b * nbh * bs + r) * cov_w + c] =
      frame[((size_t)b * H + sr) * W + sc];
}

}  // namespace

GME_API int gme_warp_block_field(const void* frame, const void* d, void* out,
                                 int B, int H, int W, int nbh, int nbw, int bs,
                                 void* stream) {
  const dim3 grid((nbw * bs + kThreads - 1) / kThreads, nbh * bs, B);
  warp_block_field_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frame), static_cast<const int*>(d),
      static_cast<uint8_t*>(out), H, W, nbh, nbw, bs);
  return cudaGetLastError();
}
