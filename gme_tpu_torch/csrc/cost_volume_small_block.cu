// Block-DFD cost volume for small blocks (bs < 8, 8 % bs == 0, D >= 8).
//
// Replaces gme_tpu/ops/pallas_kernels.py:_planes_kernel (reached through
// _dfd_cost_volume_planes): the MAE/MSE volume of the dense init, bs = 2 and
// D = 33 on the main path.
//
// Contract: prev (B, Hc, Wc) uint8 and curr_pad (B, Hc+D-1, Wc+D-1) uint8,
// where the window of offset index (dr, dc) is curr_pad[dr:dr+Hc, dc:dc+Wc];
// out (B, nbh, nbw, D*D) float32, out[..., dr*D + dc] = sum over the block of
// |diff| (pnorm 0) or diff^2 (pnorm 1).  That is the layout
// compute_cost_volume returns, so no transpose follows.  uint8 inputs and
// int32 sums are exact; every sum is below 2**24, so the float32 store is too.
//
// Bound on the H100: output bytes.  At bs = 2 each output is 4 pixels of
// work against a 4-byte store: 62.7 MB per 720p pair for 14,400 cells x 1089
// offsets.  Design: one CUDA block per (pair, 8 x 16 cells) tile holds the
// prev tile and its curr window (tile plus the D-1 halo) in shared memory,
// read from device memory once; the block then walks its cells and its
// threads stride over the cell's D*D offsets, so consecutive threads store
// consecutive floats (coalesced) and read neighbouring shared-memory bytes.
#include "gme_kernels.cuh"

namespace {

constexpr int kTileRows = 8;   // cells per tile, vertically
constexpr int kTileCols = 16;  // cells per tile, horizontally
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) cost_volume_small_block_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, int pnorm) {
  extern __shared__ uint8_t smem[];
  const int nbh = Hc / bs, nbw = Wc / bs;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const int b = blockIdx.z;
  const int cr0 = blockIdx.y * kTileRows, cc0 = blockIdx.x * kTileCols;
  const int th = min(kTileRows, nbh - cr0), tw = min(kTileCols, nbw - cc0);
  const int ph = th * bs, pw = tw * bs;        // prev tile, pixels
  const int wh = ph + D - 1, ww = pw + D - 1;  // curr window, pixels
  uint8_t* prev_s = smem;
  uint8_t* win_s = smem + kTileRows * bs * kTileCols * bs;

  const int r0 = cr0 * bs, c0 = cc0 * bs;
  const uint8_t* prev_b = prev + (size_t)b * Hc * Wc + (size_t)r0 * Wc + c0;
  const uint8_t* curr_b = curr + (size_t)b * Hp * Wp + (size_t)r0 * Wp + c0;
  for (int i = threadIdx.x; i < ph * pw; i += blockDim.x) {
    const int r = i / pw, c = i - r * pw;
    prev_s[i] = prev_b[(size_t)r * Wc + c];
  }
  for (int i = threadIdx.x; i < wh * ww; i += blockDim.x) {
    const int r = i / ww, c = i - r * ww;
    win_s[i] = curr_b[(size_t)r * Wp + c];
  }
  __syncthreads();

  const int DD = D * D;
  for (int cell = 0; cell < th * tw; ++cell) {
    const int tr = cell / tw, tc = cell - tr * tw;
    const uint8_t* p = prev_s + tr * bs * pw + tc * bs;
    float* out_cell =
        out + (((size_t)b * nbh + cr0 + tr) * nbw + cc0 + tc) * (size_t)DD;
    for (int k = threadIdx.x; k < DD; k += blockDim.x) {
      const int dr = k / D, dc = k - dr * D;
      const uint8_t* q = win_s + (tr * bs + dr) * ww + tc * bs + dc;
      int acc = 0;
      for (int r = 0; r < bs; ++r) {
        for (int c = 0; c < bs; ++c) {
          const int d = (int)q[r * ww + c] - (int)p[r * pw + c];
          acc += pnorm ? d * d : abs(d);
        }
      }
      out_cell[k] = (float)acc;
    }
  }
}

}  // namespace

GME_API int gme_cost_volume_small_block(const void* prev, const void* curr_pad,
                                        void* out, int B, int Hc, int Wc,
                                        int bs, int D, int pnorm,
                                        void* stream) {
  const int nbh = Hc / bs, nbw = Wc / bs;
  const dim3 grid((nbw + kTileCols - 1) / kTileCols,
                  (nbh + kTileRows - 1) / kTileRows, B);
  const size_t shared = (size_t)kTileRows * bs * kTileCols * bs +
                        (size_t)(kTileRows * bs + D - 1) * (kTileCols * bs + D - 1);
  cudaError_t err = gme_allow_shared(cost_volume_small_block_kernel, shared);
  if (err != cudaSuccess) return err;
  cost_volume_small_block_kernel<<<grid, kThreads, shared,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(curr_pad),
      static_cast<float*>(out), Hc, Wc, bs, D, pnorm);
  return cudaGetLastError();
}
