// Block cross-correlation volume, sum over each block of prev * curr, and in
// SSD mode the MSE volume built on it.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_cross_volume_kernel (reached through
// _dfd_cost_volume_rowoffset(cross=True) from _dfd_cost_volume_mse_decomp):
// the offset-dependent term of the MSE volume at 8 <= bs <= 16 when
// bs + D - 1 > 128, where the MSE kernel's whole-cell window no longer fits.
// The GME step reaches it at a volume radius of 57 or more (bs = 16, D = 129
// at a radius of 64); the diamond and 2D-log searches at large radii.  In
// SSD mode the kernel also forms sum (a - b)^2 = sum a^2 - 2 sum ab + sum b^2
// in its epilogue, so _dfd_cost_volume_mse_decomp is one launch on the card.
//
// Bound on the H100: the output write.  At 720p (B 8, bs 16, D 129) the
// volume is 1.92 GB of float32 (0.57 ms at 3.35 TB/s) for 123 G u8
// multiply-adds, 0.12 ms on the int8 tensor cores.
//
// Design, 8 <= bs <= 16: the u8 tensor-core body of cost_volume_mma.cuh (the
// one cost_volume_mse_block.cu runs) in bands of offset rows.  One CUDA block
// per (pair, cell, band of R offset rows), all D column offsets of the band:
// D is cut into near-equal bands whose (R, D) int32 stage holds at most
// about kBandOutputs outputs (D 129 -> 3 bands of 43), so the stage, the
// column-sum table and the (bs+R-1)-row window stay small for any D (60 KB
// in SSD mode at bs 16, D 129: three blocks an SM).  A band's outputs are one
// contiguous run, stored as aligned 16-byte quads.  Consecutive blocks take
// the bands of one cell, so its window rows meet in L2.
//
// Other block sizes (cross mode to bs 181, SSD mode below bs 8) take the
// packed-word routes of cost_volume_tiles.cuh that cost_volume_rowoffset.cu
// runs: one __dp4a a word of four cross terms (SSD mode: the direct MSE,
// __vabsdiffu4 and __dp4a), in 4 x 4 register tiles of offsets at bs 3 and
// 5..32, the small-block body at bs 1, 2, 4, byte-staged tiles above bs 32.
//
// Exactness: int32 sums from uint8, rounded to float32 once; at bs <= 16
// every sum is at most 16 * 16 * 255^2 = 16,646,400 < 2**24, so both modes
// are exact.
#include "cost_volume_mma.cuh"
#include "cost_volume_tiles.cuh"

namespace {

// At most about this many outputs (ints of the stage) per CUDA block.
constexpr long long kBandOutputs = 5632;

template <int BS, bool SSD>
__global__ void __launch_bounds__(gme_mma::kThreads, 4) cost_volume_cross_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int Rb, int n_bands) {
  const int j = blockIdx.x / n_bands, band = blockIdx.x - j * n_bands;
  gme_mma::volume_band<BS, SSD>(prev, curr, out, Hc, Wc, D, Rb, j, blockIdx.y, blockIdx.z, band);
}

template <int BS, bool SSD>
cudaError_t launch_bands(const uint8_t* prev, const uint8_t* curr, float* out, int B, int Hc,
                         int Wc, int D, cudaStream_t stream) {
  const long long want = ((long long)D * D + kBandOutputs - 1) / kBandOutputs;
  const int Rb = (int)((D + want - 1) / want), n_bands = (D + Rb - 1) / Rb;
  const long long gx = (long long)(Wc / BS) * n_bands;
  if (gx > 0x7fffffffLL || Hc / BS > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, Hc / BS, B);
  const size_t shared = gme_mma::Layout(BS, D, Rb, SSD).total;
  cudaError_t err = gme_allow_shared(cost_volume_cross_kernel<BS, SSD>, shared);
  if (err != cudaSuccess) return err;
  cost_volume_cross_kernel<BS, SSD><<<grid, gme_mma::kThreads, shared, stream>>>(
      prev, curr, out, Hc, Wc, D, Rb, n_bands);
  return cudaGetLastError();
}

template <bool SSD>
cudaError_t launch_bs(const uint8_t* p, const uint8_t* c, float* o, int B, int Hc, int Wc,
                      int bs, int D, cudaStream_t s) {
  switch (bs) {
    case 8: return launch_bands<8, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 9: return launch_bands<9, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 10: return launch_bands<10, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 11: return launch_bands<11, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 12: return launch_bands<12, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 13: return launch_bands<13, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 14: return launch_bands<14, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 15: return launch_bands<15, SSD>(p, c, o, B, Hc, Wc, D, s);
    case 16: return launch_bands<16, SSD>(p, c, o, B, Hc, Wc, D, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int W, int kMode>
__global__ void __launch_bounds__(gme_vol::kThreads) cost_volume_cross_tiles_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, gme_vol::PackedPlan pl) {
  gme_vol::packed_tile<W, kMode>(prev, curr, out, Hc, Wc, bs, D, pl);
}

template <int BS, int kMode>
__global__ void __launch_bounds__(gme_vol::kSmallThreads) cost_volume_cross_small_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int T, int R, int parts) {
  gme_vol::small_block_volume<BS, kMode>(prev, curr, out, Hc, Wc, D, T, R, parts);
}

template <int kMode>
__global__ void __launch_bounds__(gme_vol::kThreads) cost_volume_cross_wide_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, gme_vol::Tiles tl) {
  gme_vol::volume_tile<kMode>(prev, curr, out, Hc, Wc, bs, D, tl);
}

// The packed-word routes outside bs 8..16: kCross, or kMse for SSD mode.
template <int kMode>
cudaError_t launch_tiles(const uint8_t* p, const uint8_t* c, float* o, int B, int Hc, int Wc,
                         int bs, int D, cudaStream_t s) {
  return gme_vol::launch_volume(
      [](auto n) { return cost_volume_cross_small_kernel<decltype(n)::value, kMode>; },
      [](auto n) { return cost_volume_cross_tiles_kernel<decltype(n)::value, kMode>; },
      cost_volume_cross_wide_kernel<kMode>, p, c, o, B, Hc, Wc, bs, D, s);
}

}  // namespace

// ssd = 0: the cross volume (bs <= 181); ssd = 1: the MSE volume (bs <= 16).
GME_API int gme_cost_volume_cross(const void* prev, const void* curr_pad, void* out,
                                  int B, int Hc, int Wc, int bs, int D, int ssd,
                                  void* stream) {
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* c = static_cast<const uint8_t*>(curr_pad);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bs >= 8 && bs <= 16)
    return ssd ? launch_bs<true>(p, c, o, B, Hc, Wc, bs, D, s)
               : launch_bs<false>(p, c, o, B, Hc, Wc, bs, D, s);
  if (ssd) return bs < 8 ? launch_tiles<gme_vol::kMse>(p, c, o, B, Hc, Wc, bs, D, s)
                        : cudaErrorInvalidValue;
  return launch_tiles<gme_vol::kCross>(p, c, o, B, Hc, Wc, bs, D, s);
}
