// Block-DFD cost volume for small blocks (bs < 8, 8 % bs == 0, D >= 8: the
// JAX dispatch's rule for this kernel; the body itself takes any D).
//
// Replaces gme_tpu/ops/pallas_kernels.py:_planes_kernel (reached through
// _dfd_cost_volume_planes): the MAE/MSE volume of the dense init, bs = 2 and
// D = 33 on the main path (D = 17 in the adaptive fast tier).
//
// Contract: prev (B, Hc, Wc) uint8 and curr_pad (B, Hc+D-1, Wc+D-1) uint8,
// where the window of offset index (dr, dc) is curr_pad[dr:dr+Hc, dc:dc+Wc];
// out (B, nbh, nbw, D*D) float32, out[..., dr*D + dc] = sum over the block of
// |diff| (pnorm 0) or diff^2 (pnorm 1).  That is the layout
// compute_cost_volume returns, so no transpose follows.  uint8 inputs and
// int32 sums are exact; every sum is below 2**24, so the float32 store is too.
//
// Bound on the H100: the output write.  Each output is bs^2 <= 16 pixel
// terms against a 4-byte store: at 720p (B 24, 180x320, bs 2, D 33) 1.505 GB
// of float32, 0.45 ms at 3.35 TB/s, against 3 G int32 operations.
// Design (cost_volume_small_block.cuh, shared with cost_volume_rowoffset.cu
// and cost_volume_cross.cu at these block sizes): packed 32-bit words in
// shared memory, one __vabsdiffu4 and __dp4a per word, four consecutive
// outputs a thread in one 16-byte streaming store.  bs and the norm are
// template arguments, so the pixel loops unroll.
#include "cost_volume_small_block.cuh"

namespace {

using gme_vol::kMae;
using gme_vol::kMse;

template <int BS, int kMode>
__global__ void __launch_bounds__(gme_vol::kSmallThreads) cost_volume_small_block_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int T, int R, int parts) {
  gme_vol::small_block_volume<BS, kMode>(prev, curr, out, Hc, Wc, D, T, R, parts);
}

template <int BS, int kMode>
cudaError_t launch(const uint8_t* p, const uint8_t* c, float* o, int B, int Hc, int Wc, int D,
                   cudaStream_t s) {
  return gme_vol::launch_small<BS>(cost_volume_small_block_kernel<BS, kMode>, p, c, o, B, Hc, Wc,
                                   D, s);
}

}  // namespace

GME_API int gme_cost_volume_small_block(const void* prev, const void* curr_pad,
                                        void* out, int B, int Hc, int Wc,
                                        int bs, int D, int pnorm,
                                        void* stream) {
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* c = static_cast<const uint8_t*>(curr_pad);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bs * 2 + (pnorm ? 1 : 0)) {
    case 2: return launch<1, kMae>(p, c, o, B, Hc, Wc, D, s);
    case 3: return launch<1, kMse>(p, c, o, B, Hc, Wc, D, s);
    case 4: return launch<2, kMae>(p, c, o, B, Hc, Wc, D, s);
    case 5: return launch<2, kMse>(p, c, o, B, Hc, Wc, D, s);
    case 8: return launch<4, kMae>(p, c, o, B, Hc, Wc, D, s);
    case 9: return launch<4, kMse>(p, c, o, B, Hc, Wc, D, s);
    default: return cudaErrorInvalidValue;
  }
}
