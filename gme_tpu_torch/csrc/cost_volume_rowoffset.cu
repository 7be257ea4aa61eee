// Block-DFD cost volume (MAE or MSE) for every block size and every D.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_cost_volume_kernel (reached through
// _dfd_cost_volume_rowoffset): the volumes the two specialised kernels do not
// take, which are MAE at bs >= 8, D < 8, block sizes that do not divide 8, and
// MSE at bs > 16.  On the block-matching path that is the BBME command line's
// default three-step search (MAE, bs = 12, D = 51 at 720p), the exhaustive
// dense init of the GME step (MSE, bs = 2, D = 6) and the MAE diamond and
// 2D-log volumes.  The TPU kernel takes one row offset per grid step and pools
// blocks on its matrix unit; here the offsets of a cell are cut into tiles
// that run as independent threads and CUDA blocks, since blocks run in no
// order.
//
// Bound on the H100: at bs = 12, D = 51 integer instructions, 19 G pixel
// terms for an 8-pair 720p batch at half an instruction a term
// (__vabsdiffu4 + __dp4a on four packed bytes): 0.57 ms at the int32 rate.
// At bs = 2, D = 6 the output writes, 4 pixels per 4-byte store.
//
// Design (cost_volume_tiles.cuh, which says more): pixels packed four to a
// 32-bit word everywhere, so a word of four terms costs one __vabsdiffu4 and
// one __dp4a.  At bs 3 and 5..32 a thread keeps a 4 x 4 tile of one cell's
// offsets in registers and reuses each aligned, shifted window word for four
// column offsets and each broadcast prev word for four of them too, about
// 0.85 issue slots a term at bs 12 in its SASS (a byte-wise loop: about
// five).  At bs 1, 2, 4 the launcher takes the small-block body of
// cost_volume_small_block.cuh (16-byte stores; the write binds there), whose
// D >= 8 was only the JAX dispatch's rule.  Above bs 32 (no search reaches
// it) offset tiles staged as bytes, with the same packed terms.
//
// Exactness: 32-bit integer sums from uint8, rounded to float32 once.  MAE
// is exact up to bs = 256 and MSE up to bs = 16; above that each entry is the
// integer sum correctly rounded, which the plain version reproduces.  The
// wrapper refuses MSE above bs = 181 and MAE above bs = 2901 (int32 overflow).
#include "cost_volume_tiles.cuh"

namespace {

using gme_vol::kMae;
using gme_vol::kMse;

template <int W, int kMode>
__global__ void __launch_bounds__(gme_vol::kThreads) cost_volume_rowoffset_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, gme_vol::PackedPlan pl) {
  gme_vol::packed_tile<W, kMode>(prev, curr, out, Hc, Wc, bs, D, pl);
}

template <int BS, int kMode>
__global__ void __launch_bounds__(gme_vol::kSmallThreads) cost_volume_rowoffset_small_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int T, int R, int parts) {
  gme_vol::small_block_volume<BS, kMode>(prev, curr, out, Hc, Wc, D, T, R, parts);
}

template <int kMode>
__global__ void __launch_bounds__(gme_vol::kThreads) cost_volume_rowoffset_wide_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, gme_vol::Tiles tl) {
  gme_vol::volume_tile<kMode>(prev, curr, out, Hc, Wc, bs, D, tl);
}

template <int kMode>
cudaError_t launch(const uint8_t* p, const uint8_t* c, float* o, int B, int Hc, int Wc, int bs,
                   int D, cudaStream_t s) {
  return gme_vol::launch_volume(
      [](auto n) { return cost_volume_rowoffset_small_kernel<decltype(n)::value, kMode>; },
      [](auto n) { return cost_volume_rowoffset_kernel<decltype(n)::value, kMode>; },
      cost_volume_rowoffset_wide_kernel<kMode>, p, c, o, B, Hc, Wc, bs, D, s);
}

}  // namespace

GME_API int gme_cost_volume_rowoffset(const void* prev, const void* curr_pad,
                                      void* out, int B, int Hc, int Wc, int bs,
                                      int D, int pnorm, void* stream) {
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* c = static_cast<const uint8_t*>(curr_pad);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return pnorm == 1 ? launch<kMse>(p, c, o, B, Hc, Wc, bs, D, s)
                    : launch<kMae>(p, c, o, B, Hc, Wc, bs, D, s);
}
