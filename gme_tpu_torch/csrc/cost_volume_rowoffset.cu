// Block-DFD cost volume (MAE or MSE) for every block size and every D.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_cost_volume_kernel (reached through
// _dfd_cost_volume_rowoffset): the volumes the two specialised kernels do not
// take, which are MAE at bs >= 8, D < 8, block sizes that do not divide 8, and
// MSE at bs > 16.  On the block-matching path that is the BBME command line's
// default three-step search (MAE, bs = 12, D = 51 at 720p), the exhaustive
// dense init of the GME step (MSE, bs = 2, D = 6) and the MAE diamond and
// 2D-log volumes.  The TPU kernel takes one row offset per grid step and pools
// blocks on its matrix unit; here every offset tile is an independent CUDA
// block (cost_volume_tiles.cuh), since blocks run in no order.
//
// Bound on the H100: at bs = 12, D = 51 integer work, 144 pixels of two
// shared-memory byte loads, a subtract and an add per output (19 G pixel terms
// for an 8-pair 720p batch); at bs = 2, D = 6 the output writes, 4 pixels per
// 4-byte store.  The tiles serve both: a block holds one cell's 16 x 16
// offsets per warp row at large D and dozens of cells at small D, with the
// tile's pixels read from device memory once into shared memory.
//
// Exactness: int32 sums from uint8, rounded to float32 once.  MAE is exact
// up to bs = 256 and MSE up to bs = 16; above that each entry is the integer
// sum correctly rounded, which the plain version reproduces.  The wrapper
// refuses MSE above bs = 181 and MAE above bs = 2901 (int32 overflow).
#include "cost_volume_tiles.cuh"

namespace {

using gme_tiles::Tiles;

__global__ void __launch_bounds__(gme_tiles::kThreads) cost_volume_rowoffset_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, int pnorm, Tiles tl) {
  if (pnorm == 1)
    gme_tiles::volume_tile<gme_tiles::kMse>(prev, curr, out, Hc, Wc, bs, D, tl);
  else
    gme_tiles::volume_tile<gme_tiles::kMae>(prev, curr, out, Hc, Wc, bs, D, tl);
}

}  // namespace

GME_API int gme_cost_volume_rowoffset(const void* prev, const void* curr_pad,
                                      void* out, int B, int Hc, int Wc, int bs,
                                      int D, int pnorm, void* stream) {
  return gme_tiles::launch_tiles(
      cost_volume_rowoffset_kernel, B, Hc, Wc, bs, D, stream,
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(curr_pad),
      static_cast<float*>(out), Hc, Wc, bs, D, pnorm);
}
