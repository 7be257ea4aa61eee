// MSE cost volume for large blocks (8 <= bs <= 16, D >= 8, bs + D - 1 <= 128)
// with the cross term on the u8 tensor cores.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_hankel_mse_kernel (reached through
// _dfd_cost_volume_hankel): the volume of pyramid levels 1 and 2, bs = 16 and
// D = 65 on the main path (D = 25 in the adaptive fast tier).  Like the TPU
// kernel it forms SSD = sum a^2 - 2 sum ab + sum b^2, here all in int32, so
// every entry is exact: the largest, 16 * 16 * 255^2 = 16,646,400, is below
// 2**24, and the float32 store is exact as well.
//
// Contract: prev (B, Hc, Wc) uint8, curr_pad (B, Hc+D-1, Wc+D-1) uint8 ->
// out (B, nbh, nbw, D*D) float32 with out[..., dr*D + dc] the block SSD at
// window offset (dr, dc): the layout compute_cost_volume returns.
//
// Bound on the H100: the output write.  At 720p level 2 (B 24, D 65) the
// kernel writes 1.46 GB of float32 (0.45 ms at 3.35 TB/s) for 93.5 G u8
// multiply-adds, 0.09 ms on the int8 tensor cores.  A CUDA-core loop needs a
// shared-memory byte load per multiply-add and cannot get below ~11 ms.
//
// Design: the u8 tensor-core body of cost_volume_mma.cuh in its SSD mode,
// one CUDA block of 8 warps per (pair, cell), one band of all D offset rows:
// - the cell's (bs+D-1)^2 window staged in shared memory by 16-byte
//   cp.async, the prev block as zero-padded 48-byte rows;
// - the cross term on mma.sync m16n8k32 u8 x u8 -> s32, A rows (dr, column
//   group g of 8) of the window, B the 8-wide Toeplitz band of each prev row
//   held in registers, two m-tiles a warp; about 2.25x the needed MACs at
//   bs 16;
// - sum a^2 from two conflict-free passes over the window (column sums over
//   bs rows, sliding sums over bs columns), sum b^2 from one block
//   reduction, both int32; the epilogue forms sum a^2 - 2 sum ab + sum b^2
//   in place in the staged (D, D) result, stored as aligned 16-byte
//   streaming quads.
// At bs + D - 1 <= 128 the whole cell fits (155 KB at bs 8, D 121); larger
// windows are cost_volume_cross.cu's, in bands.
#include "cost_volume_mma.cuh"

namespace {

template <int BS>
__global__ void __launch_bounds__(gme_mma::kThreads, 4) cost_volume_mse_block_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D) {
  gme_mma::volume_band<BS, true>(prev, curr, out, Hc, Wc, D, D, blockIdx.x, blockIdx.y,
                                 blockIdx.z, 0);
}

template <int BS>
cudaError_t launch(const uint8_t* prev, const uint8_t* curr, float* out, int B, int Hc, int Wc,
                   int D, cudaStream_t stream) {
  const dim3 grid(Wc / BS, Hc / BS, B);
  const size_t shared = gme_mma::Layout(BS, D, D, true).total;
  cudaError_t err = gme_allow_shared(cost_volume_mse_block_kernel<BS>, shared);
  if (err != cudaSuccess) return err;
  cost_volume_mse_block_kernel<BS><<<grid, gme_mma::kThreads, shared, stream>>>(prev, curr, out,
                                                                                 Hc, Wc, D);
  return cudaGetLastError();
}

}  // namespace

GME_API int gme_cost_volume_mse_block(const void* prev, const void* curr_pad,
                                      void* out, int B, int Hc, int Wc, int bs,
                                      int D, void* stream) {
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* c = static_cast<const uint8_t*>(curr_pad);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 8: return launch<8>(p, c, o, B, Hc, Wc, D, s);
    case 9: return launch<9>(p, c, o, B, Hc, Wc, D, s);
    case 10: return launch<10>(p, c, o, B, Hc, Wc, D, s);
    case 11: return launch<11>(p, c, o, B, Hc, Wc, D, s);
    case 12: return launch<12>(p, c, o, B, Hc, Wc, D, s);
    case 13: return launch<13>(p, c, o, B, Hc, Wc, D, s);
    case 14: return launch<14>(p, c, o, B, Hc, Wc, D, s);
    case 15: return launch<15>(p, c, o, B, Hc, Wc, D, s);
    case 16: return launch<16>(p, c, o, B, Hc, Wc, D, s);
    default: return cudaErrorInvalidValue;
  }
}
