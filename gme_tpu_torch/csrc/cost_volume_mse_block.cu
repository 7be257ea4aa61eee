// MSE cost volume for large blocks (8 <= bs <= 16, bs + D - 1 <= 128).
//
// Replaces gme_tpu/ops/pallas_kernels.py:_hankel_mse_kernel (reached through
// _dfd_cost_volume_hankel): the volume of pyramid levels 1 and 2, bs = 16 and
// D = 65 on the main path.  The TPU kernel forms sum a^2 - 2 sum ab + sum b^2
// with Hankel x Toeplitz bf16 matmuls for its matrix unit; that is a device
// trick, not the contract.  This kernel sums (a - b)^2 directly in int32,
// which is exact: the largest block sum, 16 * 16 * 255^2 = 16,646,400, is
// below 2**24, so the float32 store is exact as well.
//
// Contract: prev (B, Hc, Wc) uint8, curr_pad (B, Hc+D-1, Wc+D-1) uint8 ->
// out (B, nbh, nbw, D*D) float32 with out[..., dr*D + dc] the block SSD at
// window offset (dr, dc): the layout compute_cost_volume returns.
//
// Bound on the H100: integer operations.  At 720p level 2 that is 3,600
// cells x 4225 offsets x 256 pixels = 3.9 G multiply-adds per pair, against
// 61 MB of output.  Design: one CUDA block per (pair, cell) holds the cell's
// prev block and its (bs+D-1)^2 curr window in shared memory; each thread
// keeps one prev row in registers and strides over the D*D offsets, so the
// inner loop is one shared-memory byte load, a subtract and a multiply-add.
// Consecutive threads take consecutive column offsets: neighbouring bytes,
// and coalesced float stores.
#include "gme_kernels.cuh"

namespace {

constexpr int kMaxBs = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) cost_volume_mse_block_kernel(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D) {
  extern __shared__ int smem[];
  const int K = bs + D - 1;
  int* prev_s = smem;                                       // bs * bs
  uint8_t* win_s = reinterpret_cast<uint8_t*>(smem + bs * bs);  // K * K
  const int j = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int nbh = Hc / bs, nbw = Wc / bs;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const uint8_t* prev_b =
      prev + (size_t)b * Hc * Wc + (size_t)t * bs * Wc + (size_t)j * bs;
  const uint8_t* curr_b =
      curr + (size_t)b * Hp * Wp + (size_t)t * bs * Wp + (size_t)j * bs;
  for (int i = threadIdx.x; i < bs * bs; i += blockDim.x) {
    const int r = i / bs, c = i - r * bs;
    prev_s[i] = prev_b[(size_t)r * Wc + c];
  }
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
    const int r = i / K, c = i - r * K;
    win_s[i] = curr_b[(size_t)r * Wp + c];
  }
  __syncthreads();

  const int DD = D * D;
  float* out_cell = out + (((size_t)b * nbh + t) * nbw + j) * (size_t)DD;
  for (int k = threadIdx.x; k < DD; k += blockDim.x) {
    const int dr = k / D, dc = k - dr * D;
    const uint8_t* q = win_s + dr * K + dc;
    int acc = 0;
    for (int r = 0; r < bs; ++r) {
      int p[kMaxBs];
#pragma unroll
      for (int c = 0; c < kMaxBs; ++c) p[c] = c < bs ? prev_s[r * bs + c] : 0;
      const uint8_t* qr = q + r * K;
#pragma unroll
      for (int c = 0; c < kMaxBs; ++c) {
        if (c < bs) {
          const int d = (int)qr[c] - p[c];
          acc += d * d;
        }
      }
    }
    out_cell[k] = (float)acc;
  }
}

}  // namespace

GME_API int gme_cost_volume_mse_block(const void* prev, const void* curr_pad,
                                      void* out, int B, int Hc, int Wc, int bs,
                                      int D, void* stream) {
  const int K = bs + D - 1;
  const dim3 grid(Wc / bs, Hc / bs, B);
  const size_t shared = (size_t)bs * bs * sizeof(int) + (size_t)K * K;
  cudaError_t err = gme_allow_shared(cost_volume_mse_block_kernel, shared);
  if (err != cudaSuccess) return err;
  cost_volume_mse_block_kernel<<<grid, kThreads, shared,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(curr_pad),
      static_cast<float*>(out), Hc, Wc, bs, D);
  return cudaGetLastError();
}
