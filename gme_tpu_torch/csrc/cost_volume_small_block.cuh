// Packed-word block volume for small blocks (bs 1, 2, 4): the body of
// cost_volume_small_block.cu, and of cost_volume_rowoffset.cu and
// cost_volume_cross.cu at those block sizes (their D < 8 shapes and the
// cross term), which take it through launch_small below.
//
// Contract: prev (B, Hc, Wc) uint8 and curr_pad (B, Hc+D-1, Wc+D-1) uint8,
// where the window of offset index (dr, dc) is curr_pad[dr:dr+Hc, dc:dc+Wc];
// out (B, nbh, nbw, D*D) float32, out[..., dr*D + dc] = the block sum of the
// pixel term (Mode) at that offset, in int32, rounded to float32 once.
// Nothing in the body depends on D beyond D >= 1.
//
// Design, for bytes in flight (the output write binds at these block sizes):
// - One CUDA block per run of T cells of one block row (T*D^2 about 8192
//   outputs), or, where one cell has more outputs than that (D > 90), per
//   band of R offset rows of one cell; either way its outputs are one
//   contiguous range of the volume.
// - The block stages its prev strip and curr window (the strip plus the
//   D-1 halo) in shared memory as packed 32-bit words, one per (block row,
//   offset): a bs = 2 block's four pixels in one word, one word per pixel
//   row at bs = 4, one byte at bs = 1.  An output is then one shared load
//   and term4 per word, exact in int32.
// - Each thread computes four consecutive flat outputs and writes them as
//   one 16-byte streaming store at a flat index that is a multiple of 4;
//   the at most 3 + 3 outputs before the first and after the last aligned
//   index of the range are stored one by one.  Consecutive threads take
//   consecutive quads: coalesced stores.
// - A thread carries (cell, dr, dc) of its quad from one quad to the next
//   by a fixed step, and across the quad's four outputs, with no division
//   per output.
#pragma once

#include "gme_kernels.cuh"

namespace gme_vol {

enum Mode { kMae = 0, kMse = 1, kCross = 2 };

// The pixel terms of one packed word, four bytes against four bytes, added
// to acc: |a - b| (MAE) or (a - b)^2 (MSE) in one __vabsdiffu4 and one
// __dp4a, a * b (cross) in one __dp4a.  Bytes that are 0 in both words add 0.
template <int kMode>
__device__ __forceinline__ unsigned term4(uint32_t a, uint32_t b, unsigned acc) {
  if constexpr (kMode == kCross) {
    return __dp4a(a, b, acc);
  } else {
    const unsigned d = __vabsdiffu4(a, b);
    return __dp4a(d, kMode == kMse ? d : 0x01010101u, acc);
  }
}

constexpr int kSmallThreads = 256;
constexpr int kSmallOutputs = 8192;  // outputs a CUDA block, about

// Window bytes packed into one 32-bit word per (block row, offset): a bs = 2
// block is one word (its two rows of two bytes); a bs = 4 block is four
// words, one per row; bs = 1 is one byte in a word.
template <int BS> struct Pack {
  static constexpr int kRows = BS == 2 ? 2 : 1;  // window rows in one word
  static constexpr int kWords = BS == 4 ? 4 : 1; // words per block
};

template <int BS>
__device__ __forceinline__ uint32_t pack(const uint8_t* p, size_t row) {
  uint32_t w = 0;
#pragma unroll
  for (int r = 0; r < Pack<BS>::kRows; ++r)
#pragma unroll
    for (int c = 0; c < BS; ++c) w |= (uint32_t)p[r * row + c] << (8 * (r * BS + c));
  return w;
}

// A CUDA block covers the offsets dr in [r0, r0 + nr) of tc cells of one
// block row: either several whole cells (nr = D) or, where one cell's D^2
// outputs are too many, one band of its offset rows.  Either way its
// outputs are one contiguous run of tc * nr * D floats.
template <int BS, int kMode>
__device__ __forceinline__ void small_block_volume(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int T, int R, int parts) {
  using P = Pack<BS>;
  extern __shared__ uint32_t small_smem[];
  const int nbh = Hc / BS, nbw = Wc / BS;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const int part = blockIdx.x % parts, j0 = (blockIdx.x / parts) * T;
  const int t = blockIdx.y, b = blockIdx.z;
  const int tc = min(T, nbw - j0), r0 = part * R, nr = min(R, D - r0);
  const int ph = nr + BS - P::kRows, pw = tc * BS + D - BS;  // packed window
  uint32_t* prev_w = small_smem;                             // tc * kWords
  uint32_t* win_w = small_smem + T * P::kWords;              // ph x pw
  const uint8_t* prev_b = prev + ((size_t)b * Hc + (size_t)t * BS) * Wc + (size_t)j0 * BS;
  const uint8_t* curr_b =
      curr + ((size_t)b * Hp + (size_t)t * BS + r0) * Wp + (size_t)j0 * BS;
  for (int i = threadIdx.x; i < tc * P::kWords; i += kSmallThreads) {
    const int cell = i / P::kWords, r = (i - cell * P::kWords) * P::kRows;
    prev_w[i] = pack<BS>(prev_b + (size_t)r * Wc + cell * BS, Wc);
  }
  for (int i = threadIdx.x; i < ph * pw; i += kSmallThreads) {
    const int y = i / pw, x = i - y * pw;
    win_w[i] = pack<BS>(curr_b + (size_t)y * Wp + x, Wp);
  }
  __syncthreads();

  const int DDc = nr * D, n = tc * DDc;  // outputs per cell here, and in all
  const size_t first =
      (((size_t)b * nbh + t) * nbw + j0) * (size_t)D * D + (size_t)r0 * D;
  float* dst = out + first;
  const int head = min(n, (int)((4 - first % 4) % 4));
  const int nq = (n - head) / 4, tail = head + 4 * nq;
  const int rstep = pw * P::kRows;  // words between block rows of a bs = 4 block

  // One output at (cell, dr, dc), dr counted from r0.
  auto dfd = [&](int cell, int dr, int dc) {
    const uint32_t* w = win_w + dr * pw + cell * BS + dc;
    const uint32_t* p = prev_w + cell * P::kWords;
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < P::kWords; ++k) acc = term4<kMode>(w[k * rstep], p[k], acc);
    return (float)acc;
  };

  // The ragged ends, one output each.
  const int tid = threadIdx.x;
  const int f1 = tid < head ? tid : tail + tid - head;
  if (tid < head + (n - tail)) {
    const int cell = f1 / DDc, rem = f1 - cell * DDc, dr = rem / D;
    dst[f1] = dfd(cell, dr, rem - dr * D);
  }

  // The aligned quads: (cell, dr, dc) of this thread's first output, carried
  // by the fixed step between its quads, and across the quad's outputs.
  const int step = 4 * kSmallThreads;
  const int s_cell = step / DDc, s_rem = step - s_cell * DDc;
  const int s_dr = s_rem / D, s_dc = s_rem - s_dr * D;
  const int f0 = head + 4 * tid;
  int cell = f0 / DDc, dr = (f0 - cell * DDc) / D, dc = f0 - cell * DDc - dr * D;
  for (int q = tid; q < nq; q += kSmallThreads) {
    float v[4];
    int ce = cell, re = dr, de = dc;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = dfd(ce, re, de);
      if (++de == D) {
        de = 0;
        if (++re == nr) re = 0, ++ce;
      }
    }
    __stcs(reinterpret_cast<float4*>(dst + head + 4 * q), make_float4(v[0], v[1], v[2], v[3]));
    dc += s_dc;
    if (dc >= D) dc -= D, ++dr;
    dr += s_dr;
    if (dr >= nr) dr -= nr, ++cell;
    cell += s_cell;
  }
}

// Launch `kernel` (a __global__ wrapper of small_block_volume<BS, kMode>)
// over a (B, Hc, Wc) volume of D x D offsets, about kSmallOutputs outputs a
// CUDA block: whole cells, or bands of R offset rows.
template <int BS, typename Kernel>
cudaError_t launch_small(Kernel kernel, const uint8_t* prev, const uint8_t* curr, float* out,
                         int B, int Hc, int Wc, int D, cudaStream_t stream) {
  using P = Pack<BS>;
  const int nbh = Hc / BS, nbw = Wc / BS;
  const int T = max(1, min(nbw, (kSmallOutputs + D * D - 1) / (D * D)));
  const int R = T > 1 ? D : min(D, (kSmallOutputs + D - 1) / D);
  const int parts = (D + R - 1) / R;
  const long long gx = (long long)((nbw + T - 1) / T) * parts;
  if (gx > 0x7fffffffLL || nbh > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, nbh, B);
  const size_t shared = sizeof(uint32_t) * ((size_t)T * P::kWords +
                                            (size_t)(R + BS - P::kRows) * (T * BS + D - BS));
  cudaError_t err = gme_allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kSmallThreads, shared, stream>>>(prev, curr, out, Hc, Wc, D, T, R, parts);
  return cudaGetLastError();
}

}  // namespace gme_vol
