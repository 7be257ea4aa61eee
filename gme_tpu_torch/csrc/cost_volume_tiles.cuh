// Offset-tiled block-DFD volume: the shared body of cost_volume_rowoffset.cu
// (MAE / MSE) and of cost_volume_cross.cu's cross term sum prev * curr at
// block sizes outside 8..16.
//
// Contract of both kernels: prev (B, Hc, Wc) uint8 and curr_pad
// (B, Hc+D-1, Wc+D-1) uint8, where the window of offset index (dr, dc) is
// curr_pad[dr:dr+Hc, dc:dc+Wc]; out (B, nbh, nbw, D*D) float32 with
// out[..., dr*D + dc] the block sum at that offset.  Each sum is taken in
// int32 from the uint8 pixels and rounded to float32 once, so it is exact
// wherever the sum is below 2**24 (every block of the JAX dispatch) and the
// correctly rounded integer sum above that.  The wrappers refuse block sizes
// whose sums could overflow int32.
//
// Why tiles: these kernels take every shape the tensor-core and small-block
// volume kernels do not, from the bs = 2, D = 6 dense init of the exhaustive
// search to MAE at bs 20, D 65, and any D.  A CUDA block
// owns a tile of CH x CW cells and TR x TC offsets (at most kTileOffsets per
// side), so no D is too large.  It stages the tile's prev rows and the curr
// window they meet in shared memory, RC block rows at a time, so no bs is too
// large either (the staging stays under kStageBytes).  Each thread owns up to
// kPerThread outputs and keeps their sums in registers across the chunks.
// The tile's cell count is set so that a block has about
// kThreads * kPerThread outputs: one cell of 16 x 16 offsets fills a warp
// row at large D, and many cells share a block at small D, where the kernel
// is bound by its output writes.
#pragma once

#include "gme_kernels.cuh"

namespace gme_tiles {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTileOffsets = 16;
constexpr size_t kStageBytes = 64 * 1024;

enum Mode { kMae = 0, kMse = 1, kCross = 2 };

struct Tiles {
  int TR, TC;  // offsets per tile: rows, columns
  int CH, CW;  // cells per tile: rows, columns
  int RC;      // block rows staged per chunk
  int n_otr, n_otc, n_cth, n_ctw;  // tiles along each axis
};

// Shared-memory bytes of one chunk of RC rows for a CH x CW cell tile.
static inline size_t stage_bytes(int bs, int TR, int TC, int CH, int CW, int RC) {
  const size_t pw = (size_t)CW * bs;
  return (size_t)CH * ((size_t)RC * pw + (size_t)(RC + TR - 1) * (pw + TC - 1));
}

// The tile plan for a (B, Hc, Wc) volume of D x D offsets; RC = 0 when even a
// one-cell tile of one block row does not fit kStageBytes.
static inline Tiles plan_tiles(int Hc, int Wc, int bs, int D) {
  Tiles t;
  const int nbh = Hc / bs, nbw = Wc / bs;
  t.TR = D < kTileOffsets ? D : kTileOffsets;
  t.TC = t.TR;
  int cells = kThreads * kPerThread / (t.TR * t.TC);
  if (cells < 1) cells = 1;
  t.CW = cells < nbw ? cells : nbw;
  t.CH = cells / t.CW < nbh ? cells / t.CW : nbh;
  if (t.CH < 1) t.CH = 1;
  for (int attempt = 0; attempt < 2; ++attempt) {
    t.RC = bs;
    while (t.RC > 0 && stage_bytes(bs, t.TR, t.TC, t.CH, t.CW, t.RC) > kStageBytes) --t.RC;
    if (t.RC > 0) break;
    t.CH = t.CW = 1;
  }
  t.n_otr = (D + t.TR - 1) / t.TR;
  t.n_otc = (D + t.TC - 1) / t.TC;
  t.n_cth = (nbh + t.CH - 1) / t.CH;
  t.n_ctw = (nbw + t.CW - 1) / t.CW;
  return t;
}

template <int kMode>
__device__ __forceinline__ int pixel_term(int a, int b) {
  if constexpr (kMode == kMae) return abs(a - b);
  else if constexpr (kMode == kMse) return (a - b) * (a - b);
  else return a * b;
}

template <int kMode>
__device__ __forceinline__ void volume_tile(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, const Tiles& tl) {
  extern __shared__ uint8_t smem[];
  int tile = blockIdx.x;
  const int otc = tile % tl.n_otc;
  tile /= tl.n_otc;
  const int otr = tile % tl.n_otr;
  tile /= tl.n_otr;
  const int ctw = tile % tl.n_ctw;
  const int cth = tile / tl.n_ctw;
  const int b = blockIdx.y;
  const int nbh = Hc / bs, nbw = Wc / bs;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const int dr0 = otr * tl.TR, dc0 = otc * tl.TC;
  const int tr = min(tl.TR, D - dr0), tc = min(tl.TC, D - dc0);
  const int t0 = cth * tl.CH, j0 = ctw * tl.CW;
  const int ch = min(tl.CH, nbh - t0), cw = min(tl.CW, nbw - j0);
  const int pw = cw * bs;       // prev row width in the tile
  const int ww = pw + tc - 1;   // curr window row width
  const int offs = tr * tc;
  const int n_out = ch * cw * offs;
  const uint8_t* prev_b = prev + (size_t)b * Hc * Wc + (size_t)t0 * bs * Wc + (size_t)j0 * bs;
  const uint8_t* curr_b = curr + (size_t)b * Hp * Wp + (size_t)(t0 * bs + dr0) * Wp +
                          (size_t)j0 * bs + dc0;

  int acc[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) acc[m] = 0;

  for (int r0 = 0; r0 < bs; r0 += tl.RC) {
    const int rc = min(tl.RC, bs - r0);
    const int wr = rc + tr - 1;  // window rows per cell row
    uint8_t* prev_s = smem;               // [ch][rc][pw]
    uint8_t* win_s = smem + ch * rc * pw;  // [ch][wr][ww]
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < ch * rc * pw; i += kThreads) {
      const int c = i % pw, rq = i / pw;
      const int r = rq % rc, q = rq / rc;
      prev_s[i] = prev_b[(size_t)(q * bs + r0 + r) * Wc + c];
    }
    for (int i = threadIdx.x; i < ch * wr * ww; i += kThreads) {
      const int c = i % ww, rq = i / ww;
      const int r = rq % wr, q = rq / wr;
      win_s[i] = curr_b[(size_t)(q * bs + r0 + r) * Wp + c];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int i = threadIdx.x + m * kThreads;
      if (i < n_out) {
        const int cell = i / offs, o = i - cell * offs;
        const int q = cell / cw, cj = cell - q * cw;
        const int dr = o / tc, dc = o - dr * tc;
        const uint8_t* p = prev_s + q * rc * pw + cj * bs;
        const uint8_t* w = win_s + (q * wr + dr) * ww + cj * bs + dc;
        int s = 0;
        for (int r = 0; r < rc; ++r) {
          for (int c = 0; c < bs; ++c) s += pixel_term<kMode>(w[c], p[c]);
          p += pw;
          w += ww;
        }
        acc[m] += s;
      }
    }
  }

  const size_t DD = (size_t)D * D;
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int i = threadIdx.x + m * kThreads;
    if (i < n_out) {
      const int cell = i / offs, o = i - cell * offs;
      const int q = cell / cw, cj = cell - q * cw;
      const int dr = o / tc, dc = o - dr * tc;
      out[(((size_t)b * nbh + t0 + q) * nbw + j0 + cj) * DD + (size_t)(dr0 + dr) * D + dc0 + dc] =
          (float)acc[m];
    }
  }
}

// Launch `kernel` over the tiles of a (B, Hc, Wc) volume; returns the CUDA
// error code (cudaErrorInvalidValue when no tile fits shared memory).
template <typename Kernel, typename... Args>
static inline int launch_tiles(Kernel kernel, int B, int Hc, int Wc, int bs, int D,
                               void* stream, Args... args) {
  const Tiles tl = plan_tiles(Hc, Wc, bs, D);
  if (tl.RC < 1) return cudaErrorInvalidValue;
  const size_t shared = stage_bytes(bs, tl.TR, tl.TC, tl.CH, tl.CW, tl.RC);
  cudaError_t err = gme_allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)tl.n_otr * tl.n_otc * tl.n_cth * tl.n_ctw;
  if (n_tiles > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, B);
  kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(args..., tl);
  return cudaGetLastError();
}

}  // namespace gme_tiles
