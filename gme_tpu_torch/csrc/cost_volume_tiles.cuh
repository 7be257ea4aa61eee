// Block-DFD volume in packed 4-byte words: the shared body of
// cost_volume_rowoffset.cu (MAE / MSE) and of cost_volume_cross.cu's cross
// term outside bs 8..16 and its SSD mode below bs 8.
//
// Contract of both kernels: prev (B, Hc, Wc) uint8 and curr_pad
// (B, Hc+D-1, Wc+D-1) uint8, where the window of offset index (dr, dc) is
// curr_pad[dr:dr+Hc, dc:dc+Wc]; out (B, nbh, nbw, D*D) float32 with
// out[..., dr*D + dc] the block sum at that offset.  Each sum is taken in
// 32-bit integers from the uint8 pixels and rounded to float32 once, so it
// is exact wherever the sum is below 2**24 and the correctly rounded integer
// sum above that.  The wrappers refuse block sizes whose sums could reach
// 2**31, so the unsigned __dp4a accumulators agree with int32.
//
// What binds on the H100: integer instructions.  A pixel term is a subtract,
// an abs or multiply and an add; __vabsdiffu4 and __dp4a do four of them in
// two instructions (term4), so the bound is half an instruction a term at
// the int32 rate (chip_smoke.work), where a byte-wise loop would spend
// about five issue slots a term (two shared byte loads, subtract, abs, add).
//
// Routes, by block size (launch_volume):
// - bs 1, 2, 4: the small-block body (cost_volume_small_block.cuh), which
//   packs a block row, or two rows at bs 2, into one word and writes four
//   outputs a thread in one 16-byte store: the output write binds there.
// - bs 3 and 5..32, packed register tiles (packed_tile).  A thread owns
//   kP x 4 offsets (rows x columns) of one cell in 16 registers.  It walks
//   the bs + kP - 1 window rows its tile meets; for each it loads W + 2
//   aligned words (W = ceil(bs / 4), a template argument, so the word loops
//   unroll), aligns them to its cell with one funnel shift a word, and
//   builds the four column-shifted runs with three more a word.  Every
//   offset row whose prev row lies in [0, bs) then takes one shared
//   (broadcast) load a prev word and four term4 on it, one a column.  At
//   bs 12 that is 164 instructions a window row for 192 terms.  The tail word of a block
//   row (bs % 4 != 0) is masked to 0 in the window; prev is staged with 0
//   there.  A CUDA block owns CW cells of one block row and a band of
//   RT x CT thread tiles, so no D is too large; it stages its prev blocks
//   and window rows in shared memory as words, a warp a row, with no
//   division per byte.  A thread finds its tile with one division and
//   writes four column offsets as one 16-byte store where the flat index is
//   a multiple of 4, one by one elsewhere; ragged offset tiles (D not a
//   multiple of the tile) are computed and not stored.
// - bs > 32 (to MAE 2901 / MSE 181): offset tiles that stage their pixels as
//   bytes, RC block rows at a time so no bs is too large, with the same
//   term4 on words read at any byte offset (two aligned loads and a funnel
//   shift).  No search reaches it; the tests do.
#pragma once

#include <type_traits>

#include "cost_volume_small_block.cuh"

namespace gme_vol {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// Packed register tiles, bs 3 and 5..32
// ---------------------------------------------------------------------------

constexpr int kP = 4;                 // offset rows a thread
constexpr int kQ = 4;                 // offset columns a thread: the bytes of a word
constexpr int kItems = 1024;          // thread tiles a CUDA block, about
constexpr int kBandTiles = 32;        // thread tiles along one side of a band, at most
constexpr size_t kPackedStage = 48 * 1024;

struct PackedPlan {
  int CW, RT, CT;        // cells, thread-tile rows and columns a CUDA block
  int n_cw, n_rb, n_cb;  // runs of cells, bands of tile rows and of tile columns
  int rows, rw;          // staged window rows, and words a staged row
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Near-equal bands of at most `most` of `n` tiles.
static inline int band(int n, int most) { return ceil_div(n, ceil_div(n, most)); }

static inline size_t packed_bytes(const PackedPlan& pl, int bs) {
  return sizeof(uint32_t) * ((size_t)pl.CW * bs * ceil_div(bs, 4) + (size_t)pl.rows * pl.rw);
}

static inline PackedPlan plan_packed(int Wc, int bs, int D) {
  PackedPlan pl;
  const int nr = ceil_div(D, kP), nc = ceil_div(D, kQ), nbw = Wc / bs;
  pl.CT = band(nc, kBandTiles);
  pl.RT = band(nr, kItems / pl.CT < 1 ? 1 : kItems / pl.CT);
  pl.CW = kItems / (pl.RT * pl.CT);
  pl.CW = pl.CW < 1 ? 1 : pl.CW > nbw ? nbw : pl.CW;
  for (;;) {
    pl.rows = bs + kP * pl.RT - 1;
    pl.rw = ((pl.CW - 1) * bs + kQ * (pl.CT - 1)) / 4 + ceil_div(bs, 4) + 2;
    if (pl.CW == 1 || packed_bytes(pl, bs) <= kPackedStage) break;
    pl.CW = ceil_div(pl.CW, 2);
  }
  pl.n_cw = ceil_div(nbw, pl.CW);
  pl.n_rb = ceil_div(nr, pl.RT);
  pl.n_cb = ceil_div(nc, pl.CT);
  return pl;
}

template <int W, int kMode>
__device__ __forceinline__ void packed_tile(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, const PackedPlan& pl) {
  extern __shared__ uint32_t packed_smem[];
  const int cb = blockIdx.x % pl.n_cb, rest = blockIdx.x / pl.n_cb;
  const int rb = rest % pl.n_rb, run = rest / pl.n_rb;
  const int t = blockIdx.y, b = blockIdx.z;
  const int nbh = Hc / bs, nbw = Wc / bs;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const int j0 = run * pl.CW, cw = min(pl.CW, nbw - j0);
  const int rt0 = rb * pl.RT, nrt = min(pl.RT, ceil_div(D, kP) - rt0);
  const int ct0 = cb * pl.CT, nct = min(pl.CT, ceil_div(D, kQ) - ct0);
  uint32_t* prev_s = packed_smem;                 // [cell][r][W], 0 past bs
  uint32_t* win_s = packed_smem + pl.CW * bs * W;  // [rows][rw], 0 outside curr_pad

  const uint8_t* prev_b = prev + ((size_t)b * Hc + (size_t)t * bs) * Wc + (size_t)j0 * bs;
  for (int i = threadIdx.x; i < cw * bs * W; i += kThreads) {
    const int row = i / W, k = i - row * W;  // row = cell * bs + r
    const int cell = row / bs, r = row - cell * bs;
    const uint8_t* src = prev_b + (size_t)r * Wc + cell * bs + 4 * k;
    const int nb = min(4, bs - 4 * k);
    uint32_t w = 0;
    for (int e = 0; e < nb; ++e) w |= (uint32_t)src[e] << (8 * e);
    prev_s[i] = w;
  }
  const int y0 = t * bs + kP * rt0, xs = j0 * bs + kQ * ct0;
  const uint8_t* curr_b = curr + (size_t)b * Hp * Wp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = warp; y < pl.rows; y += kWarps) {
    const uint8_t* src = curr_b + (size_t)(y0 + y) * Wp;
    uint32_t* dst = win_s + y * pl.rw;
    const bool in_rows = y0 + y < Hp;
    for (int m = lane; m < pl.rw; m += 32) {
      const int x = xs + 4 * m;
      uint32_t w = 0;
      if (in_rows && x + 3 < Wp) {
        w = (uint32_t)src[x] | (uint32_t)src[x + 1] << 8 | (uint32_t)src[x + 2] << 16 |
            (uint32_t)src[x + 3] << 24;
      } else if (in_rows) {
        for (int e = 0; x + e < Wp && e < 4; ++e) w |= (uint32_t)src[x + e] << (8 * e);
      }
      dst[m] = w;
    }
  }
  __syncthreads();

  const uint32_t tail = (bs & 3) ? (1u << (8 * (bs & 3))) - 1u : 0xffffffffu;
  const size_t DD = (size_t)D * D;
  const int items = cw * nrt * nct;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    // Consecutive threads take consecutive column tiles: adjacent stores.
    const int ct = it % nct, rest2 = it / nct;
    const int rt = rest2 % nrt, cell = rest2 / nrt;
    const int xb = cell * bs + kQ * ct;  // the tile's first window byte, from xs
    const uint32_t sh = 8u * (uint32_t)(xb & 3);
    const uint32_t* wrow = win_s + kP * rt * pl.rw + (xb >> 2);
    const uint32_t* pc = prev_s + cell * bs * W;
    unsigned acc[kP][kQ];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[p][q] = 0;

    for (int y = 0; y < bs + kP - 1; ++y, wrow += pl.rw) {
      // The window run of this row aligned to the cell (a), then shifted by
      // each column offset of the tile (s[q]).
      uint32_t a[W + 1];
      uint32_t lo = wrow[0];
#pragma unroll
      for (int k = 0; k <= W; ++k) {
        const uint32_t hi = wrow[k + 1];
        a[k] = __funnelshift_r(lo, hi, sh);
        lo = hi;
      }
      uint32_t s[kQ][W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        s[0][k] = a[k];
#pragma unroll
        for (int q = 1; q < kQ; ++q) s[q][k] = __funnelshift_r(a[k], a[k + 1], 8 * q);
      }
      if constexpr (kMode != kCross) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) s[q][W - 1] &= tail;
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int r = y - p;  // the prev row that window row y meets at offset row p
        if (r >= 0 && r < bs) {
          const uint32_t* pr = pc + r * W;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const uint32_t pw = pr[k];
#pragma unroll
            for (int q = 0; q < kQ; ++q) acc[p][q] = term4<kMode>(s[q][k], pw, acc[p][q]);
          }
        }
      }
    }

    const int dr0 = kP * (rt0 + rt), dc0 = kQ * (ct0 + ct);
    float* o = out + (((size_t)b * nbh + t) * nbw + j0 + cell) * DD + (size_t)dr0 * D + dc0;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (dr0 + p < D) {
        float* op = o + (size_t)p * D;
        if (dc0 + kQ <= D && (reinterpret_cast<uintptr_t>(op) & 15) == 0) {
          *reinterpret_cast<float4*>(op) = make_float4((float)acc[p][0], (float)acc[p][1],
                                                       (float)acc[p][2], (float)acc[p][3]);
        } else {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            if (dc0 + q < D) op[q] = (float)acc[p][q];
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch_packed(Kernel kernel, const uint8_t* prev, const uint8_t* curr, float* out,
                          int B, int Hc, int Wc, int bs, int D, cudaStream_t stream) {
  const PackedPlan pl = plan_packed(Wc, bs, D);
  const long long gx = (long long)pl.n_cw * pl.n_rb * pl.n_cb;
  if (gx > 0x7fffffffLL || Hc / bs > 65535 || B > 65535) return cudaErrorInvalidValue;
  const size_t shared = packed_bytes(pl, bs);
  cudaError_t err = gme_allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, Hc / bs, B), kThreads, shared, stream>>>(prev, curr, out, Hc, Wc,
                                                                        bs, D, pl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide blocks, bs > 32: offset tiles staged as bytes, RC block rows a chunk
// ---------------------------------------------------------------------------

constexpr int kPerThread = 8;
constexpr int kTileOffsets = 16;
constexpr size_t kStageBytes = 64 * 1024;
constexpr size_t kStageSlack = 8;  // the aligned word after a row's last byte

struct Tiles {
  int TR, TC;  // offsets per tile: rows, columns
  int CH, CW;  // cells per tile: rows, columns
  int RC;      // block rows staged per chunk
  int n_otr, n_otc, n_cth, n_ctw;  // tiles along each axis
};

// Shared-memory bytes of one chunk of RC rows for a CH x CW cell tile.
static inline size_t stage_bytes(int bs, int TR, int TC, int CH, int CW, int RC) {
  const size_t pw = (size_t)CW * bs;
  return (size_t)CH * ((size_t)RC * pw + (size_t)(RC + TR - 1) * (pw + TC - 1)) + kStageSlack;
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

// The four bytes at p..p+3 of shared memory, wherever p lies: two aligned
// loads and a funnel shift.
__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  return __funnelshift_r(w[0], w[1], 8u * (uint32_t)(a & 3));
}

template <int kMode>
__device__ __forceinline__ void volume_tile(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int bs, int D, const Tiles& tl) {
  extern __shared__ uint32_t tile_smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(tile_smem_words);
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
  const int full = bs & ~3;     // bytes of a block row in whole words
  const uint32_t tail = (1u << (8 * (bs & 3))) - 1u;
  const uint8_t* prev_b = prev + (size_t)b * Hc * Wc + (size_t)t0 * bs * Wc + (size_t)j0 * bs;
  const uint8_t* curr_b = curr + (size_t)b * Hp * Wp + (size_t)(t0 * bs + dr0) * Wp +
                          (size_t)j0 * bs + dc0;

  const size_t DD = (size_t)D * D;
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
    // A thread's outputs: up to kPerThread, each summed over the chunk and
    // carried to the next chunk in its own output slot as integer bits.
    for (int m = 0; m < kPerThread; ++m) {
      const int i = threadIdx.x + m * kThreads;
      if (i >= n_out) break;
      const int cell = i / offs, o = i - cell * offs;
      const int q = cell / cw, cj = cell - q * cw;
      const int dr = o / tc, dc = o - dr * tc;
      const uint8_t* p = prev_s + q * rc * pw + cj * bs;
      const uint8_t* w = win_s + (q * wr + dr) * ww + cj * bs + dc;
      unsigned s = 0;
      for (int r = 0; r < rc; ++r) {
        for (int c = 0; c < full; c += 4) s = term4<kMode>(word_at(w + c), word_at(p + c), s);
        if (bs & 3) s = term4<kMode>(word_at(w + full) & tail, word_at(p + full) & tail, s);
        p += pw;
        w += ww;
      }
      float* slot = out + (((size_t)b * nbh + t0 + q) * nbw + j0 + cj) * DD +
                    (size_t)(dr0 + dr) * D + dc0 + dc;
      if (r0 > 0) s += *reinterpret_cast<const unsigned*>(slot);
      if (r0 + rc < bs) *reinterpret_cast<unsigned*>(slot) = s;
      else *slot = (float)s;
    }
  }
}

template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, const uint8_t* prev, const uint8_t* curr, float* out,
                         int B, int Hc, int Wc, int bs, int D, cudaStream_t stream) {
  const Tiles tl = plan_tiles(Hc, Wc, bs, D);
  if (tl.RC < 1) return cudaErrorInvalidValue;
  const size_t shared = stage_bytes(bs, tl.TR, tl.TC, tl.CH, tl.CW, tl.RC);
  cudaError_t err = gme_allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)tl.n_otr * tl.n_otc * tl.n_cth * tl.n_ctw;
  if (n_tiles > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)n_tiles, B), kThreads, shared, stream>>>(prev, curr, out, Hc, Wc, bs, D,
                                                                    tl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The routes by block size
// ---------------------------------------------------------------------------

template <int N> using Int = std::integral_constant<int, N>;

// Launch the volume of a (B, Hc, Wc) batch at D x D offsets by the route of
// its block size: small_of(Int<BS>{}) gives the small-block kernel of
// bs 1, 2, 4, packed_of(Int<W>{}) the packed-tile kernel of W words a block
// row (bs 3, 5..32), and `wide` the kernel of bs > 32.
template <typename SmallOf, typename PackedOf, typename Wide>
cudaError_t launch_volume(SmallOf small_of, PackedOf packed_of, Wide wide, const uint8_t* p,
                          const uint8_t* c, float* o, int B, int Hc, int Wc, int bs, int D,
                          cudaStream_t s) {
  switch (bs) {
    case 1: return launch_small<1>(small_of(Int<1>{}), p, c, o, B, Hc, Wc, D, s);
    case 2: return launch_small<2>(small_of(Int<2>{}), p, c, o, B, Hc, Wc, D, s);
    case 4: return launch_small<4>(small_of(Int<4>{}), p, c, o, B, Hc, Wc, D, s);
    default: break;
  }
  switch (ceil_div(bs, 4)) {
    case 1: return launch_packed(packed_of(Int<1>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 2: return launch_packed(packed_of(Int<2>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 3: return launch_packed(packed_of(Int<3>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 4: return launch_packed(packed_of(Int<4>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 5: return launch_packed(packed_of(Int<5>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 6: return launch_packed(packed_of(Int<6>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 7: return launch_packed(packed_of(Int<7>{}), p, c, o, B, Hc, Wc, bs, D, s);
    case 8: return launch_packed(packed_of(Int<8>{}), p, c, o, B, Hc, Wc, bs, D, s);
    default: return launch_tiles(wide, p, c, o, B, Hc, Wc, bs, D, s);
  }
}

}  // namespace gme_vol
