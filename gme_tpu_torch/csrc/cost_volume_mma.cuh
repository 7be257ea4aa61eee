// The u8 tensor-core body of the block volumes at 8 <= bs <= 16: the cross
// term sum prev * curr on mma.sync, for one band of offset rows of one cell,
// with one of two epilogues.  Shared by cost_volume_mse_block.cu (SSD, one
// band: the whole cell, bs + D - 1 <= 128) and cost_volume_cross.cu (cross
// or SSD, bands of offset rows, any D).
//
// Contract of both kernels: prev (B, Hc, Wc) uint8, curr_pad (B, Hc+D-1,
// Wc+D-1) uint8 -> out (B, nbh, nbw, D*D) float32 with out[..., dr*D + dc]
// the block sum at window offset (dr, dc).  A CUDA block computes rows
// dr0 .. dr0+R-1 of one cell's (D, D) volume, every column: one contiguous
// run of R*D floats.
//
// Exactness: every sum is int32 from uint8 and is rounded to float32 once.
// At bs <= 16 the largest, 16 * 16 * 255^2 = 16,646,400, is below 2**24, so
// both epilogues are exact.
//
// Design: 8 warps, bs a template argument so that every loop over the block
// unrolls; at most 64 registers, so four blocks can share an SM.
// - The band's (bs+R-1) x (bs+D-1) window is staged in shared memory by
//   16-byte cp.async (4-byte, or byte loads, where the rows are less
//   aligned), its columns zero-padded to a row stride S, a multiple of 16 of
//   at least 8G + 24 (G = ceil(D / 8)).  The prev block is staged as rows of
//   48 bytes with 8 zero bytes before it and zeros after.
// - Cross term on mma.sync m16n8k32 u8 x u8 -> s32 (exact by construction).
//   For prev row r (one k = 32 step each, summed over the bs rows):
//     A[(dr, g), c'] = W[r + dr, 8g + c'],  c' in [0, 32), row m = dr*G + g
//     B[c', n]       = P[r, c' - n] if 0 <= c' - n < bs else 0,  n = dc - 8g
//   so (A B)[(dr, g), n] = sum_c P[r, c] W[r + dr, 8g + n + c], the row-r
//   cross term at offset (dr, 8g + n), dr counted from the band's first row.
//   M = R*G rows padded to 16, N = 8: 8G*D / D^2 of the MACs are spent on
//   columns dc >= D, and the 8-wide Toeplitz band of B is bs/32 nonzero, so
//   the tensor cores do about 2.2x the needed MACs at bs 16.  Padded rows
//   read row 0 and padded columns read the zero padding; neither is stored.
//   A lane's B fragment of row r is four consecutive bytes of the padded
//   prev row (one funnel shift of two words); the cell's 2*bs fragments
//   live in registers.  Each warp runs two m-tiles at a time (two
//   independent mma chains) and streams their A fragments from shared
//   memory with 32-bit loads.
// - Epilogue, cross: the int32 sum, as float, into a staged (R, D) result.
//   SSD: sum a^2 from column sums of the window's squares over bs rows (a
//   thread takes one 32-bit word of columns and 8 offsets, consecutive
//   threads consecutive words), then sliding sums over bs columns (16-byte
//   reads of a table whose stride is 4 mod 32 banks), int32 in shared
//   memory; sum b^2 from one block reduction; the mma epilogue forms
//   sum a^2 - 2 sum ab + sum b^2 in place in the staged result.
// - The band's R*D floats are one contiguous run (not 16-byte aligned, D is
//   odd).  The stage holds output f at index f + (first flat index mod 4),
//   so each aligned quad of the output is one 16-byte shared read and one
//   16-byte streaming store; the ragged ends are single floats.
#pragma once

#include "gme_kernels.cuh"

namespace gme_mma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPrevRow = 48;  // bytes of a zero-padded prev row: P[r][c] at 8 + c

// Row stride, in bytes, of the staged window: a multiple of 16 (16-byte
// cp.async) holding every A fragment read (columns up to 8G + 23).
__host__ __device__ inline int window_stride(int D) { return (8 * ((D + 7) / 8) + 24 + 15) & ~15; }

// Stride, in ints, of the column-sum table: at least K + 16 (the sliding
// pass reads whole 16-byte chunks past column K) and 4 mod 32, so that its
// 16-byte reads by consecutive rows fall in distinct banks.
__host__ __device__ inline int colsq_stride(int K) { return ((K + 16 + 27) & ~31) + 4; }

// Shared-memory layout of one CUDA block of at most Rb offset rows (byte
// offsets); the column-sum table only in SSD mode.
struct Layout {
  int stage, colsq, win, prev, total;
  __host__ __device__ Layout(int bs, int D, int Rb, bool ssd) {
    const int K = bs + D - 1;
    stage = 0;                                                   // Rb*D + 3 ints, to 4
    colsq = stage + 4 * ((Rb * D + 3 + 3) & ~3);                 // Rb x colsq_stride(K) ints
    win = colsq + (ssd ? 4 * Rb * colsq_stride(K) : 0);          // (bs+Rb-1) x S bytes
    prev = win + (bs + Rb - 1) * window_stride(D);               // bs x kPrevRow bytes
    total = prev + bs * kPrevRow;
  }
};

// floor(i / d) for 0 <= i < 2^22 and any d >= 1, with inv = 1.f / d: the
// quotient's fractional part is at least 0.5 / d, above the float error
// (i + 0.5) / d * 2^-23.
__device__ __forceinline__ int div_small(int i, float inv) {
  return __float2int_rz(((float)i + 0.5f) * inv);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// c += A (16x32 u8, row) x B (32x8 u8, col), s32 accumulate.
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows band*Rb .. of the (D, D) volume of cell (t, j) of pair b: the cross
// term (SSD false) or the SSD (SSD true), in the layout of Layout(BS, D, Rb,
// SSD), launched with kThreads threads.
template <int BS, bool SSD>
__device__ __forceinline__ void volume_band(
    const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
    float* __restrict__ out, int Hc, int Wc, int D, int Rb, int j, int t, int b, int band) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_sums[kWarps];
  const int dr0 = band * Rb, R = min(Rb, D - dr0);
  const int K = BS + D - 1, KR = BS + R - 1, G = (D + 7) / 8, S = window_stride(D);
  const int CS = colsq_stride(K);
  const Layout L(BS, D, Rb, SSD);
  int* stage = reinterpret_cast<int*>(smem + L.stage);  // the (R, D) result, from index lead
  int* colsq = reinterpret_cast<int*>(smem + L.colsq);  // (R, CS) column sums of a^2
  uint8_t* win = smem + L.win;                          // (KR, S) window
  uint32_t* prev_pad = reinterpret_cast<uint32_t*>(smem + L.prev);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbh = Hc / BS, nbw = Wc / BS;
  const int Hp = Hc + D - 1, Wp = Wc + D - 1;
  const uint8_t* prev_b = prev + ((size_t)b * Hc + (size_t)t * BS) * Wc + (size_t)j * BS;
  const uint8_t* curr_b =
      curr + ((size_t)b * Hp + (size_t)t * BS + dr0) * Wp + (size_t)j * BS;
  const size_t first = (((size_t)b * nbh + t) * nbw + j) * (size_t)D * D + (size_t)dr0 * D;
  const int n_out = R * D;
  const int lead = (int)(first & 3);  // stage[f + lead] holds output f: aligned quads match

  // Stage the window, zero past column K: 16-byte cp.async where the rows
  // are 16-byte aligned, 4-byte where 4-byte aligned, else byte loads.
  const uintptr_t align = reinterpret_cast<uintptr_t>(curr_b) | (uintptr_t)Wp;
  const int vec = (align & 15) == 0 ? 16 : 4;
  const bool async = (align & 3) == 0;
  const int Q = S / vec;
  const float invQ = 1.f / Q;
  for (int i = tid; i < KR * Q; i += kThreads) {
    const int y = div_small(i, invQ), x = vec * (i - y * Q);
    uint8_t* dst = win + y * S + x;
    const uint8_t* src = curr_b + (size_t)y * Wp + x;
    if (async && x + vec <= K) {
      cp_async(dst, src, vec);
    } else {
      for (int w = 0; w < vec; w += 4) {
        uint32_t word = 0;
        for (int k = 0; k < 4 && x + w + k < K; ++k) word |= (uint32_t)src[w + k] << (8 * k);
        *reinterpret_cast<uint32_t*>(dst + w) = word;
      }
    }
  }
  // The prev block as zero-padded rows of kPrevRow bytes, and sum b^2.
  int sq = 0;
  if (tid < BS * kPrevRow / 4) {
    const int r = tid / (kPrevRow / 4), q = tid - r * (kPrevRow / 4);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * q + k - 8;
      if (c >= 0 && c < BS) {
        const int v = prev_b[(size_t)r * Wc + c];
        word |= (uint32_t)v << (8 * k);
        sq += v * v;
      }
    }
    prev_pad[tid] = word;
  }
  if constexpr (SSD) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) warp_sums[warp] = sq;
  }
  cp_async_wait_all();
  __syncthreads();
  int sb2 = 0;
  if constexpr (SSD) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sb2 += warp_sums[w];

    // sum a^2, pass 1: colsq[dr][x] = sum_{r < bs} W[dr + r][x]^2 for 4
    // columns (one 32-bit word) and 8 offsets dr0.. a thread; consecutive
    // threads read consecutive words of a row.
    const int XQ = (K + 3) / 4, NC = (R + 7) / 8;
    const float invXQ = 1.f / XQ;
    for (int i = tid; i < XQ * NC; i += kThreads) {
      const int chunk = div_small(i, invXQ), xq = i - chunk * XQ, c0 = 8 * chunk;
      const int n = min(8, R - c0), rows = n + BS - 1;
      const uint8_t* w = win + c0 * S + 4 * xq;
      int sqr[BS + 7][4];
#pragma unroll
      for (int r = 0; r < BS + 7; ++r) {
        const uint32_t word = r < rows ? lds32(w + r * S) : 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = (word >> (8 * k)) & 255;
          sqr[r][k] = v * v;
        }
      }
      int s[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < BS; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] += sqr[r][k];
      int* dst = colsq + c0 * CS + 4 * xq;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < n) *reinterpret_cast<int4*>(dst + r * CS) = make_int4(s[0], s[1], s[2], s[3]);
        if (r + 1 < 8)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[k] += sqr[r + BS][k] - sqr[r][k];
      }
    }
    __syncthreads();
    // Pass 2: stage[lead + dr*D + dc] = sum_{c < bs} colsq[dr][dc + c] for 8
    // offsets dc0.. a thread; consecutive threads take consecutive rows.
    const float invR = 1.f / R;
    for (int i = tid; i < R * G; i += kThreads) {
      const int chunk = div_small(i, invR), dr = i - chunk * R, dc0 = 8 * chunk;
      const int4* src = reinterpret_cast<const int4*>(colsq + dr * CS + dc0);
      int v[(BS + 7 + 3) / 4 * 4];
#pragma unroll
      for (int q = 0; q < (BS + 7 + 3) / 4; ++q) {
        const int4 x = src[q];
        v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
      }
      int s = 0;
#pragma unroll
      for (int c = 0; c < BS; ++c) s += v[c];
      int* dst = stage + lead + dr * D + dc0;
      const int n = min(8, D - dc0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < n) dst[k] = s;
        if (k + 1 < 8) s += v[k + BS] - v[k];
      }
    }
  }

  // B fragments of every prev row: lane (gid, tig) holds k = 4 tig + e
  // (+16) of column n = gid, P[r][4 tig + e (+16) - gid] inside the band:
  // four bytes at offset 8 + 4 tig - gid (+16) of the padded row.
  const int gid = lane >> 2, tig = lane & 3;
  const int off = 8 + 4 * tig - gid, q0 = off >> 2, sh = 8 * (off & 3);
  uint32_t bf[BS][2];
#pragma unroll
  for (int r = 0; r < BS; ++r) {
    const uint32_t* row = prev_pad + r * (kPrevRow / 4) + q0;
    bf[r][0] = __funnelshift_r(row[0], row[1], sh);
    bf[r][1] = __funnelshift_r(row[4], row[5], sh);
  }
  if constexpr (SSD) __syncthreads();  // the box sums are staged

  // Two m-tiles a warp at a time (two independent mma chains); a tile past
  // the last reads row 0 and stores nothing.
  const int M = R * G, mtiles = (M + 15) / 16;
  const float invG = 1.f / G;
  for (int mt0 = warp; mt0 < mtiles; mt0 += 2 * kWarps) {
    int base[2][2], dr[2][2], g[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt0 + u * kWarps) * 16 + gid + 8 * h;
        dr[u][h] = div_small(m, invG);
        g[u][h] = m - dr[u][h] * G;
        base[u][h] = m < M ? dr[u][h] * S + 8 * g[u][h] + 4 * tig : 4 * tig;
      }
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int r = 0; r < BS; ++r) {
      const uint8_t* row = win + r * S;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t a[4] = {lds32(row + base[u][0]), lds32(row + base[u][1]),
                               lds32(row + base[u][0] + 16), lds32(row + base[u][1] + 16)};
        mma_u8(acc[u], a, bf[r][0], bf[r][1]);
      }
    }
    // Accumulator e of the lane: row gid (+8 for e >= 2), column 2 tig + (e & 1).
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, dc = 8 * g[u][h] + 2 * tig + (e & 1);
        if (dr[u][h] < R && dc < D) {
          int* p = stage + lead + dr[u][h] * D + dc;
          if constexpr (SSD)
            *p = __float_as_int((float)(*p - 2 * acc[u][e] + sb2));
          else
            *p = __float_as_int((float)acc[u][e]);
        }
      }
  }
  __syncthreads();

  // Store the band's R*D floats: 16-byte streaming stores of the aligned
  // quads (16-byte shared reads, since stage[s] holds output s - lead),
  // single floats at the ragged ends.
  float* dst = out + first;
  const float* res = reinterpret_cast<const float*>(stage);
  const int head = min((4 - lead) & 3, n_out);
  const int nvec = (n_out - head) / 4, tail = head + 4 * nvec;
  for (int i = tid; i < nvec; i += kThreads)
    __stcs(reinterpret_cast<float4*>(dst + head + 4 * i),
           *reinterpret_cast<const float4*>(res + lead + head + 4 * i));
  if (tid < head) dst[tid] = res[lead + tid];
  if (tid < 3 && tail + tid < n_out) dst[tail + tid] = res[lead + tail + tid];
}

}  // namespace gme_mma
