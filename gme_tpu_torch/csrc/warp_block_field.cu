// Block-constant warp of a uint8 frame with clipped sources.
//
// Replaces gme_tpu/ops/pallas_kernels.py:_warp_kernel (reached through
// warp_block_field): the motion compensation of the main path.  The TPU
// kernel selects rows and columns with one-hot matrix products because its
// vector unit cannot gather; on the H100 this is a plain gather.
//
// Contract: frame (B, H, W) uint8, d (B, nbh, nbw, 2) int32 with channel 0 the
// column shift and channel 1 the row shift -> out (B, nbh*bs, nbw*bs) uint8,
// out[r, c] = frame[clip(r - d[r/bs, c/bs, 1], 0, H-1),
//                   clip(c - d[r/bs, c/bs, 0], 0, W-1)].
// The out-of-bounds-keeps-original mask is the caller's
// (gme_tpu_torch/ops/warp.py compensate_frame), as in the JAX package.
//
// Bound on the H100: bytes, one frame read and one frame written per pair
// (0.9 MB each at 720p) plus the small field.  Design, for bs 4, 8, 12 and
// 16 (the main path's is 16): one thread per (pair, output row, cell) writes
// the cell's bs contiguous output bytes in the widest aligned stores (one
// 16-byte store at bs 16), after reading the cell's shift once.  A run whose
// source columns lie in the frame is bs contiguous source bytes: it is read
// as bs/4 + 1 aligned 4-byte words (the last only where the run is not
// 4-aligned) and funnel-shifted into place; a run that clips at the frame's
// left or right edge keeps the per-byte clamp.  Neighbouring threads write
// neighbouring cells of one row, so a warp stores 32 * bs contiguous bytes.
// Other block sizes take one thread per output byte.
#include "gme_kernels.cuh"

namespace {

constexpr int kThreads = 256;

// One thread per output byte: any block size.
__global__ void __launch_bounds__(kThreads) warp_block_field_kernel(
    const uint8_t* __restrict__ frame, const int* __restrict__ d,
    uint8_t* __restrict__ out, int H, int W, int nbh, int nbw, int bs) {
  const int cov_w = nbw * bs;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y, b = blockIdx.z;
  if (c >= cov_w) return;
  const int* dv = d + (((size_t)b * nbh + r / bs) * nbw + c / bs) * 2;
  const int sr = min(max(r - dv[1], 0), H - 1);
  const int sc = min(max(c - dv[0], 0), W - 1);
  out[((size_t)b * nbh * bs + r) * cov_w + c] =
      frame[((size_t)b * H + sr) * W + sc];
}

// One thread per (pair, output row, cell): the cell's BS bytes of that row.
template <int BS>
__global__ void __launch_bounds__(kThreads) warp_block_field_run_kernel(
    const uint8_t* __restrict__ frame, const int* __restrict__ d,
    uint8_t* __restrict__ out, int B, int H, int W, int nbh, int nbw) {
  static_assert(BS % 4 == 0 && BS <= 16, "a run is one to four 4-byte words");
  constexpr int kWords = BS / 4;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rows = (size_t)B * nbh * BS;  // output rows of the batch
  if (t >= rows * nbw) return;
  const int j = static_cast<int>(t % nbw);
  const size_t row = t / nbw;  // b * nbh * BS + r
  const int b = static_cast<int>(row / ((size_t)nbh * BS));
  const int r = static_cast<int>(row - (size_t)b * nbh * BS);
  const int* dv = d + (((size_t)b * nbh + r / BS) * nbw + j) * 2;
  const int shift_c = __ldg(dv), shift_r = __ldg(dv + 1);
  const uint8_t* src = frame + ((size_t)b * H + min(max(r - shift_r, 0), H - 1)) * W;
  const int c0 = j * BS - shift_c;  // source column of the run's first byte

  uint32_t w[kWords];
  bool in_frame = c0 >= 0 && c0 + BS <= W;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) + (in_frame ? c0 : 0);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
  const int misalign = static_cast<int>(addr & 3);
  // The aligned words must lie in the frame's buffer: the last one is read
  // only where the run is not 4-aligned.
  const uint8_t* frame_end = frame + (size_t)B * H * W;
  in_frame = in_frame && reinterpret_cast<const uint8_t*>(base) >= frame &&
             (misalign == 0 ||
              reinterpret_cast<const uint8_t*>(base + kWords + 1) <= frame_end);
  if (in_frame) {
    uint32_t v[kWords + 1];
#pragma unroll
    for (int i = 0; i < kWords; ++i) v[i] = __ldg(base + i);
    v[kWords] = misalign ? __ldg(base + kWords) : 0u;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __funnelshift_r(v[i], v[i + 1], 8 * misalign);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = min(max(c0 + 4 * i + q, 0), W - 1);
        x |= static_cast<uint32_t>(__ldg(src + c)) << (8 * q);
      }
      w[i] = x;
    }
  }

  // The run's offset, (row * nbw + j) * BS, is a multiple of BS, so these
  // stores are aligned (the output comes from the caching allocator).
  uint8_t* dst = out + (row * nbw + j) * BS;
  if constexpr (BS == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (BS == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
  }
}

template <int BS>
cudaError_t launch_runs(const uint8_t* frame, const int* d, uint8_t* out, int B,
                        int H, int W, int nbh, int nbw, cudaStream_t stream) {
  const size_t threads = (size_t)B * nbh * BS * nbw;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  warp_block_field_run_kernel<BS><<<blocks, kThreads, 0, stream>>>(frame, d, out, B, H,
                                                                    W, nbh, nbw);
  return cudaGetLastError();
}

}  // namespace

GME_API int gme_warp_block_field(const void* frame, const void* d, void* out,
                                 int B, int H, int W, int nbh, int nbw, int bs,
                                 void* stream) {
  const auto* f = static_cast<const uint8_t*>(frame);
  const auto* dv = static_cast<const int*>(d);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: return launch_runs<16>(f, dv, o, B, H, W, nbh, nbw, s);
    case 12: return launch_runs<12>(f, dv, o, B, H, W, nbh, nbw, s);
    case 8: return launch_runs<8>(f, dv, o, B, H, W, nbh, nbw, s);
    case 4: return launch_runs<4>(f, dv, o, B, H, W, nbh, nbw, s);
    default: break;
  }
  const dim3 grid((nbw * bs + kThreads - 1) / kThreads, nbh * bs, B);
  warp_block_field_kernel<<<grid, kThreads, 0, s>>>(f, dv, o, H, W, nbh, nbw, bs);
  return cudaGetLastError();
}
