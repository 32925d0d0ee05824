// Fused align-corners 2x bilinear upsample + 3x3 conv (stride 1, zero pad 1)
// + bias, the tail of each IFNet kernel head, for Hopper (sm_90a). bf16 NHWC
// half-resolution features in, bf16 planar (N, K, 2Hi, 2Wi) tap maps out,
// the layout the sepconv kernel reads.
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/head_tail.py::
// head_tail_fused (body _kernel) with dephase_transpose. Semantics:
//
//   up  = bf16(upsample2x_align_corners(x))     (f32 lerps, rounded once)
//   out = bf16(conv3x3(up, w3) + b3)            (f32 sums and bias)
//
// The upsampled values are rounded to bf16 before the conv, where the TPU
// kernel rounds its staged rows. The lerp is PyTorch's upsample_bilinear2d
// with align_corners=True: src = dst * (in - 1) / (out - 1) in f32, the
// second tap clamped at the last row and column.
//
// What bounds it on the H100: per head and group of 4 sections at 640^2 ->
// 1280^2 with K = 51 it reads 0.21 GB (64-channel features) and writes
// 0.67 GB of maps, ~0.26 ms, and does 4 x 76.7 GFLOP of conv at K padded to
// 64, ~0.31 ms on the tensor cores: operations bound it.
//
// Design: the implicit GEMM of conv3x3_fused.cu (conv_tile.cuh), with the
// upsample fused into the input-tile load: each block builds its 10 x 18
// upsampled pixels (the 8 x 16 output tile and its halo, zero outside the
// image) in shared memory from the half-resolution rows, so the full-
// resolution upsampled tensor never reaches device memory. The TPU kernel's
// phase split, lane rolls and phase-planar output existed for the TPU's
// (8, 128) tiling and are not carried over; any Hi, Wi >= 1 is taken.

#include "conv_tile.cuh"

namespace {

using sstem::bf16;

constexpr int kTH = 8;   // output rows per tile
constexpr int kTW = 16;  // output cols per tile (one M-block)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTH / kWarps;
constexpr int kSH = kTH + 2;
constexpr int kSW = kTW + 2;
constexpr int kCP = 64;  // channels (in and out) padded in shared memory

constexpr size_t kSmem =
    static_cast<size_t>(9 * kCP + kSH * kSW) * (kCP + 8) * sizeof(bf16);

struct Lerp {
  int i0, i1;    // the two source indices
  float l0, l1;  // their weights
};

// PyTorch's align_corners=True source index for output index o (o in range).
__device__ __forceinline__ Lerp lerp_taps(int o, int in, float scale) {
  const float src = scale * static_cast<float>(o);
  const int i0 = static_cast<int>(src);
  const int step = i0 < in - 1 ? 1 : 0;
  Lerp r;
  r.i0 = i0;
  r.i1 = i0 + step;
  r.l1 = src - static_cast<float>(i0);
  r.l0 = 1.f - r.l1;
  return r;
}

// The upsampled halo tile of output rows [ys, ys + kSH) and cols
// [xs, xs + kSW) into shared [pixel][kCP + 8]; zero outside the image and for
// channels >= cin. x is (n, hi, wi, cx) with cx >= cin channels.
__device__ void load_upsampled(bf16* in_s, const bf16* __restrict__ x, int b,
                               int ys, int xs, int hi, int wi, int cx, int cin,
                               float sy, float sx, bool vec) {
  constexpr int KS = kCP + 8;
  constexpr int CH = kCP / 8;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  for (int i = threadIdx.x; i < kSH * kSW * CH; i += blockDim.x) {
    const int c8 = i % CH;
    const int p = i / CH;
    const int oy = ys + p / kSW;
    const int ox = xs + p % kSW;
    sstem::Pack8 v;
    v.u = make_uint4(0, 0, 0, 0);
    if (oy >= 0 && oy < ho && ox >= 0 && ox < wo && c8 * 8 < cin) {
      const Lerp ly = lerp_taps(oy, hi, sy);
      const Lerp lx = lerp_taps(ox, wi, sx);
      const bf16* base = x + static_cast<size_t>(b) * hi * wi * cx + c8 * 8;
      const bf16* p00 = base + (static_cast<size_t>(ly.i0) * wi + lx.i0) * cx;
      const bf16* p01 = base + (static_cast<size_t>(ly.i0) * wi + lx.i1) * cx;
      const bf16* p10 = base + (static_cast<size_t>(ly.i1) * wi + lx.i0) * cx;
      const bf16* p11 = base + (static_cast<size_t>(ly.i1) * wi + lx.i1) * cx;
      sstem::Pack8 a, bb, c, d;
      if (vec) {
        a.u = __ldg(reinterpret_cast<const uint4*>(p00));
        bb.u = __ldg(reinterpret_cast<const uint4*>(p01));
        c.u = __ldg(reinterpret_cast<const uint4*>(p10));
        d.u = __ldg(reinterpret_cast<const uint4*>(p11));
      } else {
        a.u = bb.u = c.u = d.u = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c8 * 8 + j < cx) {
            a.h[j] = p00[j];
            bb.h[j] = p01[j];
            c.h[j] = p10[j];
            d.h[j] = p11[j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c8 * 8 + j < cin) {
          const float top = lx.l0 * __bfloat162float(a.h[j]) +
                            lx.l1 * __bfloat162float(bb.h[j]);
          const float bot = lx.l0 * __bfloat162float(c.h[j]) +
                            lx.l1 * __bfloat162float(d.h[j]);
          v.h[j] = __float2bfloat16(ly.l0 * top + ly.l1 * bot);
        }
      }
    }
    *reinterpret_cast<uint4*>(in_s + p * KS + c8 * 8) = v.u;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
head_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int hi, int wi, int cx, int cin, int k, int tiles_x,
                 int tiles_y, long long tiles, float sy, float sx, bool vec) {
  constexpr int KS = kCP + 8;
  constexpr int NB = kCP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* in_s = w_s + 9 * kCP * KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const size_t plane = static_cast<size_t>(ho) * wo;

  sstem::load_weights<kCP, kCP>(w_s, w, 9, cin, k);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = static_cast<int>(rest % tiles_y);
    const int b = static_cast<int>(rest / tiles_y);
    const int y0 = ty * kTH;
    const int x0 = tx * kTW;

    __syncthreads();
    load_upsampled(in_s, x, b, y0 - 1, x0 - 1, hi, wi, cx, cin, sy, sx, vec);
    __syncthreads();

    float acc[kRowsPerWarp][NB][4];
    sstem::zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      sstem::mma_tap<kCP, kCP, kRowsPerWarp>(
          acc, in_s + ((warp * kRowsPerWarp + dy) * kSW + dx) * KS, kSW * KS,
          w_s + tap * kCP * KS, lane);
    }

    bf16* img = out + static_cast<size_t>(b) * k * plane;
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int oy = y0 + warp * kRowsPerWarp + m;
      if (oy >= ho) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + g + half * 8;
        if (ox >= wo) continue;
        bf16* dst = img + static_cast<size_t>(oy) * wo + ox;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int co = nb * 8 + 2 * t + j;
            if (co < k) {
              dst[co * plane] = __float2bfloat16(
                  __fadd_rn(acc[m][nb][2 * half + j], __ldg(bias + co)));
            }
          }
        }
      }
    }
  }
}

}  // namespace

// x (n, hi, wi, cx) bf16 half-resolution features, of which the first cin
// channels are the conv's input; w (3, 3, cin, k) bf16 (HWIO); bias (k,)
// f32; out (n, k, 2hi, 2wi) bf16. cin <= cx <= 64 and k <= 64.
extern "C" int sstem_head_tail(const void* x, const void* w, const void* bias,
                               void* out, int n, int hi, int wi, int cx,
                               int cin, int k, void* stream) {
  if (n < 1 || hi < 1 || wi < 1 || cin < 1 || cx < cin || cx > kCP || k < 1 ||
      k > kCP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const int tiles_x = (wo + kTW - 1) / kTW;
  const int tiles_y = (ho + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t err = sstem::persistent_grid(head_tail_kernel, kWarps * 32,
                                           kSmem, tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  // align_corners scale, as PyTorch computes it: (in - 1) / (out - 1) in f32
  const float sy = static_cast<float>(hi - 1) / static_cast<float>(ho - 1);
  const float sx = static_cast<float>(wi - 1) / static_cast<float>(wo - 1);
  const bool vec = cx % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  head_tail_kernel<<<grid, kWarps * 32, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), hi, wi, cx, cin,
      k, tiles_x, tiles_y, tiles, sy, sx, vec);
  return static_cast<int>(cudaGetLastError());
}
