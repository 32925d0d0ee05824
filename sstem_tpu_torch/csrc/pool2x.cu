// 2x2 stride-2 pooling, max or average, bf16 NHWC in and out, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/pool.py::pool2x_packed
// (body _kernel). Max is exact. Average sums the window in f32 in the TPU
// kernel's order, ((x00 + x01) + x10) + x11, scales by 0.25 and rounds once
// to bf16 (pool.py:88-91). An odd last row or column is dropped, as
// F.max_pool2d does.
//
// What bounds it on the H100: 32 channels at 4 x 1280^2 read 0.42 GB and
// write 0.10 GB with one operation per input value, so device-memory bytes
// (~0.16 ms).
//
// Design: one thread per output pixel and 8 channels; when C % 8 == 0 each
// of the four window pixels is one 16-byte load and the result one 16-byte
// store, neighbouring threads on neighbouring addresses. The TPU kernel's
// lane-selection matmuls, which re-packed the pixels into the next level's
// 128 lanes, are not carried over.

#include "conv_tile.cuh"

namespace {

using sstem::bf16;
using sstem::Pack8;

__global__ void __launch_bounds__(256)
pool2x_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int h, int w,
              int c, int ho, int wo, long long items, int is_max, bool vec) {
  const int c8s = (c + 7) / 8;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < items; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c8 = static_cast<int>(i % c8s);
    const long long pix = i / c8s;
    const int ox = static_cast<int>(pix % wo);
    const long long row = pix / wo;
    const int oy = static_cast<int>(row % ho);
    const long long b = row / ho;
    const bf16* src[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      src[q] = x + ((b * h + 2 * oy + (q >> 1)) * w + 2 * ox + (q & 1)) * c +
               c8 * 8;
    }
    bf16* dst = out + pix * c + c8 * 8;
    Pack8 v[4];
    if (vec) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q].u = __ldg(reinterpret_cast<const uint4*>(src[q]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q].u = make_uint4(0, 0, 0, 0);
        for (int j = 0; j < 8 && c8 * 8 + j < c; ++j) v[q].h[j] = src[q][j];
      }
    }
    Pack8 r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = __bfloat162float(v[0].h[j]);
      const float bb = __bfloat162float(v[1].h[j]);
      const float cc = __bfloat162float(v[2].h[j]);
      const float d = __bfloat162float(v[3].h[j]);
      if (is_max) {
        r.h[j] = __float2bfloat16(fmaxf(fmaxf(a, bb), fmaxf(cc, d)));
      } else {
        r.h[j] = __float2bfloat16(
            __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, bb), cc), d), 0.25f));
      }
    }
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = r.u;
    } else {
      for (int j = 0; j < 8 && c8 * 8 + j < c; ++j) dst[j] = r.h[j];
    }
  }
}

}  // namespace

// x (n, h, w, c) bf16 -> out (n, h/2, w/2, c) bf16 (floor); mode 0 avg, 1 max.
extern "C" int sstem_pool2x(const void* x, void* out, int n, int h, int w,
                            int c, int is_max, void* stream) {
  if (n < 1 || h < 2 || w < 2 || c < 1 || (is_max != 0 && is_max != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = h / 2;
  const int wo = w / 2;
  const long long items =
      static_cast<long long>(n) * ho * wo * ((c + 7) / 8);
  const int threads = 256;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (items + threads - 1) / threads;
  const long long most = static_cast<long long>(sms) * 16;
  const int blocks = static_cast<int>(want < most ? want : most);
  const bool vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  pool2x_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), h, w, c, ho, wo,
      items, is_max, vec);
  return static_cast<int>(cudaGetLastError());
}
