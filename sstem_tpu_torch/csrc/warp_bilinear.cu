// Zero-border bilinear backward warp for Hopper (sm_90a), with the semantics
// of sstem_tpu/ops/warp.py::spatial_transform (the reference's
// SpatialTransformation, image_warp_torch.py:97-113).
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/warp_band.py::_kernel
// (launched by _band_call, reached from warp_band / serving_warp).
//
// For output pixel (gy, gx) with flow (dx, dy):
//   x = dx + gx + 1, y = dy + gy + 1          (coordinates in the padded image)
//   x1c = clip(floor(x) + 1, 0, W+1), x0c = clip(floor(x), 0, W+1)   (two clips)
//   wx = x1c - x  (uses the CLIPPED x1: leaves [0,1] far out of range)
//   padded pixel (py, px) = im[py-1, px-1] inside, 0 on the 1-pixel border
//   out = wx*wy*I(y0c,x0c) + wx*(1-wy)*I(y1c,x0c)
//       + (1-wx)*wy*I(y0c,x1c) + (1-wx)*(1-wy)*I(y1c,x1c)
// and likewise for y. This is not grid_sample's convention.
//
// What bounds it on the H100: 16 bytes of image, flow and output per pixel in
// streams, plus four gathered image reads that fold flows keep within a few
// rows of the pixel, so they hit L1/L2. Device-memory bandwidth bounds it;
// there is little arithmetic.
//
// Design: one thread per output pixel, consecutive threads on consecutive x,
// so the flow (read as one float2) and the output are coalesced. The 1-pixel
// zero border is a bounds test on the sample index: no padded copy of the
// image is made. The TPU kernel's row bands, interval lists, lane-gather
// composition and exactness envelope existed because the TPU lacks a general
// gather; a GPU thread gathers directly, so none of it is carried over and
// any flow and any H are exact. The arithmetic is written with explicit
// round-to-nearest intrinsics in the reference's order, so no FMA contraction
// changes the result.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float sample(const float* __restrict__ im, int h,
                                        int w, int py, int px) {
  return (py >= 1 && py <= h && px >= 1 && px <= w)
             ? __ldg(im + static_cast<size_t>(py - 1) * w + (px - 1))
             : 0.f;
}

__global__ void __launch_bounds__(256)
warp_bilinear_kernel(const float* __restrict__ im,
                     const float2* __restrict__ flow, float* __restrict__ out,
                     int n, int h, int w) {
  const size_t total = static_cast<size_t>(n) * h * w;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int gx = static_cast<int>(i % w);
  const size_t row = i / w;
  const int gy = static_cast<int>(row % h);
  const size_t b = row / h;
  const float* img = im + b * h * w;

  const float2 f = flow[i];
  const float x = __fadd_rn(__fadd_rn(f.x, static_cast<float>(gx)), 1.f);
  const float y = __fadd_rn(__fadd_rn(f.y, static_cast<float>(gy)), 1.f);
  // floor, then the reference's two clips; __float2int_rd saturates, and the
  // +1 is taken before the clip without overflowing at INT_MAX
  const int x0u = __float2int_rd(x);
  const int y0u = __float2int_rd(y);
  const int x1c = x0u >= w + 1 ? w + 1 : clip(x0u + 1, 0, w + 1);
  const int y1c = y0u >= h + 1 ? h + 1 : clip(y0u + 1, 0, h + 1);
  const int x0c = clip(x0u, 0, w + 1);
  const int y0c = clip(y0u, 0, h + 1);
  const float wx = __fsub_rn(static_cast<float>(x1c), x);
  const float wy = __fsub_rn(static_cast<float>(y1c), y);
  const float ux = __fsub_rn(1.f, wx);
  const float uy = __fsub_rn(1.f, wy);

  const float ia = sample(img, h, w, y0c, x0c);
  const float ib = sample(img, h, w, y1c, x0c);
  const float ic = sample(img, h, w, y0c, x1c);
  const float id = sample(img, h, w, y1c, x1c);
  float acc = __fmul_rn(__fmul_rn(wx, wy), ia);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wx, uy), ib));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ux, wy), ic));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ux, uy), id));
  out[i] = acc;
}

}  // namespace

extern "C" int sstem_warp_bilinear(const void* im, const void* flow, void* out,
                                   int n, int h, int w, void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(n) * h * w;
  const unsigned threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  warp_bilinear_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), static_cast<const float2*>(flow),
      static_cast<float*>(out), n, h, w);
  return static_cast<int>(cudaGetLastError());
}
