// Shared pieces of the port's bf16 convolution kernels (conv3x3_fused.cu,
// deconv2x_fused.cu, head_tail.cu) for Hopper (sm_90a).
//
// Each of those kernels is an implicit GEMM on warp-level tensor cores:
// M is a row of 16 output pixels, N the output channels, K the input
// channels of one filter tap; the taps are summed in the f32 accumulators.
// The operands sit in shared memory:
//
//   input tile  [pixel][KS]            bf16, KS = CIN_P + 8
//   weights     [tap][COUT_P][KS]      bf16, K (input channel) contiguous
//
// CIN_P and COUT_P are the channel counts padded to multiples of 16 with
// zeros (in shared memory only; device-memory tensors are never padded).
// The 8-element pad of each pixel's row makes consecutive pixels 16 bytes
// apart modulo 128, so the eight row addresses of one ldmatrix phase fall
// in distinct bank groups.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs, f32 sums),
// with g = lane / 4 and t = lane % 4:
//   A 16x16 row-major: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                      a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16x8:            c0, c1 (row g, cols 2t, 2t+1); c2, c3 (row g+8, ...)
// ldmatrix.x4 gives register i the 8x8 matrix whose row addresses lanes
// 8i..8i+7 supply, each thread holding row lane/4, elements 2(lane%4)..+1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sstem {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m] += A_m (16 pixels x CIN_P) @ W_tap (CIN_P x COUT_P) for the MB
// M-blocks of one warp. a_base points at the first pixel of M-block 0 in the
// input tile (channel 0); M-block m starts a_step elements further. w_tap
// points at the tap's [COUT_P][KS] weights. Each B fragment is loaded once
// and used by all MB blocks.
template <int CIN_P, int COUT_P, int MB>
__device__ __forceinline__ void mma_tap(float (&acc)[MB][COUT_P / 8][4],
                                        const bf16* a_base, int a_step,
                                        const bf16* w_tap, int lane) {
  constexpr int KS = CIN_P + 8;
  const bf16* a_row = a_base + (lane & 15) * KS + (lane >> 4) * 8;
  const bf16* b_row =
      w_tap + ((lane & 7) + ((lane >> 4) << 3)) * KS + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < CIN_P / 16; ++kk) {
    uint32_t a[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m) ldmatrix_x4(a[m], a_row + m * a_step + kk * 16);
#pragma unroll
    for (int np = 0; np < COUT_P / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + np * 16 * KS + kk * 16);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        mma_16816(acc[m][2 * np], a[m], b[0], b[1]);
        mma_16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

template <int MB, int NB>
__device__ __forceinline__ void zero(float (&acc)[MB][NB][4]) {
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
}

// Weights of `taps` taps from device memory, laid out [tap][cin][cout]
// (HWIO for a 3x3 conv), into shared [tap][COUT_P][KS], zero-padded: the
// COUT_P output channels from co0 on (a block that owns one slice of the
// output channels loads only that slice).
template <int CIN_P, int COUT_P>
__device__ void load_weights(bf16* w_s, const bf16* __restrict__ w, int taps,
                             int cin, int cout, int co0 = 0) {
  constexpr int KS = CIN_P + 8;
  const bf16 zero_v = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < taps * COUT_P * CIN_P; i += blockDim.x) {
    const int k = i % CIN_P;
    const int rest = i / CIN_P;
    const int co = co0 + rest % COUT_P;
    const int tap = rest / COUT_P;
    w_s[(tap * COUT_P + co - co0) * KS + k] =
        (k < cin && co < cout) ? w[(static_cast<size_t>(tap) * cin + k) * cout + co]
                               : zero_v;
  }
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// A tile of sh x sw pixels of an NHWC (n, h, w, c) bf16 tensor, whose top
// left is (ys, xs) in image b, into shared [pixel][KS]; pixels outside the
// image and channels >= c are zero. vec: c % 8 == 0 and the tensor is
// 16-byte aligned, so each thread moves 8 channels with one 16-byte load.
template <int CIN_P>
__device__ void load_tile(bf16* in_s, const bf16* __restrict__ x, int b, int ys,
                          int xs, int sh, int sw, int h, int w, int c,
                          bool vec) {
  constexpr int KS = CIN_P + 8;
  constexpr int CH = CIN_P / 8;
  for (int i = threadIdx.x; i < sh * sw * CH; i += blockDim.x) {
    const int c8 = i % CH;
    const int p = i / CH;
    const int gy = ys + p / sw;
    const int gx = xs + p % sw;
    Pack8 v;
    v.u = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w && c8 * 8 < c) {
      const bf16* src =
          x + ((static_cast<size_t>(b) * h + gy) * w + gx) * c + c8 * 8;
      if (vec) {
        v.u = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c8 * 8 + j < c) v.h[j] = src[j];
        }
      }
    }
    *reinterpret_cast<uint4*>(in_s + p * KS + c8 * 8) = v.u;
  }
}

// act: 0 none, 1 relu, 2 leaky relu (slope 0.2).
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v >= 0.f ? v : __fmul_rn(0.2f, v);
  return v;
}

// Up to two consecutive channels [co, co+1) of one NHWC pixel (row base p,
// cout channels): load as f32 (absent channels read 0) and store from f32.
__device__ __forceinline__ void load2(const bf16* p, int co, int cout,
                                      float& v0, float& v1) {
  v0 = v1 = 0.f;
  if (co + 1 < cout && (cout & 1) == 0) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p + co);
    v0 = __low2float(r);
    v1 = __high2float(r);
  } else {
    if (co < cout) v0 = __bfloat162float(p[co]);
    if (co + 1 < cout) v1 = __bfloat162float(p[co + 1]);
  }
}

__device__ __forceinline__ void store2(bf16* p, int co, int cout, float v0,
                                       float v1) {
  if (co + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + co) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (co < cout) p[co] = __float2bfloat16(v0);
    if (co + 1 < cout) p[co + 1] = __float2bfloat16(v1);
  }
}

// Blocks for a persistent launch: as many as fit on the card at once, and
// no more than there are tiles. Also raises the kernel's dynamic shared
// memory limit to smem.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

}  // namespace sstem
