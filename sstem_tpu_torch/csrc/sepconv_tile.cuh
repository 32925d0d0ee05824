// Loads and stores shared by the sepconv forward (sepconv_fwd.cu) and
// backward (sepconv_bwd.cu): single values and runs of 4 adjacent pixels of
// a planar map, f32 or bf16 in memory, f32 in registers.

#pragma once

#include "hopper.cuh"

namespace sstem {
namespace sepconv {

constexpr int kKMax = 51;  // the most taps either kernel takes
constexpr int kRun = 4;    // pixels of one 16-byte (f32) or 8-byte (bf16) run

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Keeps a value that came from bf16 as an f32 register: without it the
// compiler may hold taps packed and redo the conversion before every FMA,
// which doubled the forward's inner loop.
__device__ __forceinline__ void pin(float& v) {
  asm volatile("mov.b32 %0, %0;" : "+f"(v));
}

// kRun values of a map at p (aligned to kRun elements) as f32
__device__ __forceinline__ void load_px(const float* p, float (&v)[kRun]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_px(const __nv_bfloat16* p,
                                        float (&v)[kRun]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
#pragma unroll
  for (int i = 0; i < kRun; ++i) pin(v[i]);
}

__device__ __forceinline__ void store_px(float* p, const float (&v)[kRun]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_px(__nv_bfloat16* p,
                                         const float (&v)[kRun]) {
  uint2 q;
  q.x = sstem::hopper::pack2u(v[0], v[1]);
  q.y = sstem::hopper::pack2u(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

}  // namespace sepconv
}  // namespace sstem
