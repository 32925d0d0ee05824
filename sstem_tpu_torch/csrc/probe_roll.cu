// Roll of a 2-D float32 array along axis 1 by a shift that lives on the
// device, for Hopper (sm_90a): the dynamic-shift roll probe.
//
// Replaces the Pallas TPU kernel tools/probe_gather.py::prim_roll (body k):
// pltpu.roll of a (rows, cols) block along its lanes by a shift read from
// SMEM, which in interpret mode equals jnp.roll:
//
//   out[i, j] = src[i, (j - shift) mod cols]
//
// The shift is read in the kernel from an int32 in device memory, so a
// caller never waits for it on the host (torch.roll takes a host int).
//
// What bounds it on the H100: bytes (src read once, out written once; 82 KB
// at 8 x 1280, 24 ns at 3.35 TB/s), far below one launch's fixed cost.
//
// Design: one block a row. The row is staged in shared memory by cp.async
// (16-byte copies where cols % 4 == 0, 4-byte ones for the rest) while
// thread 0 reads the shift once, reduces it mod cols with jnp.roll's sign
// rule and shares it through shared memory. Each thread then writes 4
// consecutive output columns with one 16-byte store (one column where
// cols % 4 != 0), reading their sources from the staged row with the wrap
// at cols as a compare, not a division. A row of up to kMaxCols columns
// fits (224 KB); the wrapper refuses longer rows on the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCols = 56 * 1024;  // a row in 224 KB of the 227
constexpr int kDefaultSmem = 48 * 1024;

using sstem::smem_addr;
using sstem::hopper::cp_async16;
using sstem::hopper::cp_async_ca;
using sstem::hopper::cp_async_commit;
using sstem::hopper::cp_async_wait;

// Grid (rows); block kThreads; dynamic shared memory: one row.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
probe_roll_kernel(const float* __restrict__ src,
                  const int* __restrict__ shift, float* __restrict__ out,
                  int cols) {
  extern __shared__ __align__(16) float row[];
  __shared__ int s_shift;
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  const uint32_t s = smem_addr(row);
  for (int g = threadIdx.x; g < cols / VEC; g += kThreads) {
    if constexpr (VEC == 4) {
      cp_async16(s + 16 * g, src + base + 4 * g, true);
    } else {
      cp_async_ca<4>(s + 4 * g, src + base + g, true);
    }
  }
  cp_async_commit();
  if (threadIdx.x == 0) {
    int m = *shift % cols;  // jnp.roll: (j - shift) mod cols, never negative
    if (m < 0) m += cols;
    s_shift = m;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int m = s_shift;
  for (int g = threadIdx.x; g < cols / VEC; g += kThreads) {
    int c = VEC * g - m;
    if (c < 0) c += cols;
    if constexpr (VEC == 4) {
      float4 v;
      v.x = row[c];
      if (++c == cols) c = 0;
      v.y = row[c];
      if (++c == cols) c = 0;
      v.z = row[c];
      if (++c == cols) c = 0;
      v.w = row[c];
      *reinterpret_cast<float4*>(out + base + 4 * g) = v;
    } else {
      out[base + g] = row[c];
    }
  }
}

template <int VEC>
cudaError_t launch(const float* src, const int* shift, float* out, int rows,
                   int cols, cudaStream_t stream) {
  const int smem = cols * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_roll_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  probe_roll_kernel<VEC><<<rows, kThreads, smem, stream>>>(src, shift, out,
                                                            cols);
  return cudaGetLastError();
}

}  // namespace

// src, out (rows, cols) f32, 16-byte aligned; shift one int32 on the device.
extern "C" int sstem_probe_roll(const void* src, const void* shift, void* out,
                                int rows, int cols, void* stream) {
  if (rows < 1 || cols < 1 || cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* s = static_cast<const float*>(src);
  const auto* sh = static_cast<const int*>(shift);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cols % 4 == 0 ? launch<4>(s, sh, o, rows, cols, st)
                                        : launch<1>(s, sh, o, rows, cols, st));
}
