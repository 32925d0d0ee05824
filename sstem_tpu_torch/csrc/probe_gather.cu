// take_along_axis of a 2-D float32 array by an int32 index array of the
// same shape, on axis 0 or 1, for Hopper (sm_90a): the gather probe.
//
// Replaces the Pallas TPU kernel tools/probe_gather.py::prim (body k):
// jnp.take_along_axis inside a kernel, which Mosaic lowers to
// tpu.dynamic_gather, the building block the TPU warp was made of.
//
//   axis 0: out[i, j] = src[idx[i, j], j]
//   axis 1: out[i, j] = src[i, idx[i, j]]
//
// Indices follow jnp.take_along_axis's default "fill" mode for a float
// array: one in [-extent, 0) counts from the end, one outside
// [-extent, extent) gives NaN.
//
// What bounds it on the H100: bytes (each of src, idx and out moved once;
// 3.9 MB at 256 x 1280, 1.2 us at 3.35 TB/s), though at the probe's shapes
// one launch's fixed cost of a few microseconds is larger.
//
// Design, two kernels, which the entry point picks by axis; each in a
// 16-byte form (4 columns a thread: an int4 index load, a float4 store)
// where cols % 4 == 0 and a one-column form for the rest. Neither divides:
// a thread's row and columns come from the block's place in the grid.
//   axis 0: a 2-D grid of 8-row bands by 32-group column tiles, one column
//     group a thread; the source reads, 4 rows apart at random, go through
//     the read-only path (the whole source sits in L2 at these shapes).
//   axis 1: one block a row. The row is staged in shared memory by cp.async
//     (16-byte copies in the 16-byte form) and the gather reads it there.
//     A row of up to kMaxStagedCols columns fits (224 KB); the wrapper
//     refuses longer rows on the card.
// The TPU's register-level gathers (per-lane sublane gather, per-sublane
// lane gather) have no counterpart here: a GPU thread loads any address.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBandRows = 8;      // axis 0: rows of a block
constexpr int kTileGroups = 32;   // axis 0: column groups of a block
constexpr int kRowThreads = 128;  // axis 1: threads of a block (one row)
constexpr int kMaxStagedCols = 56 * 1024;  // a row in 224 KB of the 227
constexpr int kDefaultSmem = 48 * 1024;

using sstem::smem_addr;
using sstem::hopper::cp_async16;
using sstem::hopper::cp_async_ca;
using sstem::hopper::cp_async_commit;
using sstem::hopper::cp_async_wait;

// jnp.take_along_axis's fill mode: k in [0, extent) as it is, k in
// [-extent, 0) plus extent, -1 (a NaN) for the rest.
__device__ __forceinline__ int fill_index(int k, int extent) {
  if (k < 0) k += extent;
  return k >= 0 && k < extent ? k : -1;
}

// element k of a column `col` whose rows are `stride` apart in device
// memory, read through the read-only path
__device__ __forceinline__ float from_global(const float* __restrict__ col,
                                            long long stride, int k,
                                            int extent) {
  k = fill_index(k, extent);
  return k < 0 ? __int_as_float(0x7fc00000) : __ldg(col + k * stride);
}

// element k of a row staged in shared memory
__device__ __forceinline__ float from_shared(const float* row, int k,
                                            int extent) {
  k = fill_index(k, extent);
  return k < 0 ? __int_as_float(0x7fc00000) : row[k];
}

// axis 0. Grid (row bands, column tiles); block (kTileGroups, kBandRows).
template <int VEC>
__global__ void __launch_bounds__(kTileGroups * kBandRows)
probe_gather_rows_kernel(const float* __restrict__ src,
                         const int* __restrict__ idx, float* __restrict__ out,
                         int rows, int cols) {
  const int r = blockIdx.x * kBandRows + threadIdx.y;
  const int c = (blockIdx.y * kTileGroups + threadIdx.x) * VEC;
  if (r >= rows || c >= cols) return;
  const long long at = static_cast<long long>(r) * cols + c;
  if constexpr (VEC == 4) {
    const int4 k = __ldg(reinterpret_cast<const int4*>(idx + at));
    float4 v;
    v.x = from_global(src + c, cols, k.x, rows);
    v.y = from_global(src + c + 1, cols, k.y, rows);
    v.z = from_global(src + c + 2, cols, k.z, rows);
    v.w = from_global(src + c + 3, cols, k.w, rows);
    *reinterpret_cast<float4*>(out + at) = v;
  } else {
    out[at] = from_global(src + c, cols, __ldg(idx + at), rows);
  }
}

// axis 1. Grid (rows); block kRowThreads; dynamic shared memory: one row.
template <int VEC>
__global__ void __launch_bounds__(kRowThreads)
probe_gather_cols_kernel(const float* __restrict__ src,
                         const int* __restrict__ idx, float* __restrict__ out,
                         int cols) {
  extern __shared__ __align__(16) float row[];
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  const uint32_t s = smem_addr(row);
  for (int g = threadIdx.x; g < cols / VEC; g += kRowThreads) {
    if constexpr (VEC == 4) {
      cp_async16(s + 16 * g, src + base + 4 * g, true);
    } else {
      cp_async_ca<4>(s + 4 * g, src + base + g, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int g = threadIdx.x; g < cols / VEC; g += kRowThreads) {
    const long long at = base + VEC * g;
    if constexpr (VEC == 4) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(idx + at));
      float4 v;
      v.x = from_shared(row, k.x, cols);
      v.y = from_shared(row, k.y, cols);
      v.z = from_shared(row, k.z, cols);
      v.w = from_shared(row, k.w, cols);
      *reinterpret_cast<float4*>(out + at) = v;
    } else {
      out[at] = from_shared(row, __ldg(idx + at), cols);
    }
  }
}

template <int VEC>
cudaError_t launch(const float* src, const int* idx, float* out, int rows,
                   int cols, int axis, cudaStream_t stream) {
  if (axis == 0) {
    const int groups = cols / VEC;
    const dim3 grid((rows + kBandRows - 1) / kBandRows,
                    (groups + kTileGroups - 1) / kTileGroups);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    probe_gather_rows_kernel<VEC>
        <<<grid, dim3(kTileGroups, kBandRows), 0, stream>>>(src, idx, out,
                                                             rows, cols);
    return cudaGetLastError();
  }
  if (cols > kMaxStagedCols) return cudaErrorInvalidValue;
  const int smem = cols * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_gather_cols_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  probe_gather_cols_kernel<VEC><<<rows, kRowThreads, smem, stream>>>(
      src, idx, out, cols);
  return cudaGetLastError();
}

}  // namespace

// src, idx, out (rows, cols): f32, int32, f32, 16-byte aligned; axis 0 or 1.
extern "C" int sstem_probe_gather(const void* src, const void* idx, void* out,
                                  int rows, int cols, int axis, void* stream) {
  if (rows < 1 || cols < 1 || (axis != 0 && axis != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* s = static_cast<const float*>(src);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cols % 4 == 0
                              ? launch<4>(s, i, o, rows, cols, axis, st)
                              : launch<1>(s, i, o, rows, cols, axis, st));
}
