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
// 1.3 MB at 256 x 1280), though at the probe's shapes, a few MB at most, one
// launch's fixed cost of some microseconds is larger than either.
//
// Design: one thread per output element in a grid-stride loop; the index
// and output accesses are coalesced, the source reads go where the indices
// point (through the read-only cache). The TPU's register-level gathers
// (per-lane sublane gather, per-sublane lane gather) have no counterpart
// here: a GPU thread loads any address.

#include <cuda_runtime.h>

#include <cmath>

namespace {

__global__ void __launch_bounds__(256)
probe_gather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                    float* __restrict__ out, int rows, int cols, int axis,
                    long long total) {
  const int extent = axis == 0 ? rows : cols;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int k = __ldg(idx + i);
    if (k < 0) k += extent;
    const long long r = i / cols;
    const long long c = i % cols;
    float v = nanf("");
    if (k >= 0 && k < extent) {
      v = __ldg(src + (axis == 0 ? k * static_cast<long long>(cols) + c
                                 : r * cols + k));
    }
    out[i] = v;
  }
}

}  // namespace

// src, idx, out (rows, cols): f32, int32, f32; axis 0 or 1.
extern "C" int sstem_probe_gather(const void* src, const void* idx, void* out,
                                  int rows, int cols, int axis, void* stream) {
  if (rows < 1 || cols < 1 || (axis != 0 && axis != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(rows) * cols;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  probe_gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols, axis, total);
  return static_cast<int>(cudaGetLastError());
}
