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
// What bounds it on the H100: bytes (src read once, out written once; 41 KB
// at 8 x 1280), far below one launch's fixed cost at the probe's shapes.
//
// Design: one thread per output element in a grid-stride loop; every
// thread loads the shift (one cached word) and its source element, so the
// reads stay coalesced except across the wrap-around point.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
probe_roll_kernel(const float* __restrict__ src, const int* __restrict__ shift,
                  float* __restrict__ out, int cols, long long total) {
  int s = __ldg(shift) % cols;
  if (s < 0) s += cols;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / cols;
    int c = static_cast<int>(i % cols) - s;
    if (c < 0) c += cols;
    out[i] = __ldg(src + r * cols + c);
  }
}

}  // namespace

// src, out (rows, cols) f32; shift one int32 on the device.
extern "C" int sstem_probe_roll(const void* src, const void* shift, void* out,
                                int rows, int cols, void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(rows) * cols;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  probe_roll_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(shift),
      static_cast<float*>(out), cols, total);
  return static_cast<int>(cudaGetLastError());
}
