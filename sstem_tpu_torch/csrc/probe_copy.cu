// Tile copy for Hopper (sm_90a): the copy-bandwidth probe.
//
// Replaces the Pallas TPU kernel tools/probe_dma_conv.py::dma_copy (body
// copy_kernel): each grid step DMAs a slab of `ty` leading rows of the
// array into VMEM and writes it back out, to measure what bandwidth the
// TPU's DMA engine reaches for a given block layout.
//
// What bounds it on the H100: bytes. Every byte is read once and written
// once, at 3.35 TB/s: 0.25 ms for the 420 MB of a (1280, 1280, 128) bf16
// array.
//
// Design, chosen by measurement on the card (PERF.md §6, row 9): the array
// is taken as bytes; each thread moves one 16-byte chunk (a load by the
// read-only path with no L1 allocation, a streaming store), each block a
// contiguous 4 KB tile, and the grid has a block for every tile. The
// blocks resident at once then work on neighbouring tiles, so the reads
// and writes sweep the array in order. Designs that moved the data on the
// bulk copy engine (TMA cp.async.bulk loads into a ring of shared-memory
// stages and bulk stores out, one issuing thread a block) or that kept a
// persistent grid came out 1-18% slower than Tensor.copy_: a persistent
// grid whose blocks each walk a chunk of their own, or a grid-stride
// range, spreads the concurrent accesses over the whole array; one bulk
// piece a block on the same sweeping grid stayed 0.8-1.5% behind. The last
// total % 16 bytes go by byte loads and stores in block 0.
//
// The copy does not follow the TPU's slabs of `ty` rows: a slab is the
// TPU's block layout, not part of the function, and the wrapper only
// validates `ty`.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one 16-byte chunk a thread: 4 KB a block

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void store_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
probe_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  long long chunks, int tail) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < chunks) store_cs(dst + i, load_nc(src + i));
  // the bytes past the last whole chunk (at most 15)
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    reinterpret_cast<uint8_t*>(dst + chunks)[threadIdx.x] =
        reinterpret_cast<const uint8_t*>(src + chunks)[threadIdx.x];
  }
}

}  // namespace

// x -> out, both `total` bytes and 16-byte aligned.
extern "C" int sstem_probe_copy(const void* x, void* out, long long total,
                                void* stream) {
  if (total < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = total / 16;
  const long long blocks = chunks > 0 ? (chunks + kThreads - 1) / kThreads : 1;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  probe_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), chunks,
      static_cast<int>(total % 16));
  return static_cast<int>(cudaGetLastError());
}
