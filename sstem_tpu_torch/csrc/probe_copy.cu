// Tile copy through shared memory, device memory -> shared -> device memory,
// for Hopper (sm_90a): the copy-bandwidth probe.
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
// Design: the array is taken as bytes. Blocks own slabs of `ty` rows (grid
// y); the slab's 16-byte-aligned middle is cut into 16 KB pieces, which the
// blocks of that slab (grid x) share round-robin. A piece goes into shared
// memory by cp.async (16-byte chunks, the L1-bypassing .cg variant), and
// the next piece's copy is in flight while the current one is written back
// (two stages, 32 KB). A slab whose ends are not 16-byte aligned copies its
// first and last bytes (at most 15 each) one at a time, also through shared
// memory. A TPU slab of 4 rows of 1280 x 128 bf16 is 1.3 MB, more than a
// block's shared memory, hence the pieces; a planar (64, 1280, 1280) array
// has only 16 slabs, hence several blocks per slab.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 16384;            // bytes per piece
constexpr int kChunks = kPiece / 16;     // 16-byte chunks per piece

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// chunks of piece p of the aligned range [a, b) into stage buffer dst
__device__ __forceinline__ void stage_piece(uint4* dst, const uint8_t* src,
                                            long long a, long long b,
                                            long long p) {
  const long long start = a + p * kPiece;
  const long long left = (b - start) / 16;
  const int chunks = left < kChunks ? static_cast<int>(left) : kChunks;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    cp_async16(dst + i, src + start + 16LL * i);
  }
}

__global__ void __launch_bounds__(kThreads)
probe_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  long long total, long long slab) {
  __shared__ __align__(16) uint4 buf[2][kChunks];
  __shared__ uint8_t bytes[32];
  const long long s0 = blockIdx.y * slab;
  const long long s1 = s0 + slab < total ? s0 + slab : total;
  long long a = (s0 + 15) / 16 * 16;
  if (a > s1) a = s1;
  long long b = s1 / 16 * 16;
  if (b < a) b = a;
  const long long pieces = (b - a + kPiece - 1) / kPiece;

  long long p = blockIdx.x;
  if (p < pieces) stage_piece(buf[0], src, a, b, p);
  cp_async_commit();
  for (int stage = 0; p < pieces; p += gridDim.x, stage ^= 1) {
    const long long next = p + gridDim.x;
    if (next < pieces) stage_piece(buf[stage ^ 1], src, a, b, next);
    cp_async_commit();
    cp_async_wait<1>();  // piece p has landed (this thread's chunks)
    __syncthreads();     // ... and every thread's
    const long long start = a + p * kPiece;
    const long long left = (b - start) / 16;
    const int chunks = left < kChunks ? static_cast<int>(left) : kChunks;
    uint4* out = reinterpret_cast<uint4*>(dst + start);
    for (int i = threadIdx.x; i < chunks; i += kThreads) out[i] = buf[stage][i];
    __syncthreads();  // the stage is free for the copy after next
  }
  cp_async_wait<0>();

  // the slab's unaligned head [s0, a) and tail [b, s1), byte by byte
  if (blockIdx.x == 0) {
    const int head = static_cast<int>(a - s0);
    const int tail = static_cast<int>(s1 - b);
    const int t = threadIdx.x;
    if (t < head) bytes[t] = src[s0 + t];
    else if (t >= 16 && t - 16 < tail) bytes[t] = src[b + t - 16];
    __syncthreads();
    if (t < head) dst[s0 + t] = bytes[t];
    else if (t >= 16 && t - 16 < tail) dst[b + t - 16] = bytes[t];
  }
}

}  // namespace

// x -> out, both `total` bytes, 16-byte aligned; slabs of `slab` bytes (ty
// rows of the array), with about 8 blocks per SM in all.
extern "C" int sstem_probe_copy(const void* x, void* out, long long total,
                                long long slab, void* stream) {
  if (total < 1 || slab < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slabs = (total + slab - 1) / slab;
  if (slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long gx = (8LL * sms + slabs - 1) / slabs;
  const long long most = (slab + kPiece - 1) / kPiece;  // pieces per slab
  if (gx > most) gx = most;
  if (gx < 1) gx = 1;
  probe_copy_kernel<<<dim3(static_cast<unsigned>(gx),
                           static_cast<unsigned>(slabs)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), total, slab);
  return static_cast<int>(cudaGetLastError());
}
