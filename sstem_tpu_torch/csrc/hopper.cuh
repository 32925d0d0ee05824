// Hopper (sm_90a) building blocks of the port's implicit-GEMM kernels
// (conv3x3_fused.cu, deconv2x_fused.cu, head_tail.cu; sepconv_fwd.cu takes
// its cp.async): mbarriers, TMA loads and stores and their tensor maps,
// cp.async, the wgmma shared-memory descriptor and fence / commit / wait
// wrappers, and the warp-specialized mainloop of the two convolutions.
//
// Layouts (bf16; the wgmma operands in the "no swizzle" K-major canonical
// layout, whose 8 x 16-byte core matrices are 128 contiguous bytes):
//
//   input stage  [KG/8 chunk][halo pixel][8 channels]   16 B per pixel
//   weights      [tap][CIN_P/8 chunk][N][8 channels]    16 B per output ch
//   staging      Staging<N>: [box][pixel][<= 64 channels], swizzled
//
// The staged halo is HR rows of kPitch = 66 pixels (64 output columns and
// their two neighbours), one TMA box an 8-channel chunk. A wgmma A operand
// (M = 64 pixels x K = 16 channels) for output row r and tap (dy, dx) is
// then the 64 consecutive halo pixels from (r + dy) * 66 + dx: a plain
// address offset, every row 16 B after the last (SBO = 128 B between
// groups of 8 rows), the second 8-channel half one chunk further (LBO = the
// chunk stride). B (K = 16 x N) is the tap's weights from chunk 2kk on:
// SBO = 128 B between groups of 8 output channels, LBO = N * 16 B between
// the two 8-channel halves.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)

#include <type_traits>

#include "conv_tile.cuh"

namespace sstem {
namespace hopper {

constexpr int kTileW = 64;            // output columns per tile row (wgmma M)
constexpr int kPitch = kTileW + 2;    // staged halo pixels per row
constexpr int kConsumers = 2;                    // consumer warpgroups 0, 1
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp

// ---- mbarrier (PTX ISA 9.7.13.15) ----------------------------------------

// mbarrier.init.shared::cta.b64 [bar], count;
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// mbarrier.arrive.shared::cta.b64 _, [bar];
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// mbarrier.try_wait.parity.shared::cta.b64 p, [bar], parity; until p: wait
// for the completion of the barrier's phase with the given parity. A wait
// that has not completed after 2^26 tries (tens of seconds) traps, so a
// fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0;; ++tries) {
    if (tries == (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// ---- cp.async ------------------------------------------------------------

// cp.async.cg.shared.global [dst], [src], 16, src_size; -- 16 bytes from
// global to shared, bypassing L1; src_size 0 writes 16 zero bytes and reads
// nothing (the conv's zero padding and the channels past cin).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// cp.async.ca.shared.global [dst], [src], BYTES, src_size; -- 4, 8 or 16
// bytes from global to shared through L1; fill false writes zeros and
// reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool fill) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(fill ? BYTES : 0)
               : "memory");
}

// cp.async.commit_group; and cp.async.wait_group N;
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier.arrive.expect_tx.shared::cta.b64 _, [bar], bytes; -- one
// arrival that also expects `bytes` of asynchronous (TMA) transfers
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes
//     [dst], [tmap, {c0, c1, c2, c3}], [bar];
// -- one TMA box of the 4-D tensor map (coordinates innermost first, signed:
// a box that reaches past the tensor reads zeros there) into shared memory
// at dst (128-byte aligned); its bytes complete on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tmap,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// cp.async.bulk.tensor.4d.global.shared::cta.bulk_group
//     [tmap, {c0, c1, c2, c3}], [src];
// -- one TMA box from shared memory (src, 128-byte aligned; 1024 with a
// swizzle) into the tensor; the parts of the box past the tensor are not
// written. cp.async.bulk.commit_group; closes the thread's group;
// cp.async.bulk.wait_group.read 0; waits until its sources have been read.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* tmap,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(tmap)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// fence.proxy.async.shared::cta; -- shared-memory writes of the generic
// proxy (st.shared) become visible to the async proxy: wgmma's operand
// reads and TMA stores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync id, count; -- a barrier of one warpgroup (ids 1, 2, ...; 0 is
// __syncthreads)
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma (PTX ISA 9.7.15) ----------------------------------------------

// Shared-memory matrix descriptor, no swizzle (layout type 0, base offset
// 0): start address, leading (K) and stride (M or N) byte offsets, each in
// 16-byte units in bits 0-13, 16-29 and 32-45.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// wgmma.fence.sync.aligned; -- before the first wgmma of a group and after
// any other access to its accumulator registers
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// wgmma.commit_group.sync.aligned;
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wgmma.wait_group.sync.aligned N;
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading accumulators before wgmma_wait (emits
// no instruction)
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w..16w+15; with g = lane / 4, t = lane % 4, register 4i + j holds row
// 16w + g + 8 (j / 2), column 8i + 2t + (j % 2).

// D (64 x 24, f32) += A (64 x 16) . B (16 x 24), both bf16 in shared
// memory, K-major, through descriptors (conv3x3's narrow_out design: the
// three row taps x 8 output channels):
//   wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16
//       {d0..d11}, desc_a, desc_b, p (scale-d = 1), 1, 1, 0, 0;
__device__ __forceinline__ void wgmma_m64k16(float (&d)[12], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16) . B (16 x 32), both bf16 in shared
// memory, K-major, through descriptors:
//   wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16
//       {d0..d15}, desc_a, desc_b, p (scale-d = 1), 1, 1, 0, 0;
__device__ __forceinline__ void wgmma_m64k16(float (&d)[16], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 56, f32) += A (64 x 16) . B (16 x 56), both bf16 in shared
// memory, K-major, through descriptors (the head tail's K = 51 outputs):
//   wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16
//       {d0..d27}, desc_a, desc_b, p (scale-d = 1), 1, 1, 0, 0;
__device__ __forceinline__ void wgmma_m64k16(float (&d)[28], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), both bf16 in shared
// memory, K-major, through descriptors:
//   wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16
//       {d0..d31}, desc_a, desc_b, p (scale-d = 1), 1, 1, 0, 0;
__device__ __forceinline__ void wgmma_m64k16(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), both bf16 in shared
// memory, K-major, through descriptors:
//   wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16
//       {d0..d63}, desc_a, desc_b, p (scale-d = 1), 1, 1, 0, 0;
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


// The register-A forms (conv3x3's narrow_in design builds its A operand,
// an im2col of the staged halo, in registers).

// D (64 x 8, f32) += A (64 x 16, bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 8, bf16 in shared memory,
// K-major, through its descriptor):
//   wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16
//       {d0..d3}, {a0..a3}, desc_b, p (scale-d = 1), 1, 1, 0;
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 32, bf16 in shared memory,
// K-major, through its descriptor):
//   wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16
//       {d0..d15}, {a0..a3}, desc_b, p (scale-d = 1), 1, 1, 0;
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . B (16 x 64, bf16 in shared memory,
// K-major, through its descriptor):
//   wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16
//       {d0..d31}, {a0..a3}, desc_b, p (scale-d = 1), 1, 1, 0;
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- the staging ring ----------------------------------------------------

// One stage: KG input channels of HR halo rows, [KG/8][HR * kPitch][8],
// one TMA box per 8-channel chunk; the chunk stride is the box's bytes
// rounded up to the 128 bytes a TMA destination is aligned to.
template <int KG, int HR>
struct Stage {
  static constexpr int kChunks = KG / 8;
  static constexpr int kPixels = HR * kPitch;
  static constexpr int kBoxBytes = kPixels * 16;
  static constexpr int kChunkBytes = (kBoxBytes + 127) / 128 * 128;
  static constexpr int kBytes = kChunks * kChunkBytes;
};

// Issues the TMA boxes of one stage: channels [c0, c0 + KG) of the halo
// whose top left is (ys, xs) in image b, completing on bar. Pixels outside
// the image and channels >= cin read as zeros (the conv's zero padding).
template <int KG, int HR>
__device__ __forceinline__ void load_stage(uint32_t stage, const CUtensorMap* tmap,
                                           int b, int ys, int xs, int c0,
                                           uint64_t* bar) {
  using S = Stage<KG, HR>;
  mbar_arrive_expect_tx(bar, S::kChunks * S::kBoxBytes);
#pragma unroll
  for (int c = 0; c < S::kChunks; ++c) {
    tma_load_4d(stage + c * S::kChunkBytes, tmap, c0 + 8 * c, xs, ys, b, bar);
  }
}

// The tensor map of an NHWC bf16 tensor (cin % 8 == 0, 16-byte aligned)
// with boxes of 8 channels x kPitch pixels x rows rows of one image: 16
// bytes per pixel, so a box lands as one [pixel][8] chunk of a stage.
// cuTensorMapEncodeTiled comes from the driver through the runtime's entry
// point query, so nothing links against libcuda.
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encoder(Encode* out) {
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

inline cudaError_t make_tensor_map(CUtensorMap* map, const void* x, int n,
                                   int h, int w, int cin, int rows) {
  Encode encode = nullptr;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                 static_cast<cuuint64_t>(w) * cin * 2,
                                 static_cast<cuuint64_t>(h) * w * cin * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(kPitch),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of an NHWC bf16 output (cout % 8 == 0) with boxes of
// `box` channels (32 or 64, 64- or 128-byte swizzled) x `px` pixels of one
// row, matching Staging<N>.
inline cudaError_t make_out_map(CUtensorMap* map, const void* y, int n, int h,
                                int w, int cout, int box, int px) {
  Encode encode = nullptr;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cout),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cout) * 2,
                                 static_cast<cuuint64_t>(w) * cout * 2,
                                 static_cast<cuuint64_t>(h) * w * cout * 2};
  const cuuint32_t boxd[4] = {static_cast<cuuint32_t>(box),
                              static_cast<cuuint32_t>(px), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(y), dims,
      strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Weights [taps][cin][cout] (HWIO) into shared [tap][CIN_P/8][N][8], the
// N output channels from co0 on; zero past cin and cout.
template <int CIN_P, int N>
__device__ void load_weights_kmajor(bf16* w_s, const bf16* __restrict__ w, int taps,
                             int cin, int cout, int co0) {
  const bf16 zero_v = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < taps * CIN_P * N; i += blockDim.x) {
    const int e = i % 8;
    int rest = i / 8;
    const int n = rest % N;
    rest /= N;
    const int k = (rest % (CIN_P / 8)) * 8 + e;
    const int tap = rest / (CIN_P / 8);
    const int co = co0 + n;
    w_s[i] = (k < cin && co < cout)
                 ? w[(static_cast<size_t>(tap) * cin + k) * cout + co]
                 : zero_v;
  }
}

// The output staging of a warpgroup: `rows` pixels x N channels, dense, as
// the TMA boxes of the output's tensor map want them: boxes of B = min(N,
// 64) channels, box k holding channels [kB, kB + B) of all the pixels, its
// 16-byte chunks swizzled (128-byte swizzle for B = 64, 64-byte for B =
// 32) so that an accumulator fragment's 8 rows land in distinct banks.
template <int N>
struct Staging {
  static constexpr int kBox = N > 64 ? 64 : N;  // channels per box
  static constexpr int kRowBytes = kBox * 2;
  // byte offset of channel ch of pixel p, `rows` pixels in a box
  __device__ __forceinline__ static int offset(int rows, int p, int ch) {
    const int box = ch / kBox;
    const int chunk = (ch % kBox) / 8;
    const int sw = kBox == 64 ? (p & 7) : ((p >> 1) & 3);
    return box * rows * kRowBytes + p * kRowBytes + ((chunk ^ sw) << 4) +
           (ch % 8) * 2;
  }
};

// Rows of device memory into a warpgroup's staging (the residual): px
// pixels of nc channels at src, pixel stride cout; with cout % 8 == 0 in
// 16-byte cp.async pieces, else one bf16 at a time.
template <int N>
__device__ __forceinline__ void global_to_staging(unsigned char* st, int rows,
                                                  const bf16* src, int px,
                                                  int nc, int cout, int wt) {
  if (cout % 8 == 0) {
    const int n8 = nc / 8;
    for (int v = wt; v < px * n8; v += 128) {
      const int p = v / n8;
      const int c = v % n8;
      cp_async16(smem_addr(st + Staging<N>::offset(rows, p, c * 8)),
                 src + static_cast<size_t>(p) * cout + c * 8, true);
    }
  } else {
    for (int v = wt; v < px * nc; v += 128) {
      const int p = v / nc;
      const int c = v % nc;
      *reinterpret_cast<bf16*>(st + Staging<N>::offset(rows, p, c)) =
          src[static_cast<size_t>(p) * cout + c];
    }
  }
}

// The staging out to device memory one bf16 at a time (cout % 8 != 0,
// which no tensor map takes).
template <int N>
__device__ __forceinline__ void staging_to_global(bf16* dst,
                                                  const unsigned char* st,
                                                  int rows, int px, int nc,
                                                  int cout, int wt) {
  for (int v = wt; v < px * nc; v += 128) {
    const int p = v / nc;
    const int c = v % nc;
    dst[static_cast<size_t>(p) * cout + c] =
        *reinterpret_cast<const bf16*>(st + Staging<N>::offset(rows, p, c));
  }
}

// The epilogue's per-channel scale and shift for the thread's accumulator
// columns 8i + 2t and 8i + 2t + 1, in registers, loaded once a block.
template <int N>
struct Affine {
  float2 scale[N / 8], shift[N / 8];
  __device__ __forceinline__ void load(const float* sc, const float* sh,
                                       int t) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      scale[i] = make_float2(sc[8 * i + 2 * t], sc[8 * i + 2 * t + 1]);
      shift[i] = make_float2(sh[8 * i + 2 * t], sh[8 * i + 2 * t + 1]);
    }
  }
};

__device__ __forceinline__ float2 unpack2(const unsigned char* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

// The epilogue's variants, compile-time: act (0 none, 1 relu, 2 leaky 0.2)
// and the residual mode. Runtime tests of both inside the per-element math
// cost more than the math. dispatch_epilogue(act, res_mode, f) calls
// f(Int<act>, Int<res_mode>) once.
template <int V>
using Int = std::integral_constant<int, V>;

template <int ACT>
__device__ __forceinline__ float activate_c(float v) {
  if (ACT == 1) return fmaxf(v, 0.f);
  if (ACT == 2) return v >= 0.f ? v : __fmul_rn(0.2f, v);
  return v;
}

template <class F>
__device__ __forceinline__ void dispatch_epilogue(int act, int res_mode, F f) {
  switch (act * 3 + res_mode) {
    case 0: f(Int<0>{}, Int<0>{}); break;
    case 1: f(Int<0>{}, Int<1>{}); break;
    case 2: f(Int<0>{}, Int<2>{}); break;
    case 3: f(Int<1>{}, Int<0>{}); break;
    case 4: f(Int<1>{}, Int<1>{}); break;
    case 5: f(Int<1>{}, Int<2>{}); break;
    case 6: f(Int<2>{}, Int<0>{}); break;
    case 7: f(Int<2>{}, Int<1>{}); break;
    default: f(Int<2>{}, Int<2>{}); break;
  }
}

// two floats as a bf16 pair (round to nearest even), a in the low half
__device__ __forceinline__ uint32_t pack2u(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}


// One output row of a warpgroup's tile, from its accumulators d (the
// m64nN layout above) for pixels m0..m0+63 of the staging (`rows` pixels
// a box): the residual pairs the caller staged there read first (RES 1:
// added before the affine, 2: after it), then the math in f32 in the plain
// version's order, then the bf16 pairs written over them.
template <int N, int ACT, int RES>
__device__ __forceinline__ void finish_row(const float (&d)[N / 2],
                                           unsigned char* staging, int rows,
                                           int m0, int warp, int g, int t,
                                           const Affine<N>& aff) {
  auto at = [&](int i, int half) {
    return staging + Staging<N>::offset(rows, m0 + warp * 16 + g + 8 * half,
                                        8 * i + 2 * t);
  };
  float2 rv[N / 8][2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      rv[i][half] = RES ? unpack2(at(i, half)) : make_float2(0.f, 0.f);
  uint32_t pk[N / 8][2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[2] = {d[4 * i + 2 * half], d[4 * i + 2 * half + 1]};
      const float rs[2] = {rv[i][half].x, rv[i][half].y};
      const float scj[2] = {aff.scale[i].x, aff.scale[i].y};
      const float shj[2] = {aff.shift[i].x, aff.shift[i].y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float y = v[j];
        if (RES == 1) y = __fadd_rn(y, rs[j]);
        y = __fadd_rn(__fmul_rn(y, scj[j]), shj[j]);
        if (RES == 2) y = __fadd_rn(y, rs[j]);
        v[j] = activate_c<ACT>(y);
      }
      pk[i][half] = pack2u(v[0], v[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(at(i, half)) = pk[i][half];
}

// The R finished rows of a warpgroup's tile (image b, rows y0.., columns
// x0..; output channels co0.., nc of the cout) out of its staging into
// device memory; the warpgroup's 128 threads (thread index wt) meet at
// named barrier `bar`. Where cout % 8 == 0, one TMA store a row and
// channel box (rows past h skipped, the box clipped at the right edge;
// the caller waits for their reads before it writes the staging again),
// else staging_to_global.
template <int N, int R>
__device__ __forceinline__ void store_rows(const CUtensorMap* omap,
                                           unsigned char* staging, bf16* out,
                                           int b, int y0, int x0, int h,
                                           int wd, int cout, int co0, int nc,
                                           int bar, int wt) {
  constexpr int kPx = R * kTileW;
  if (cout % 8 == 0) {
    fence_proxy_async();
    named_bar(bar, 128);
    if (wt == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (y0 + r >= h) continue;
#pragma unroll
        for (int k = 0; k < N / Staging<N>::kBox; ++k) {
          tma_store_4d(omap,
                       staging + Staging<N>::offset(kPx, r * kTileW,
                                                    k * Staging<N>::kBox),
                       co0 + k * Staging<N>::kBox, x0, y0 + r, b);
        }
      }
      bulk_commit();
    }
  } else {
    named_bar(bar, 128);
    const int px = min(kTileW, wd - x0);
    for (int r = 0; r < R; ++r) {
      if (y0 + r >= h) continue;
      staging_to_global<N>(
          out + ((static_cast<size_t>(b) * h + y0 + r) * wd + x0) * cout + co0,
          staging + Staging<N>::offset(kPx, r * kTileW, 0), kPx, px, nc, cout,
          wt);
    }
    named_bar(bar, 128);
  }
}

// `bytes` bytes from src to dst (global or shared) by a warpgroup's 128
// threads (thread index wt): 16, 4 or 2 bytes a load and store, the widest
// that both addresses and the length allow.
__device__ __forceinline__ void copy_run(void* dst, const void* src, int bytes,
                                         int wt) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(src) |
                       static_cast<uintptr_t>(bytes);
  if (al % 16 == 0) {
    for (int i = wt; i < bytes / 16; i += 128)
      static_cast<uint4*>(dst)[i] = static_cast<const uint4*>(src)[i];
  } else if (al % 4 == 0) {
    for (int i = wt; i < bytes / 4; i += 128)
      static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
  } else {
    for (int i = wt; i < bytes / 2; i += 128)
      static_cast<uint16_t*>(dst)[i] = static_cast<const uint16_t*>(src)[i];
  }
}

// One output row of the narrow designs' dense staging ([pixel][cout] bf16,
// cout <= 8, the layout of the output row itself) from an m64n8 fragment d:
// the thread's channels 2t, 2t + 1 (those below cout) of pixels 16 warp + g
// and + 8. The residual the caller staged there is read first (RES 1:
// added before the affine, 2: after it), then the math in f32 in the plain
// version's order, then the bf16 values written over it.
template <int ACT, int RES>
__device__ __forceinline__ void finish_row_dense(const float (&d)[4],
                                                 unsigned char* row, int cout,
                                                 int warp, int g, int t,
                                                 const Affine<8>& aff) {
  const int c = 2 * t;
  if (c >= cout) return;
  const bool two = c + 1 < cout;
  const float scj[2] = {aff.scale[0].x, aff.scale[0].y};
  const float shj[2] = {aff.shift[0].x, aff.shift[0].y};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* at = reinterpret_cast<bf16*>(row) +
               (warp * 16 + g + 8 * half) * cout + c;
    float rs[2] = {0.f, 0.f};
    if (RES) {
      rs[0] = __bfloat162float(at[0]);
      if (two) rs[1] = __bfloat162float(at[1]);
    }
    float v[2] = {d[2 * half], d[2 * half + 1]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float y = v[j];
      if (RES == 1) y = __fadd_rn(y, rs[j]);
      y = __fadd_rn(__fmul_rn(y, scj[j]), shj[j]);
      if (RES == 2) y = __fadd_rn(y, rs[j]);
      v[j] = activate_c<ACT>(y);
    }
    at[0] = __float2bfloat16_rn(v[0]);
    if (two) at[1] = __float2bfloat16_rn(v[1]);
  }
}

// The R rows of a dense staging (row r at r * 64 * cout bf16) to the
// output rows y0.. of image b from column x0 on: each a contiguous run of
// the NHWC output, copied by copy_run; rows past h skipped. The 128
// threads meet at named barrier `bar` before and after.
template <int R>
__device__ __forceinline__ void store_dense_rows(const unsigned char* staging,
                                                 bf16* out, int b, int y0,
                                                 int x0, int h, int wd,
                                                 int cout, int bar, int wt) {
  named_bar(bar, 128);
  const int px = min(kTileW, wd - x0);
  for (int r = 0; r < R && y0 + r < h; ++r) {
    copy_run(out + ((static_cast<size_t>(b) * h + y0 + r) * wd + x0) * cout,
             staging + r * kTileW * cout * 2, px * cout * 2, wt);
  }
  named_bar(bar, 128);
}

// The residual rows y0.. of image b from column x0 on into a dense
// staging, as store_dense_rows lays them out (synchronous loads).
template <int R>
__device__ __forceinline__ void load_dense_rows(unsigned char* staging,
                                                const bf16* res, int b, int y0,
                                                int x0, int h, int wd,
                                                int cout, int wt) {
  const int px = min(kTileW, wd - x0);
  for (int r = 0; r < R && y0 + r < h; ++r) {
    copy_run(staging + r * kTileW * cout * 2,
             res + ((static_cast<size_t>(b) * h + y0 + r) * wd + x0) * cout,
             px * cout * 2, wt);
  }
}

// The persistent, warp-specialized mainloop of both kernels. A block walks
// its tiles (blockIdx.x, + gridDim.x, ...); each tile is ITEMS items, item
// i staging input channels [(i % KGROUPS) KG, + KG) of the tile's halo. The
// producer warp (one elected thread) stages the items in order through a
// ring of STAGES stages by TMA (full[s]: its arrival plus the bytes;
// empty[s]: the consuming warpgroup's 128 threads). Consumer warpgroups 0
// and 1 take alternate tiles, each running a tile's wgmmas and then its
// epilogue, so one's epilogue overlaps the other's wgmmas. They take turns
// on the items (order[c] hands the turn to consumer c), so items are
// consumed in the order they are staged: a consumer never waits on a
// stage's barrier while that barrier is two phases behind, where the
// parity test would pass too early.
//   origin(tile, b, ys, xs)  image and top left of the tile's staged halo
//   prefetch(tile)           by the consumer, before the tile's first item
//   mma(item, stage)         the item's wgmmas, waited for
//   epilogue(tile, item)     after each item, once its stage is released
template <int KG, int HR, int STAGES, int ITEMS, int KGROUPS, class Origin,
          class Prefetch, class Mma, class Epilogue>
__device__ __forceinline__ void mainloop(unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, uint64_t* order,
                                         const CUtensorMap* tmap, int tiles,
                                         Origin origin, Prefetch prefetch,
                                         Mma mma, Epilogue epilogue) {
  using S = Stage<KG, HR>;
  const int blk = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = blk < tiles ? (tiles - 1 - blk) / grid + 1 : 0;
  const uint32_t ring_s = smem_addr(ring);
  // the warpgroup (kConsumers: the producer warp), broadcast from lane 0 so
  // that the compiler sees it uniform over the warp: otherwise it takes the
  // consumers' wgmmas for a divergent path and serializes them (C7520)
  const int c = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (c == kConsumers) {
    if (threadIdx.x % 32 != 0) return;
    for (int j = 0; j < mine * ITEMS; ++j) {
      const int s = j % STAGES;
      // a fresh barrier passes a wait on parity 1: the first round is free
      mbar_wait(&empty[s], static_cast<uint32_t>(((j / STAGES) & 1) ^ 1));
      int b, ys, xs;
      origin(blk + (j / ITEMS) * grid, b, ys, xs);
      load_stage<KG, HR>(ring_s + s * S::kBytes, tmap, b, ys, xs,
                         j % ITEMS % KGROUPS * KG, &full[s]);
    }
  } else {
    for (int lt = c, n = 0; lt < mine; lt += kConsumers, ++n) {
      const int tile = blk + lt * grid;
      prefetch(tile);
      // consumer 0's n-th turn follows consumer 1's (n-1)-th (the first
      // passes), consumer 1's n-th follows consumer 0's n-th
      mbar_wait(&order[c], static_cast<uint32_t>((n & 1) ^ (c == 0 ? 1 : 0)));
      for (int kg = 0; kg < ITEMS; ++kg) {
        const int j = lt * ITEMS + kg;
        const int s = j % STAGES;
        mbar_wait(&full[s], static_cast<uint32_t>((j / STAGES) & 1));
        mma(kg, ring_s + s * S::kBytes);
        mbar_arrive(&empty[s]);
        if (kg == ITEMS - 1) mbar_arrive(&order[1 - c]);
        epilogue(tile, kg);
      }
    }
  }
}

// Shared memory of a kernel on the mainloop: weights, ring, output staging
// (STAGING_PX pixels of STAGING_N channels: Staging<N>, 1024-byte aligned
// for the swizzled TMA boxes), scale, shift, barriers.
template <int CIN_P, int N, int TAPS, int KG, int HR, int STAGES,
          int STAGING_PX, int STAGING_N = N>
struct Smem {
  static constexpr int kWeights = TAPS * CIN_P * N * 2;
  static constexpr int kRing = kWeights;
  static constexpr int kStaging =
      (kRing + STAGES * Stage<KG, HR>::kBytes + 1023) / 1024 * 1024;
  static constexpr int kScale = kStaging + STAGING_PX * STAGING_N * 2;
  static constexpr int kShift = kScale + N * 4;
  static constexpr int kFull = kShift + N * 4;
  static constexpr int kEmpty = kFull + STAGES * 8;
  static constexpr int kOrder = kEmpty + STAGES * 8;
  static constexpr int kBytes = kOrder + kConsumers * 8;
  static constexpr bool kFits = kBytes <= 232448;  // a block's most
};

// The deepest ring (4, 3 or 2 stages) that fits beside the rest.
template <template <int> class L>
constexpr int ring_stages() {
  return L<4>::kFits ? 4 : (L<3>::kFits ? 3 : 2);
}

// Block setup: barriers, weights, scale and shift (zero past cout), all
// visible to wgmma before the first item.
template <class L, int CIN_P, int N, int TAPS, int STAGES>
__device__ __forceinline__ void setup(unsigned char* smem,
                                      const bf16* __restrict__ w,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift, int cin,
                                      int cout, int co0) {
  static_assert(L::kFits, "more shared memory than a block has");
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L::kEmpty);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival (+ TMA bytes)
      mbar_init(&empty[s], 128);  // one consumer warpgroup's threads
    }
    uint64_t* order = reinterpret_cast<uint64_t*>(smem + L::kOrder);
    for (int c = 0; c < kConsumers; ++c) mbar_init(&order[c], 128);
  }
  load_weights_kmajor<CIN_P, N>(reinterpret_cast<bf16*>(smem), w, TAPS, cin, cout,
                         co0);
  float* sc = reinterpret_cast<float*>(smem + L::kScale);
  float* sh = reinterpret_cast<float*>(smem + L::kShift);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sc[i] = co0 + i < cout ? scale[co0 + i] : 0.f;
    sh[i] = co0 + i < cout ? shift[co0 + i] : 0.f;
  }
  fence_proxy_async();
  __syncthreads();
}

}  // namespace hopper
}  // namespace sstem
