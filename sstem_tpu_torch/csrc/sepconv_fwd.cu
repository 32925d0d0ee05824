// Adaptive separable convolution, forward, for Hopper (sm_90a).
//
//   out[n,c,y,x] = sum_u V[n,u,y,x] * sum_v H[n,v,y,x] * im[n,c,y+u,x+v]
//
// image (N, C, H+K-1, W+K-1), already replication-padded by the caller;
// tap maps V, H (N, K, H, W); f32 accumulation; output in the image dtype.
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/sepconv.py::_fwd_kernel
// (launched by _sepconv_fwd_pallas_planar, reached from sepconv_planar).
//
// What bounds it on the H100: per output pixel and channel K*K + K f32
// multiply-adds against 2K tap values read once from device memory. At K=51
// in bf16 (4 x 1 x 1280^2, the SFF path) that is 34.8 GFLOP, 0.519 ms at
// the 67 TFLOP/s f32 rate, against 1.35 GB, 0.40 ms at 3.35 TB/s:
// operations bound it. In f32 (32 x 1 x 256^2, training) bytes do (0.261
// ms). With the image window held on chip, what a design must watch is the
// rate at which shared memory feeds the FMAs: the SM reads 128 bytes of it
// a clock against 128 FMAs.
//
// Two designs, picked by shape in sstem_sepconv_fwd (never on failure):
//
// blocked (W % 4 == 0 and 16-byte aligned maps: every path's shapes): each
// thread computes kR = 4 adjacent pixels of one row, with their 4 x K
// horizontal taps in registers (f32). It walks u; for each u
// it slides along its window row in 16-byte shared-memory loads, and each
// window value feeds the (up to) 4 pixels whose tap reaches it, so one
// shared-memory word feeds ~4 FMAs (the simple design: 1). A block is 32
// rows x 16 columns (lanes 0-7 of a warp are 8 rows, lanes 8i.. the next 4
// columns), so the 8 threads of a 16-byte load phase read 8 rows whose
// pitch (68 floats, 4 mod 32) puts them in distinct banks, and a warp's
// map loads are whole 32-byte sectors. The window, (32+K-1) x (16+K-1) of
// the padded image as f32 (22 KB at K=51), is loaded once per block and
// channel. V[u] for the thread's pixels comes through a per-thread ring of
// kDepth shared-memory slots filled by cp.async kDepth-1 rows ahead, so
// the u loop waits on no device-memory load. Each pixel's v-sum runs in
// f32 in ascending v, then acc += V[u] * hsum, as the plain version; one
// rounding at the end. K=51 is a compile-time constant; other K <= 51 run
// a generic instantiation whose taps past K are zero. The taps load after
// the window, so that the window's loads have the registers to be in
// flight together (the 4 x 51 taps take 204 of the thread's 255).
//
// What holds it back (chip_smoke.py's readings, PERF.md): the FMA stream
// itself, which runs below the f32 rate. Variants that held the taps in
// two passes (more warps an SM), kept two chains a pixel, or batched the
// window's loads did not move it by more than a few percent.
//
// simple (other widths, sstem_sepconv_fwd_simple): the first port's
// design, one thread per output pixel in 32 x 8 blocks, the window in
// shared memory as f32, the thread's K horizontal taps in registers, one
// shared-memory load per FMA and V[u] read from device memory in the loop.

#include "sepconv_tile.cuh"

namespace {

using namespace sstem::sepconv;

// ---------------------------------------------------------------------------
// the simple design
// ---------------------------------------------------------------------------

constexpr int kTX = 32;
constexpr int kTY = 8;

// KS > 0: K fixed at compile time. KS == 0: runtime k (1..kKMax).
template <int KS, typename TI, typename TM>
__global__ void __launch_bounds__(kTX * kTY)
sepconv_fwd_kernel(const TI* __restrict__ image, const TM* __restrict__ vert,
                   const TM* __restrict__ horz, TI* __restrict__ out,
                   int c, int h, int w, int k_runtime) {
  constexpr int KB = KS > 0 ? KS : kKMax;
  __shared__ float win[kTY + KB - 1][kTX + KB - 1];

  const int k = KS > 0 ? KS : k_runtime;
  const int hp = h + k - 1;
  const int wp = w + k - 1;
  const int rows = kTY + k - 1;
  const int cols = kTX + k - 1;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool live = x < w && y < h;

  const size_t plane = static_cast<size_t>(h) * w;
  const size_t pix = live ? static_cast<size_t>(y) * w + x : 0;
  const TM* vmap = vert + static_cast<size_t>(n) * k * plane + pix;
  const TM* hmap = horz + static_cast<size_t>(n) * k * plane + pix;

  float htap[KB];
#pragma unroll
  for (int v = 0; v < KB; ++v) {
    htap[v] = (live && (KS > 0 || v < k)) ? load_f32(hmap + v * plane) : 0.f;
  }

  for (int ch = 0; ch < c; ++ch) {
    const TI* img =
        image + (static_cast<size_t>(n) * c + ch) * static_cast<size_t>(hp) * wp;
    __syncthreads();  // the previous channel's window is no longer read
    for (int i = ty * kTX + tx; i < rows * cols; i += kTX * kTY) {
      const int r = i / cols;
      const int q = i - r * cols;
      const int gy = y0 + r;
      const int gx = x0 + q;
      win[r][q] = (gy < hp && gx < wp)
                      ? load_f32(img + static_cast<size_t>(gy) * wp + gx)
                      : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    float acc = 0.f;
    for (int u = 0; u < k; ++u) {
      const float* row = &win[ty + u][tx];
      float hs = 0.f;
#pragma unroll
      for (int v = 0; v < KB; ++v) {
        if (KS > 0 || v < k) hs = fmaf(htap[v], row[v], hs);
      }
      acc = fmaf(load_f32(vmap + u * plane), hs, acc);
    }
    store(out + (static_cast<size_t>(n) * c + ch) * plane + pix, acc);
  }
}

template <typename TI, typename TM>
void launch(const void* image, const void* vert, const void* horz, void* out,
            int n, int c, int h, int w, int k, cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, n);
  const TI* im = static_cast<const TI*>(image);
  const TM* v = static_cast<const TM*>(vert);
  const TM* hz = static_cast<const TM*>(horz);
  TI* o = static_cast<TI*>(out);
  if (k == kKMax) {
    sepconv_fwd_kernel<kKMax, TI, TM><<<grid, block, 0, stream>>>(
        im, v, hz, o, c, h, w, k);
  } else {
    sepconv_fwd_kernel<0, TI, TM><<<grid, block, 0, stream>>>(
        im, v, hz, o, c, h, w, k);
  }
}

// ---------------------------------------------------------------------------
// the blocked design
// ---------------------------------------------------------------------------

namespace blocked {

constexpr int kR = kRun;                 // pixels per thread along x
constexpr int kRows = 32;                // block rows: 8 per warp
constexpr int kCols = 4 * kR;            // block columns: 4 threads of kR
constexpr int kThreads = 128;
constexpr int kDepth = 4;                // V rows in flight, per thread
constexpr int kWinRows = kRows + kKMax - 1;
constexpr int kLoads = (kR + kKMax - 1 + 3) / 4;  // 16-byte loads a row
// floats per window row: past the last load of the last column group, and
// 4 mod 32, so 8 rows of one 16-byte load phase fall in distinct banks
constexpr int kPitch = (3 * kR + 4 * kLoads + 31 - 4) / 32 * 32 + 4;
static_assert(kPitch >= 3 * kR + 4 * kLoads && kPitch % 32 == 4, "pitch");

__device__ __forceinline__ void slot_px(const unsigned char* s, float,
                                        float (&v)[kR]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void slot_px(const unsigned char* s,
                                        __nv_bfloat16, float (&v)[kR]) {
  const uint2 q = *reinterpret_cast<const uint2*>(s);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// KS > 0: K fixed at compile time. KS == 0: runtime k (1..kKMax).
template <int KS, typename TI, typename TM>
__global__ void __launch_bounds__(kThreads, 2)
sepconv_fwd_blocked_kernel(const TI* __restrict__ image,
                           const TM* __restrict__ vert,
                           const TM* __restrict__ horz, TI* __restrict__ out,
                           int c, int h, int w, int k_runtime) {
  constexpr int KB = KS > 0 ? KS : kKMax;
  constexpr int kSlot = kR * static_cast<int>(sizeof(TM));  // bytes
  __shared__ __align__(16) float win[kWinRows * kPitch];
  __shared__ __align__(16) unsigned char ring[kDepth][kThreads][kSlot];

  const int k = KS > 0 ? KS : k_runtime;
  const int hp = h + k - 1;
  const int wp = w + k - 1;
  const int rows = kRows + k - 1;
  const int cols = kCols + k - 1;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kCols;
  const int y0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % 32;
  const int row = threadIdx.x / 32 * 8 + lane % 8;
  const int col = lane / 8 * kR;
  const int y = y0 + row;
  const int x = x0 + col;
  const bool live = y < h && x < w;  // w % kR == 0: all kR pixels or none

  const size_t plane = static_cast<size_t>(h) * w;
  const size_t pix = live ? static_cast<size_t>(y) * w + x : 0;
  const TM* vmap = vert + static_cast<size_t>(n) * k * plane + pix;
  const TM* hmap = horz + static_cast<size_t>(n) * k * plane + pix;

  // V[u] into this thread's ring slot u % kDepth (an empty group past k,
  // so that every iteration waits on the same count)
  auto stage_v = [&](int u) {
    if (u < k) {
      sstem::hopper::cp_async_ca<kSlot>(
          sstem::smem_addr(&ring[u % kDepth][threadIdx.x][0]),
          vmap + static_cast<size_t>(u) * plane, true);
    }
    sstem::hopper::cp_async_commit();
  };

  for (int ch = 0; ch < c; ++ch) {
    const TI* img =
        image + (static_cast<size_t>(n) * c + ch) * static_cast<size_t>(hp) * wp;
    __syncthreads();  // the previous channel's window is no longer read
    for (int i = threadIdx.x; i < kWinRows * kPitch; i += kThreads) {
      const int r = i / kPitch;
      const int q = i - r * kPitch;
      const int gy = y0 + r;
      const int gx = x0 + q;
      win[i] = (r < rows && q < cols && gy < hp && gx < wp)
                   ? load_f32(img + static_cast<size_t>(gy) * wp + gx)
                   : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    // the thread's kR x K horizontal taps, zero past k (loaded after the
    // window, whose loads then have the registers to be in flight together)
    float tap[kR][KB];
#pragma unroll
    for (int v = 0; v < KB; ++v) {
      float t[kR] = {0.f, 0.f, 0.f, 0.f};
      if (KS > 0 || v < k) load_px(hmap + v * plane, t);
#pragma unroll
      for (int r = 0; r < kR; ++r) tap[r][v] = t[r];
    }
#pragma unroll
    for (int d = 0; d < kDepth - 1; ++d) stage_v(d);
    float acc[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int u = 0; u < k; ++u) {
      stage_v(u + kDepth - 1);
      sstem::hopper::cp_async_wait<kDepth - 1>();  // V[u] has landed
      float vu[kR];
      slot_px(&ring[u % kDepth][threadIdx.x][0], TM(), vu);
      const float* wrow = win + (row + u) * kPitch + col;
      float hs[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(wrow + 4 * q);
        const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // window value 4q + i feeds pixel r through its tap 4q + i - r
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int v = 4 * q + i - r;
            if (v >= 0 && v < KB) hs[r] = fmaf(tap[r][v], e[i], hs[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(vu[r], hs[r], acc[r]);
    }
    sstem::hopper::cp_async_wait<0>();  // no copy outlives the channel
    store_px(out + (static_cast<size_t>(n) * c + ch) * plane + pix, acc);
  }
}

template <typename TI, typename TM>
void launch(const void* image, const void* vert, const void* horz, void* out,
            int n, int c, int h, int w, int k, cudaStream_t stream) {
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, n);
  const TI* im = static_cast<const TI*>(image);
  const TM* v = static_cast<const TM*>(vert);
  const TM* hz = static_cast<const TM*>(horz);
  TI* o = static_cast<TI*>(out);
  if (k == kKMax) {
    sepconv_fwd_blocked_kernel<kKMax, TI, TM><<<grid, kThreads, 0, stream>>>(
        im, v, hz, o, c, h, w, k);
  } else {
    sepconv_fwd_blocked_kernel<0, TI, TM><<<grid, kThreads, 0, stream>>>(
        im, v, hz, o, c, h, w, k);
  }
}

}  // namespace blocked

bool valid(int n, int c, int h, int w, int k) {
  return n >= 1 && c >= 1 && h >= 1 && w >= 1 && k >= 1 && k <= kKMax &&
         n <= 65535 && (h + kTY - 1) / kTY <= 65535;
}

}  // namespace

// image (n, c, h+k-1, w+k-1), vert and horz (n, k, h, w), out (n, c, h, w);
// image and out bf16 or f32 (image_bf16), the maps bf16 or f32 (maps_bf16).
// The simple design, at any shape.
extern "C" int sstem_sepconv_fwd_simple(const void* image, const void* vert,
                                        const void* horz, void* out, int n,
                                        int c, int h, int w, int k,
                                        int image_bf16, int maps_bf16,
                                        void* stream) {
  if (!valid(n, c, h, w, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_bf16 && maps_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(image, vert, horz, out, n, c, h, w, k, s);
  } else if (image_bf16) {
    launch<__nv_bfloat16, float>(image, vert, horz, out, n, c, h, w, k, s);
  } else if (maps_bf16) {
    launch<float, __nv_bfloat16>(image, vert, horz, out, n, c, h, w, k, s);
  } else {
    launch<float, float>(image, vert, horz, out, n, c, h, w, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As sstem_sepconv_fwd_simple; the blocked design where w % 4 == 0 and the
// maps and out are 16-byte aligned (kernels/sepconv.py: design), the simple
// one elsewhere.
extern "C" int sstem_sepconv_fwd(const void* image, const void* vert,
                                 const void* horz, void* out, int n, int c,
                                 int h, int w, int k, int image_bf16,
                                 int maps_bf16, void* stream) {
  if (!valid(n, c, h, w, k)) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(vert) |
                        reinterpret_cast<uintptr_t>(horz) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (w % blocked::kR != 0 || !aligned) {
    return sstem_sepconv_fwd_simple(image, vert, horz, out, n, c, h, w, k,
                                    image_bf16, maps_bf16, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_bf16 && maps_bf16) {
    blocked::launch<__nv_bfloat16, __nv_bfloat16>(image, vert, horz, out, n, c,
                                                  h, w, k, s);
  } else if (image_bf16) {
    blocked::launch<__nv_bfloat16, float>(image, vert, horz, out, n, c, h, w,
                                          k, s);
  } else if (maps_bf16) {
    blocked::launch<float, __nv_bfloat16>(image, vert, horz, out, n, c, h, w,
                                          k, s);
  } else {
    blocked::launch<float, float>(image, vert, horz, out, n, c, h, w, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sstem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
