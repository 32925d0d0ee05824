// Adaptive separable convolution, backward, for Hopper (sm_90a).
//
//   s(u,v)[n,y,x] = sum_c g[n,c,y,x] * im[n,c,y+u,x+v]
//   dV[n,u,y,x]   = sum_v H[n,v,y,x] * s(u,v)
//   dH[n,v,y,x]   = sum_u V[n,u,y,x] * s(u,v)
//
// image (N, C, H+K-1, W+K-1), already replication-padded; tap maps V, H and
// the outputs dV, dH (N, K, H, W); the output gradient g (N, C, H, W) in the
// image dtype. Sums are f32; dV and dH are rounded to the maps' dtype once
// per chunk of channels (below), so once wherever C fits. The image gradient
// is identically zero (the reference op never writes it), so the kernel does
// not compute one.
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/sepconv.py::_bwd_kernel
// (launched by _sepconv_bwd_pallas_planar, reached from the custom VJP of
// sepconv_planar and sepconv).
//
// What bounds it on the H100: per pixel it moves 4K map values through
// device memory (V, H in; dV, dH out) and does 2K*K + 2K FMAs a channel. On
// the training shape (32 x 1 x 256^2, K=51, f32) that is 1.73 GB, 0.517 ms
// at 3.35 TB/s, against 22.2 GFLOP, 0.33 ms at the 67 TFLOP/s f32 rate:
// bytes bound it. With the window on chip, what a design must watch is the
// rate at which shared memory feeds the FMAs (128 bytes a clock on an SM,
// against 128 FMAs) and that no device-memory load waits inside a loop.
//
// Two designs, picked by shape in sstem_sepconv_bwd (never on failure):
//
// blocked (W % 4 == 0 and 16-byte aligned maps: the training path's
// shapes). With g factored out, the two outputs are two forward-shaped sums
// over one window:
//   pass A:  dV[u] = sum_c g_c * sum_v H[v] * im_c(y+u, x+v)
//   pass B:  dH[v] = sum_c g_c * sum_u V[u] * im_c(y+u, x+v)
// A block of 128 threads owns a 32 x 16 pixel tile and stages, per channel,
// its (32+K-1) x (16+K-1) window of the padded image as f32, a transposed
// copy of it, and the tile's g in both orders (53.6 KB a channel). In pass A
// each thread holds 4 adjacent pixels of a row with their 4 x K H taps in
// registers, walks u, slides along window row u in 16-byte shared-memory
// loads (each value feeds the up to 4 pixels whose tap reaches it) and
// stores dV[u] of its 4 pixels as one 16-byte (f32) or 8-byte (bf16) store.
// Pass B is the same loop on the transposed window: 4 adjacent pixels of a
// column with their 4 x K V taps, walking v, each dH[v] stored as 4 values
// of 4 rows, 8 threads a row. So one shared-memory word feeds ~4 FMAs (the
// simple design: 2 FMAs per 4-byte load), no tap map is read inside a loop,
// every output plane is written once, and no pixel shares an output with
// another: no atomics, no sums across blocks. The two passes run one after
// the other in one launch, so the taps of only one pass are live at a time
// (4 x 51 f32 in registers, the forward's budget: 2 blocks, 8 warps an SM).
// Window rows are 68 floats and transposed rows 100 (4 mod 32), so the 8
// threads of a 16-byte load phase, 8 rows apart, fall in distinct banks.
// Each pixel's inner sum runs in f32 in ascending tap order, then
// acc += g_c * sum; the plain version forms s first, so the f32 results
// differ in rounding only. K=51 is a compile-time constant; other K <= 51
// run a generic instantiation whose taps past K are zero. So is C = 1 (the
// trainer's): without the channel loops and the chunk state the kernel
// fits in 255 registers, where the any-C instantiations spill.
//
// What holds it back (chip_smoke.py's readings, PERF.md): what holds the
// forward back, its FMA stream below the f32 rate. Each pass takes about
// one blocked forward's time at the same shape. A one-pass variant with 2
// pixels a thread (2 x K taps and 2 x K dH sums in registers, one load per
// 4 FMAs, V[u] prefetched a row ahead) measured slower.
//
// simple (other widths and misaligned maps, sstem_sepconv_bwd_simple): the
// first port's design. One thread per output pixel in 32x8 blocks with its
// K horizontal taps and K running dH sums in registers (170-174 registers:
// one 256-thread block, 8 warps an SM); it walks u, reads V[u] from device
// memory, runs the v loop against a shared-memory row and writes dV[u]:
//   dV[u] += g_c * sum_v H[v] * im_c(u,v)      dH[v] += (V[u] * g_c) * im_c(u,v)
// One 4-byte shared-memory load feeds 2 FMAs, and each V[u] load waits.
//
// Channels (both designs): the windows of every channel sit in dynamic
// shared memory when they fit (blocked: 4 channels; simple at K=51: 11);
// more channels are taken in chunks of what fits, and the outputs of each
// chunk after the first are added to what the earlier chunks stored, in the
// maps' dtype (the simple design keeps dH in registers across chunks and so
// does this for dV only).

#include "sepconv_tile.cuh"

namespace {

using namespace sstem::sepconv;

// a value this kernel wrote earlier (not through the read-only cache)
__device__ __forceinline__ float reload(const float* p) { return *p; }
__device__ __forceinline__ float reload(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------------------
// the simple design
// ---------------------------------------------------------------------------

constexpr int kTX = 32;
constexpr int kTY = 8;

// KS > 0: K fixed at compile time. KS == 0: runtime k (1..kKMax).
// chunk: channels whose windows fit in the dynamic shared memory at once.
template <int KS, typename TI, typename TM>
__global__ void __launch_bounds__(kTX * kTY)
sepconv_bwd_kernel(const TI* __restrict__ image, const TM* __restrict__ vert,
                   const TM* __restrict__ horz, const TI* __restrict__ grad,
                   TM* __restrict__ dvert, TM* __restrict__ dhorz, int c,
                   int h, int w, int k_runtime, int chunk) {
  constexpr int KB = KS > 0 ? KS : kKMax;
  extern __shared__ float win[];  // [chunk][rows][cols]

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
  const size_t maps = static_cast<size_t>(n) * k * plane + pix;
  const TM* vmap = vert + maps;
  const TM* hmap = horz + maps;
  TM* dvmap = dvert + maps;
  TM* dhmap = dhorz + maps;

  float htap[KB];
  float dh[KB];
#pragma unroll
  for (int v = 0; v < KB; ++v) {
    htap[v] = (live && (KS > 0 || v < k)) ? load_f32(hmap + v * plane) : 0.f;
    dh[v] = 0.f;
  }

  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int cn = min(chunk, c - c0);
    __syncthreads();  // the previous chunk's windows are no longer read
    for (int i = ty * kTX + tx; i < cn * rows * cols; i += kTX * kTY) {
      const int ch = i / (rows * cols);
      const int rq = i - ch * rows * cols;
      const int r = rq / cols;
      const int q = rq - r * cols;
      const int gy = y0 + r;
      const int gx = x0 + q;
      const TI* img = image + (static_cast<size_t>(n) * c + c0 + ch) *
                                  static_cast<size_t>(hp) * wp;
      win[i] = (gy < hp && gx < wp)
                   ? load_f32(img + static_cast<size_t>(gy) * wp + gx)
                   : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    for (int u = 0; u < k; ++u) {
      const float vu = load_f32(vmap + u * plane);
      float dv = 0.f;
      for (int ch = 0; ch < cn; ++ch) {
        const float gc = load_f32(
            grad + (static_cast<size_t>(n) * c + c0 + ch) * plane + pix);
        const float wgt = vu * gc;
        const float* row = &win[(ch * rows + ty + u) * cols + tx];
        // two partial sums halve the dependent FMA chain of the v loop
        float hs0 = 0.f, hs1 = 0.f;
#pragma unroll
        for (int v = 0; v < KB; ++v) {
          if (KS > 0 || v < k) {
            const float a = row[v];
            if (v & 1) {
              hs1 = fmaf(htap[v], a, hs1);
            } else {
              hs0 = fmaf(htap[v], a, hs0);
            }
            dh[v] = fmaf(wgt, a, dh[v]);
          }
        }
        dv = fmaf(gc, hs0 + hs1, dv);
      }
      TM* dst = dvmap + u * plane;
      store(dst, c0 == 0 ? dv : reload(dst) + dv);
    }
  }

  if (live) {
#pragma unroll
    for (int v = 0; v < KB; ++v) {
      if (KS > 0 || v < k) store(dhmap + v * plane, dh[v]);
    }
  }
}

// ---------------------------------------------------------------------------
// the blocked design
// ---------------------------------------------------------------------------

namespace blocked {

constexpr int kR = kRun;        // pixels a thread: along x (A), along y (B)
constexpr int kRows = 32;       // tile rows
constexpr int kCols = 16;       // tile columns
constexpr int kThreads = 128;   // kThreads * kR == kRows * kCols
constexpr int kWinRows = kRows + kKMax - 1;
constexpr int kWinCols = kCols + kKMax - 1;
constexpr int kLoads = (kR + kKMax - 1 + 3) / 4;  // 16-byte loads a slide
// floats a row for slides that start at up to `start`: past the last load,
// and 4 mod 32
constexpr int pitch(int start) {
  return (start + 4 * kLoads + 31 - 4) / 32 * 32 + 4;
}
constexpr int kPitch = pitch(kCols - kR);    // window rows (pass A)
constexpr int kPitchT = pitch(kRows - kR);   // transposed rows (pass B)
// g of the tile by rows (A) and by columns (B): an odd count of 16-byte
// groups a row, so 8 consecutive rows fall in distinct banks
constexpr int kGPitch = kCols + 4;
constexpr int kGPitchT = kRows + 4;
constexpr int kWin = kWinRows * kPitch;
constexpr int kWinT = kWinCols * kPitchT;
constexpr int kG = kRows * kGPitch;
// one channel's floats: window, transposed window, g, transposed g
constexpr int kChannelFloats = kWin + kWinT + kG + kCols * kGPitchT;
static_assert(kPitch % 32 == 4 && kPitchT % 32 == 4, "pitch");
static_assert(kWin % 4 == 0 && kWinT % 4 == 0 && kG % 4 == 0 &&
                  kChannelFloats % 4 == 0, "16-byte aligned parts");
static_assert(kThreads * kR == kRows * kCols, "tile");

// a map tap as f32 (bf16 pinned as f32, as load_px does)
__device__ __forceinline__ float load_tap(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p) {
  float v = __bfloat162float(*p);
  pin(v);
  return v;
}

__device__ __forceinline__ void reload_px(const float* p, float (&v)[kR]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void reload_px(const __nv_bfloat16* p,
                                          float (&v)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) v[i] = reload(p + i);
}

// s[r] += sum_t tap[r][t] * p[r + t] in ascending t: kR pixels' taps against
// one window row (A) or transposed row (B), in 16-byte loads; loaded value
// 4q + i feeds pixel r through its tap 4q + i - r
template <int KB>
__device__ __forceinline__ void slide(const float* p,
                                      const float (&tap)[kR][KB],
                                      float (&s)[kR]) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * q);
    const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = 4 * q + i - r;
        if (t >= 0 && t < KB) s[r] = fmaf(tap[r][t], e[i], s[r]);
      }
    }
  }
}

// KS > 0: K fixed at compile time. KS == 0: runtime k (1..kKMax).
// CS == 1: one channel (the training path), known at compile time, which
// leaves the channel loops and the chunk state out. CS == 0: any c.
// chunk: channels whose kChannelFloats fit in the dynamic shared memory.
template <int KS, int CS, typename TI, typename TM>
__global__ void __launch_bounds__(kThreads, 2)
sepconv_bwd_blocked_kernel(const TI* __restrict__ image,
                           const TM* __restrict__ vert,
                           const TM* __restrict__ horz,
                           const TI* __restrict__ grad, TM* __restrict__ dvert,
                           TM* __restrict__ dhorz, int c_runtime, int h,
                           int w, int k_runtime, int chunk) {
  constexpr int KB = KS > 0 ? KS : kKMax;
  extern __shared__ __align__(16) float smem[];  // [chunk][kChannelFloats]

  const int k = KS > 0 ? KS : k_runtime;
  const int c = CS > 0 ? CS : c_runtime;
  const int hp = h + k - 1;
  const int wp = w + k - 1;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kCols;
  const int y0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // pass A: kR pixels along x from tile (arow, acol), 8 rows a warp
  const int arow = warp * 8 + lane % 8;
  const int acol = lane / 8 * kR;
  const bool alive = y0 + arow < h && x0 + acol < w;  // w % kR == 0
  // pass B: kR pixels along y from tile (brow, bcol), 8 columns a warp
  const int bcol = warp % 2 * 8 + lane % 8;
  const int brow = (warp / 2 * 4 + lane / 8) * kR;
  const bool blive = x0 + bcol < w;

  const size_t plane = static_cast<size_t>(h) * w;
  const size_t maps = static_cast<size_t>(n) * k * plane;
  const size_t pa = alive ? static_cast<size_t>(y0 + arow) * w + x0 + acol : 0;

  const int step = CS > 0 ? CS : chunk;
  for (int c0 = 0; c0 < c; c0 += step) {
    const int cn = min(step, c - c0);
    __syncthreads();  // the previous chunk's windows are no longer read
    for (int ch = 0; ch < cn; ++ch) {
      float* win = smem + ch * kChannelFloats;
      float* gs = win + kWin + kWinT;
      float* gt = gs + kG;
      const size_t plane_c = static_cast<size_t>(n) * c + c0 + ch;
      const TI* img = image + plane_c * hp * wp;
      for (int i = threadIdx.x; i < kWin; i += kThreads) {
        const int r = i / kPitch;
        const int q = i - r * kPitch;
        const int gy = y0 + r;
        const int gx = x0 + q;
        win[i] = (q < kWinCols && gy < hp && gx < wp)
                     ? load_f32(img + static_cast<size_t>(gy) * wp + gx)
                     : 0.f;
      }
      const TI* g = grad + plane_c * plane;
      for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols;
        const int q = i - r * kCols;
        const int gy = y0 + r;
        const int gx = x0 + q;
        const float v = (gy < h && gx < w)
                            ? load_f32(g + static_cast<size_t>(gy) * w + gx)
                            : 0.f;
        gs[r * kGPitch + q] = v;
        gt[q * kGPitchT + r] = v;
      }
    }
    __syncthreads();
    for (int ch = 0; ch < cn; ++ch) {  // the transposed windows
      const float* win = smem + ch * kChannelFloats;
      float* wint = smem + ch * kChannelFloats + kWin;
      for (int i = threadIdx.x; i < kWinT; i += kThreads) {
        const int q = i / kPitchT;
        const int r = i - q * kPitchT;
        wint[i] = r < kWinRows ? win[r * kPitch + q] : 0.f;
      }
    }
    __syncthreads();

    if (alive) {  // pass A: dV
      float tap[kR][KB];
#pragma unroll
      for (int v = 0; v < KB; ++v) {
        float t[kR] = {0.f, 0.f, 0.f, 0.f};
        if (KS > 0 || v < k) load_px(horz + maps + v * plane + pa, t);
#pragma unroll
        for (int r = 0; r < kR; ++r) tap[r][v] = t[r];
      }
#pragma unroll 1
      for (int u = 0; u < k; ++u) {
        float acc[kR] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = 0; ch < cn; ++ch) {
          const float* win = smem + ch * kChannelFloats;
          float s[kR] = {0.f, 0.f, 0.f, 0.f};
          slide(win + (arow + u) * kPitch + acol, tap, s);
          const float4 g4 = *reinterpret_cast<const float4*>(
              win + kWin + kWinT + arow * kGPitch + acol);
          acc[0] = fmaf(g4.x, s[0], acc[0]);
          acc[1] = fmaf(g4.y, s[1], acc[1]);
          acc[2] = fmaf(g4.z, s[2], acc[2]);
          acc[3] = fmaf(g4.w, s[3], acc[3]);
        }
        TM* dst = dvert + maps + u * plane + pa;
        if (c0 > 0) {
          float old[kR];
          reload_px(dst, old);
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] += old[r];
        }
        store_px(dst, acc);
      }
    }

    if (blive) {  // pass B: dH
      float tap[kR][KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int y = y0 + brow + r;
          tap[r][u] = ((KS > 0 || u < k) && y < h)
                          ? load_tap(vert + maps + u * plane +
                                     static_cast<size_t>(y) * w + x0 + bcol)
                          : 0.f;
        }
      }
#pragma unroll 1
      for (int v = 0; v < k; ++v) {
        float acc[kR] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = 0; ch < cn; ++ch) {
          const float* wint = smem + ch * kChannelFloats + kWin;
          float s[kR] = {0.f, 0.f, 0.f, 0.f};
          slide(wint + (bcol + v) * kPitchT + brow, tap, s);
          const float4 g4 = *reinterpret_cast<const float4*>(
              wint + kWinT + kG + bcol * kGPitchT + brow);
          acc[0] = fmaf(g4.x, s[0], acc[0]);
          acc[1] = fmaf(g4.y, s[1], acc[1]);
          acc[2] = fmaf(g4.z, s[2], acc[2]);
          acc[3] = fmaf(g4.w, s[3], acc[3]);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int y = y0 + brow + r;
          if (y < h) {
            TM* dst = dhorz + maps + v * plane + static_cast<size_t>(y) * w +
                      x0 + bcol;
            store(dst, c0 > 0 ? reload(dst) + acc[r] : acc[r]);
          }
        }
      }
    }
  }
}

}  // namespace blocked

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename TI, typename TM>
using BwdKernel = void (*)(const TI*, const TM*, const TM*, const TI*, TM*,
                           TM*, int, int, int, int, int);

enum class Design { kSimple, kBlocked };

template <typename TI, typename TM>
cudaError_t launch(Design design, const void* image, const void* vert,
                   const void* horz, const void* grad, void* dvert,
                   void* dhorz, int n, int c, int h, int w, int k,
                   cudaStream_t stream) {
  const bool k51 = k == kKMax;
  BwdKernel<TI, TM> kernel;
  size_t per_channel;  // shared-memory bytes a channel
  dim3 block, grid;
  if (design == Design::kBlocked) {
    kernel = !k51   ? &blocked::sepconv_bwd_blocked_kernel<0, 0, TI, TM>
             : c == 1 ? &blocked::sepconv_bwd_blocked_kernel<kKMax, 1, TI, TM>
                      : &blocked::sepconv_bwd_blocked_kernel<kKMax, 0, TI, TM>;
    per_channel = blocked::kChannelFloats * sizeof(float);
    block = dim3(blocked::kThreads);
    grid = dim3((w + blocked::kCols - 1) / blocked::kCols,
                (h + blocked::kRows - 1) / blocked::kRows, n);
  } else {
    kernel = k51 ? &sepconv_bwd_kernel<kKMax, TI, TM>
                 : &sepconv_bwd_kernel<0, TI, TM>;
    per_channel = static_cast<size_t>(kTY + k - 1) * (kTX + k - 1) *
                  sizeof(float);
    block = dim3(kTX, kTY);
    grid = dim3((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, n);
  }
  int device = 0;
  int smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t fit = static_cast<size_t>(smem_max) / per_channel;
  if (fit < 1) return cudaErrorInvalidValue;
  const int chunk = fit < static_cast<size_t>(c) ? static_cast<int>(fit) : c;
  const size_t smem = chunk * per_channel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const TI*>(image), static_cast<const TM*>(vert),
      static_cast<const TM*>(horz), static_cast<const TI*>(grad),
      static_cast<TM*>(dvert), static_cast<TM*>(dhorz), c, h, w, k, chunk);
  return cudaGetLastError();
}

int dispatch(Design design, const void* image, const void* vert,
             const void* horz, const void* grad, void* dvert, void* dhorz,
             int n, int c, int h, int w, int k, int image_bf16, int maps_bf16,
             void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || k < 1 || k > kKMax ||
      n > 65535 || (h + kTY - 1) / kTY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (image_bf16 && maps_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(design, image, vert, horz, grad,
                                               dvert, dhorz, n, c, h, w, k, s);
  } else if (image_bf16) {
    err = launch<__nv_bfloat16, float>(design, image, vert, horz, grad, dvert,
                                       dhorz, n, c, h, w, k, s);
  } else if (maps_bf16) {
    err = launch<float, __nv_bfloat16>(design, image, vert, horz, grad, dvert,
                                       dhorz, n, c, h, w, k, s);
  } else {
    err = launch<float, float>(design, image, vert, horz, grad, dvert, dhorz,
                               n, c, h, w, k, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// grad has the image's dtype (it is the gradient of the forward's output).
// The simple design, at any shape.
extern "C" int sstem_sepconv_bwd_simple(const void* image, const void* vert,
                                        const void* horz, const void* grad,
                                        void* dvert, void* dhorz, int n, int c,
                                        int h, int w, int k, int image_bf16,
                                        int maps_bf16, void* stream) {
  return dispatch(Design::kSimple, image, vert, horz, grad, dvert, dhorz, n,
                  c, h, w, k, image_bf16, maps_bf16, stream);
}

// As sstem_sepconv_bwd_simple; the blocked design where w % 4 == 0 and the
// four maps are 16-byte aligned (kernels/sepconv.py: design), the simple one
// elsewhere.
extern "C" int sstem_sepconv_bwd(const void* image, const void* vert,
                                 const void* horz, const void* grad,
                                 void* dvert, void* dhorz, int n, int c, int h,
                                 int w, int k, int image_bf16, int maps_bf16,
                                 void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(vert) |
                        reinterpret_cast<uintptr_t>(horz) |
                        reinterpret_cast<uintptr_t>(dvert) |
                        reinterpret_cast<uintptr_t>(dhorz)) % 16 == 0;
  const Design design = w % blocked::kR == 0 && aligned ? Design::kBlocked
                                                        : Design::kSimple;
  return dispatch(design, image, vert, horz, grad, dvert, dhorz, n, c, h, w,
                  k, image_bf16, maps_bf16, stream);
}
