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
// What bounds it on the H100: per output pixel the kernel reads 2K tap values
// from device memory (the maps are the only large stream: 2 x 51 x 4 B per
// pixel in f32) and does K*K multiply-adds against the image window. At K=51
// that is 2601 FMAs per 408 bytes of maps, so with the window held on chip the
// kernel is bound by on-chip operand delivery (one shared-memory load per FMA
// here), not by HBM.
//
// Design: one thread per output pixel in 32x8 blocks. The block stages its
// (8+K-1) x (32+K-1) window of the padded image in shared memory as f32
// (82 x 58 x 4 B = 19 KB at K=51), so each image element is read from device
// memory about once per block instead of K*K times per pixel (the reference's
// CUDA op reads every tap from global memory). Each thread keeps its own K
// horizontal taps in registers, loaded once, and walks u: it reads V[u] from
// device memory (coalesced along x), runs the v loop against a shared-memory
// row (neighbouring threads read neighbouring words: no bank conflicts), and
// accumulates in f32. K=51 is a compile-time constant so the tap array stays
// in registers and the v loop is fully unrolled; other K <= 51 take a generic
// instantiation with guarded taps. Channels loop inside the block and reuse
// the registers. Register blocking, TMA window loads and tensor-core forms are
// left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kKMax = 51;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

extern "C" int sstem_sepconv_fwd(const void* image, const void* vert,
                                 const void* horz, void* out, int n, int c,
                                 int h, int w, int k, int image_bf16,
                                 int maps_bf16, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || k < 1 || k > kKMax ||
      n > 65535 || (h + kTY - 1) / kTY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" const char* sstem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
