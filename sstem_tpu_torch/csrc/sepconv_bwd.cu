// Adaptive separable convolution, backward, for Hopper (sm_90a).
//
//   s(u,v)[n,y,x] = sum_c g[n,c,y,x] * im[n,c,y+u,x+v]
//   dV[n,u,y,x]   = sum_v H[n,v,y,x] * s(u,v)
//   dH[n,v,y,x]   = sum_u V[n,u,y,x] * s(u,v)
//
// image (N, C, H+K-1, W+K-1), already replication-padded; tap maps V, H and
// the outputs dV, dH (N, K, H, W); the output gradient g (N, C, H, W) in the
// image dtype. Sums are f32; dV and dH are rounded once, to the maps' dtype.
// The image gradient is identically zero (the reference op never writes it),
// so the kernel does not compute one.
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/sepconv.py::_bwd_kernel
// (launched by _sepconv_bwd_pallas_planar, reached from the custom VJP of
// sepconv_planar and sepconv).
//
// What bounds it on the H100: per pixel and channel the kernel does K*K
// window loads from shared memory and 2*K*K FMAs, and per pixel it moves 4K
// map values through device memory (V, H in; dV, dH out). On the training
// shape (32 x 1 x 256^2, K=51, f32) that is 5.45 G shared loads, 10.9 G FMAs
// and 1.71 GB of maps. At one warp-wide shared load per SM per clock (132 SMs,
// about 1.75 GHz) the loads take about 0.74 ms; the FMAs, at 128 lanes per SM
// per clock, half of that; HBM, at 3.35 TB/s, about 0.51 ms. So on-chip loads
// bound it, as in the forward, at about 0.74 ms.
//
// Design: the forward's (csrc/sepconv_fwd.cu). One thread per output pixel
// in 32x8 blocks; the block stages its (8+K-1) x (32+K-1) window of the
// padded image in shared memory as f32. Each thread keeps its K horizontal
// taps and its K running dH sums in registers and walks u: it reads V[u]
// (coalesced along x), runs the v loop against a shared-memory row, and
// writes dV[u] once. No pixel shares an output with another, so there are no
// atomics and no sums across blocks (the Pallas kernel carries dH in its
// output block across u; here that is registers).
//
// The FMAs are regrouped so that each window value is loaded once and used
// twice (s is never formed):
//   dV[u] += g_c * sum_v H[v] * im_c(u,v)      dH[v] += (V[u] * g_c) * im_c(u,v)
// which is 2*K*K FMAs per pixel and channel instead of the 3*K*K of forming s.
// It is one pass, not two: at K=51 a thread holds 102 live floats (taps and
// dH sums), which fits under the 255-register limit without spilling (ptxas
// -v, printed by the build: 170-174 registers, no spills), so recomputing s
// in a second pass would only add loads. The price is occupancy: one
// 256-thread block per SM, 8 warps, which leaves the kernel about 3x above
// the shared-load bound.
//
// Channels: the window of every channel sits in dynamic shared memory when
// it fits (19 KB per channel at K=51, so up to 11 channels; many more at
// small K); more channels are taken in chunks of what fits, and dV is then
// accumulated in the maps' dtype across chunks. K=51 is a compile-time
// constant so the tap and dH arrays stay in registers and the v loop is fully
// unrolled; other K <= 51 take a generic instantiation with guarded taps.

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

// a value this kernel wrote earlier (not through the read-only cache)
__device__ __forceinline__ float reload(const float* p) { return *p; }
__device__ __forceinline__ float reload(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <int KS, typename TI, typename TM>
cudaError_t launch_k(const void* image, const void* vert, const void* horz,
                     const void* grad, void* dvert, void* dhorz, int n, int c,
                     int h, int w, int k, cudaStream_t stream) {
  auto kernel = sepconv_bwd_kernel<KS, TI, TM>;
  int device = 0;
  int smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t per_channel =
      static_cast<size_t>(kTY + k - 1) * (kTX + k - 1) * sizeof(float);
  const size_t fit = static_cast<size_t>(smem_max) / per_channel;
  if (fit < 1) return cudaErrorInvalidValue;
  const int chunk = fit < static_cast<size_t>(c) ? static_cast<int>(fit) : c;
  const size_t smem = chunk * per_channel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, n);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const TI*>(image), static_cast<const TM*>(vert),
      static_cast<const TM*>(horz), static_cast<const TI*>(grad),
      static_cast<TM*>(dvert), static_cast<TM*>(dhorz), c, h, w, k, chunk);
  return cudaGetLastError();
}

template <typename TI, typename TM>
cudaError_t launch(const void* image, const void* vert, const void* horz,
                   const void* grad, void* dvert, void* dhorz, int n, int c,
                   int h, int w, int k, cudaStream_t stream) {
  if (k == kKMax) {
    return launch_k<kKMax, TI, TM>(image, vert, horz, grad, dvert, dhorz, n, c,
                                   h, w, k, stream);
  }
  return launch_k<0, TI, TM>(image, vert, horz, grad, dvert, dhorz, n, c, h,
                             w, k, stream);
}

}  // namespace

// grad has the image's dtype (it is the gradient of the forward's output).
extern "C" int sstem_sepconv_bwd(const void* image, const void* vert,
                                 const void* horz, const void* grad,
                                 void* dvert, void* dhorz, int n, int c, int h,
                                 int w, int k, int image_bf16, int maps_bf16,
                                 void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || k < 1 || k > kKMax ||
      n > 65535 || (h + kTY - 1) / kTY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (image_bf16 && maps_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(image, vert, horz, grad, dvert,
                                               dhorz, n, c, h, w, k, s);
  } else if (image_bf16) {
    err = launch<__nv_bfloat16, float>(image, vert, horz, grad, dvert, dhorz,
                                       n, c, h, w, k, s);
  } else if (maps_bf16) {
    err = launch<float, __nv_bfloat16>(image, vert, horz, grad, dvert, dhorz,
                                       n, c, h, w, k, s);
  } else {
    err = launch<float, float>(image, vert, horz, grad, dvert, dhorz, n, c, h,
                               w, k, s);
  }
  return static_cast<int>(err);
}
