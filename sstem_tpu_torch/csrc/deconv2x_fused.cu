// Fused ConvTranspose2d(kernel 3, stride 2, padding 1, output_padding 1) +
// per-channel affine + activation + optional skip, bf16 NHWC in and out, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/deconv.py::deconv2x_packed
// (body _kernel). Per output parity the transposed conv has at most two taps
// an axis (deconv.py:1-15): with the weight W[ci, co, ky, kx] of PyTorch,
//
//   out[2i]   = W[.., ky=1] . x[i]
//   out[2i+1] = W[.., ky=2] . x[i] + W[.., ky=0] . x[i+1]
//
// in both axes, x[i+1] being zero past the last row and column (output
// padding 1). Epilogue, in f32 on the accumulator:
//
//   post_affine:   y = act(acc * scale + shift + res)
//   post_act_half: y = (act(acc * scale + shift) + res) / 2
//   none:          y = act(acc * scale + shift)
//
// rounded once to bf16; scale and shift carry the deconv bias and eval
// BatchNorm (fold_affine).
//
// What bounds it on the H100: at 64 -> 32 channels, 4 x 640^2 -> 1280^2, it
// reads 0.21 GB, writes 0.42 GB and reads a 0.42 GB skip under
// post_act_half, against 30 GFLOP: device-memory bytes (~0.31 ms).
//
// Design: the implicit GEMM of conv3x3_fused.cu (conv_tile.cuh) over an
// input tile of 8 x 16 pixels plus one halo row and column (zero outside the
// image); the four output parities are four GEMMs of 1, 2, 2 and 4 taps
// each, run one after the other on the same tile so the accumulators of one
// parity fit in registers. All nine taps' weights sit in shared memory;
// blocks are persistent. The TPU kernel's packed lanes and block-structured
// weights are not carried over.

#include "conv_tile.cuh"

namespace {

using sstem::bf16;

constexpr int kTH = 8;   // input rows per tile
constexpr int kTW = 16;  // input cols per tile (one M-block)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTH / kWarps;
constexpr int kSH = kTH + 1;
constexpr int kSW = kTW + 1;

template <int CIN_P, int COUT_P>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(9 * COUT_P + kSH * kSW) * (CIN_P + 8) *
         sizeof(bf16);
}

// res_mode: 0 none, 1 post_affine, 2 post_act_half
template <int CIN_P, int COUT_P>
__global__ void __launch_bounds__(kWarps * 32)
deconv2x_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const bf16* __restrict__ res, bf16* __restrict__ out,
                      int h, int wd, int cin, int cout, int act, int res_mode,
                      int tiles_x, int tiles_y, long long tiles, bool vec) {
  constexpr int KS = CIN_P + 8;
  constexpr int NB = COUT_P / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* in_s = w_s + 9 * COUT_P * KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ho = 2 * h;
  const int wo = 2 * wd;

  sstem::load_weights<CIN_P, COUT_P>(w_s, w, 9, cin, cout);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = static_cast<int>(rest % tiles_y);
    const int b = static_cast<int>(rest / tiles_y);
    const int y0 = ty * kTH;
    const int x0 = tx * kTW;

    __syncthreads();
    sstem::load_tile<CIN_P>(in_s, x, b, y0, x0, kSH, kSW, h, wd, cin, vec);
    __syncthreads();

#pragma unroll 1
    for (int parity = 0; parity < 4; ++parity) {
      const int a = parity >> 1;  // output row parity
      const int p = parity & 1;   // output col parity
      float acc[kRowsPerWarp][NB][4];
      sstem::zero(acc);
      // row taps: a == 0 -> (di 0, ky 1); a == 1 -> (0, 2), (1, 0)
#pragma unroll 1
      for (int ri = 0; ri < 1 + a; ++ri) {
        const int di = ri;
        const int ky = a == 0 ? 1 : (ri == 0 ? 2 : 0);
#pragma unroll 1
        for (int ci = 0; ci < 1 + p; ++ci) {
          const int dj = ci;
          const int kx = p == 0 ? 1 : (ci == 0 ? 2 : 0);
          sstem::mma_tap<CIN_P, COUT_P, kRowsPerWarp>(
              acc, in_s + ((warp * kRowsPerWarp + di) * kSW + dj) * KS,
              kSW * KS, w_s + (ky * 3 + kx) * COUT_P * KS, lane);
        }
      }

#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const int iy = y0 + warp * kRowsPerWarp + m;
        if (iy >= h) continue;
        const int oy = 2 * iy + a;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ix = x0 + g + half * 8;
          if (ix >= wd) continue;
          const int ox = 2 * ix + p;
          const size_t pix = (static_cast<size_t>(b) * ho + oy) * wo + ox;
          bf16* dst = out + pix * cout;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int co = nb * 8 + 2 * t;
            if (co >= cout) continue;
            float r0 = 0.f, r1 = 0.f;
            if (res_mode) sstem::load2(res + pix * cout, co, cout, r0, r1);
            float v[2] = {acc[m][nb][2 * half], acc[m][nb][2 * half + 1]};
            const float rv[2] = {r0, r1};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = co + j < cout ? co + j : co;
              float y = __fadd_rn(__fmul_rn(v[j], __ldg(scale + c)),
                                  __ldg(shift + c));
              if (res_mode == 1) y = __fadd_rn(y, rv[j]);
              y = sstem::activate(y, act);
              if (res_mode == 2) y = __fmul_rn(__fadd_rn(y, rv[j]), 0.5f);
              v[j] = y;
            }
            sstem::store2(dst, co, cout, v[0], v[1]);
          }
        }
      }
    }
  }
}

template <int CIN_P, int COUT_P>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, void* out, int n, int h,
                   int wd, int cin, int cout, int act, int res_mode,
                   cudaStream_t stream) {
  auto kernel = deconv2x_fused_kernel<CIN_P, COUT_P>;
  const size_t smem = smem_bytes<CIN_P, COUT_P>();
  const int tiles_x = (wd + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t err =
      sstem::persistent_grid(kernel, kWarps * 32, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, shift,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), h, wd, cin, cout,
      act, res_mode, tiles_x, tiles_y, tiles, vec);
  return cudaGetLastError();
}

template <int CIN_P>
cudaError_t launch_cout(int cout_p, const void* x, const void* w,
                        const float* scale, const float* shift, const void* res,
                        void* out, int n, int h, int wd, int cin, int cout,
                        int act, int res_mode, cudaStream_t stream) {
  switch (cout_p) {
    case 16:
      return launch<CIN_P, 16>(x, w, scale, shift, res, out, n, h, wd, cin,
                               cout, act, res_mode, stream);
    case 32:
      return launch<CIN_P, 32>(x, w, scale, shift, res, out, n, h, wd, cin,
                               cout, act, res_mode, stream);
    case 64:
      return launch<CIN_P, 64>(x, w, scale, shift, res, out, n, h, wd, cin,
                               cout, act, res_mode, stream);
  }
  return cudaErrorInvalidValue;
}

int pad(int c, int to) { return (c + to - 1) / to * to; }

}  // namespace

// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16, PyTorch's
// ConvTranspose2d weight (cin, cout, 3, 3) permuted to (ky, kx, cin, cout);
// scale, shift (cout,) f32; res (n, 2h, 2w, cout) bf16 or null;
// out (n, 2h, 2w, cout) bf16. cin in [1, 128], cout in [1, 64]; act 0 none,
// 1 relu, 2 leaky 0.2; res_mode 0 none, 1 post_affine, 2 post_act_half.
extern "C" int sstem_deconv2x_fused(const void* x, const void* w,
                                    const void* scale, const void* shift,
                                    const void* res, void* out, int n, int h,
                                    int wd, int cin, int cout, int act,
                                    int res_mode, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cin > 128 || cout < 1 ||
      cout > 64 || act < 0 || act > 2 || res_mode < 0 || res_mode > 2 ||
      (res_mode != 0 && res == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int cout_p = pad(cout, 16) == 48 ? 64 : pad(cout, 16);
  const int cin_p = pad(cin, 32) == 96 ? 128 : pad(cin, 32);
  switch (cin_p) {
    case 32:
      return static_cast<int>(launch_cout<32>(cout_p, x, w, sc, sh, res, out, n,
                                              h, wd, cin, cout, act, res_mode, s));
    case 64:
      return static_cast<int>(launch_cout<64>(cout_p, x, w, sc, sh, res, out, n,
                                              h, wd, cin, cout, act, res_mode, s));
    default:  // 96 and 128
      return static_cast<int>(launch_cout<128>(cout_p, x, w, sc, sh, res, out,
                                               n, h, wd, cin, cout, act,
                                               res_mode, s));
  }
}
