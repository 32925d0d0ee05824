// Fused 3x3 convolution (stride 1, zero pad 1) + per-channel affine +
// optional residual + activation, bf16 NHWC in and out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/conv3x3.py::conv3x3_packed
// (bodies _kernel_body and _kernel_res), with its epilogue:
//
//   y = act((acc [+ res if pre]) * scale + shift [+ res if post])
//
// acc the f32 sum of the conv over bf16 inputs and weights, scale and shift
// f32 per output channel (conv bias and eval BatchNorm folded, fold_affine),
// act none / relu / leaky 0.2, y rounded once to bf16.
//
// What bounds it on the H100: at the SFF serving path's shapes (C 32 at
// 4x1280^2, C 64 at 4x640^2) one conv moves ~0.84 or ~0.42 GB and does
// ~121 GFLOP, so device-memory bytes bound it (0.25 / 0.125 ms) with the
// tensor cores close behind at C 64; on plain FMAs the FLOPs alone would
// take 1.8 ms. At the SP path's 128 -> 128 (2x640^2, 241 GFLOP, 0.42 GB)
// the tensor cores bound it (0.244 ms against 0.125 ms of bytes).
//
// Design: an implicit GEMM on warp-level tensor cores (mma.sync m16n8k16,
// bf16 in, f32 sums; conv_tile.cuh). A block owns 8 x 16 output pixels at a
// time and up to 64 output channels; its 4 warps take two pixel rows each.
// Above 64 output channels the channels are split over blocks (grid y): the
// nine taps' weights of 128 input channels for all 128 outputs would take
// 9 x 128 x 136 x 2 B = 306 KB of shared memory, more than the 227 KB a
// block has, while a 64-channel slice takes 153 KB plus the 49 KB input
// tile (one block per SM). Each slice reads the input tile again, from L2
// mostly. The
// input tile with its 1-pixel halo (10 x 18 pixels, zero outside the image,
// channels zero-padded to a multiple of 16 in shared memory only) and all
// nine taps' weights sit in shared memory; each tap is one GEMM step whose A
// rows are shifted tile pixels. Blocks are persistent, so the weights are
// loaded once per block, not once per tile. The epilogue runs on the f32
// accumulators in registers and writes bf16 pairs. The TPU kernel's pixel
// packing (C*P = 128 lanes, block-structured weights, zero quads, rolls)
// existed to fill the TPU's lanes and is not carried over. Offsets into the
// activations are 64-bit (tensors reach 0.84 GB).
//
// Not yet done (later work): cp.async or TMA double-buffering of the input
// tile, wgmma, and streaming the 128-channel weights by tap so that two
// blocks fit on an SM.

#include "conv_tile.cuh"

namespace {

using sstem::bf16;

constexpr int kTH = 8;   // output rows per tile
constexpr int kTW = 16;  // output cols per tile (one M-block)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTH / kWarps;
constexpr int kSH = kTH + 2;
constexpr int kSW = kTW + 2;

template <int CIN_P, int COUT_P>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(9 * COUT_P + kSH * kSW) * (CIN_P + 8) *
         sizeof(bf16);
}

// res_mode: 0 none, 1 added before the affine, 2 after it (both before act)
template <int CIN_P, int COUT_P>
__global__ void __launch_bounds__(kWarps * 32)
conv3x3_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
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
  const int co0 = blockIdx.y * COUT_P;  // this block's output-channel slice

  sstem::load_weights<CIN_P, COUT_P>(w_s, w, 9, cin, cout, co0);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = static_cast<int>(rest % tiles_y);
    const int b = static_cast<int>(rest / tiles_y);
    const int y0 = ty * kTH;
    const int x0 = tx * kTW;

    __syncthreads();  // the previous tile's reads of in_s are done
    sstem::load_tile<CIN_P>(in_s, x, b, y0 - 1, x0 - 1, kSH, kSW, h, wd, cin,
                            vec);
    __syncthreads();

    float acc[kRowsPerWarp][NB][4];
    sstem::zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      sstem::mma_tap<CIN_P, COUT_P, kRowsPerWarp>(
          acc, in_s + ((warp * kRowsPerWarp + dy) * kSW + dx) * KS, kSW * KS,
          w_s + tap * COUT_P * KS, lane);
    }

#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int oy = y0 + warp * kRowsPerWarp + m;
      if (oy >= h) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + g + half * 8;
        if (ox >= wd) continue;
        const size_t pix = (static_cast<size_t>(b) * h + oy) * wd + ox;
        bf16* dst = out + pix * cout;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int co = co0 + nb * 8 + 2 * t;
          if (co >= cout) continue;
          float r0 = 0.f, r1 = 0.f;
          if (res_mode) sstem::load2(res + pix * cout, co, cout, r0, r1);
          float v[2] = {acc[m][nb][2 * half], acc[m][nb][2 * half + 1]};
          const float rv[2] = {r0, r1};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = co + j < cout ? co + j : co;
            float y = v[j];
            if (res_mode == 1) y = __fadd_rn(y, rv[j]);
            y = __fadd_rn(__fmul_rn(y, __ldg(scale + c)), __ldg(shift + c));
            if (res_mode == 2) y = __fadd_rn(y, rv[j]);
            v[j] = sstem::activate(y, act);
          }
          sstem::store2(dst, co, cout, v[0], v[1]);
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
  auto kernel = conv3x3_fused_kernel<CIN_P, COUT_P>;
  const size_t smem = smem_bytes<CIN_P, COUT_P>();
  const int tiles_x = (wd + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  const int slices = (cout + COUT_P - 1) / COUT_P;
  int grid = 0;
  cudaError_t err =
      sstem::persistent_grid(kernel, kWarps * 32, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  // the card holds `grid` blocks at once: share them among the slices
  const dim3 blocks((grid + slices - 1) / slices, slices);
  const bool vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
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
    case 64:  // also every cout above 64, in slices of 64
      return launch<CIN_P, 64>(x, w, scale, shift, res, out, n, h, wd, cin,
                               cout, act, res_mode, stream);
  }
  return cudaErrorInvalidValue;
}

int pad16(int c) { return (c + 15) / 16 * 16; }

}  // namespace

// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16 (HWIO); scale, shift
// (cout,) f32; res (n, h, w, cout) bf16 or null; out (n, h, w, cout) bf16.
// cin, cout in [1, 128]; act 0 none, 1 relu, 2 leaky 0.2; res_mode 0 none,
// 1 before the affine, 2 after it.
extern "C" int sstem_conv3x3_fused(const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   const void* res, void* out, int n, int h,
                                   int wd, int cin, int cout, int act,
                                   int res_mode, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cin > 128 || cout < 1 ||
      cout > 128 || act < 0 || act > 2 || res_mode < 0 || res_mode > 2 ||
      (res_mode != 0 && res == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int cout_p = pad16(cout) >= 48 ? 64 : pad16(cout);
  switch (pad16(cin)) {
    case 16:
      return static_cast<int>(launch_cout<16>(cout_p, x, w, sc, sh, res, out, n,
                                              h, wd, cin, cout, act, res_mode, s));
    case 32:
      return static_cast<int>(launch_cout<32>(cout_p, x, w, sc, sh, res, out, n,
                                              h, wd, cin, cout, act, res_mode, s));
    case 48:
    case 64:
      return static_cast<int>(launch_cout<64>(cout_p, x, w, sc, sh, res, out, n,
                                              h, wd, cin, cout, act, res_mode, s));
    default:  // 80 to 128
      return static_cast<int>(launch_cout<128>(cout_p, x, w, sc, sh, res, out,
                                               n, h, wd, cin, cout, act,
                                               res_mode, s));
  }
}
