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
// post_act_half, against 30 GFLOP: device-memory bytes (~0.31 ms); at
// 128 -> 64, 4 x 320^2, bytes too (0.094 ms; 0.19 with the skip).
//
// Two designs, picked by shape in sstem_deconv2x_fused (never on failure):
//
// wgmma (Cin a multiple of 8, Cout >= 16: both deconvs of FusionNet and of
// UNetSFF on the SFF packed path, 128 -> 64 and 64 -> 32): conv3x3_fused.cu's
// Hopper mainloop (hopper.cuh). A tile is one input row of 64 pixels; the
// producer warp stages it with the next row and column (2 rows of 66
// pixels, zeros past the image) by TMA. The consumer warpgroup that owns
// the tile runs the four output parities' 1, 2, 2 and 4 taps as
// wgmma.m64nNk16 (N = 32 or 64) on the staged tile, then finishes one whole
// output row (both column parities, 128 pixels) at a time: the bf16 row
// goes through a swizzled staging buffer and out with one TMA store, and
// the skip row comes in by cp.async into the same buffer. Above 32 output
// channels the two output rows are two passes over the K groups, so the
// accumulators stay at 64 registers a thread. Shared memory (weights +
// ring + staging): 128 -> 64: 147456 + 4 x 8704 + 32768 (K staged 32
// channels at a time, two passes); 64 -> 32: 36864 + 4 x 17408 + 16384.
//
// mma.sync (the other shapes, sstem_deconv2x_fused_mma): the first port's
// design, conv_tile.cuh's mma.sync implicit GEMM over 8 x 16 input tiles,
// the four parities one after the other, bf16 pairs stored per parity.

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// the wgmma design
// ---------------------------------------------------------------------------

namespace wg {

using namespace sstem::hopper;
using sstem::smem_addr;

template <int CIN_P, int N>
struct Cfg {
  static constexpr int kKG = CIN_P <= 64 ? CIN_P : 32;
  static constexpr int kGroups = CIN_P / kKG;
  // above 32 output channels the two output rows' parities are two passes
  // over the K groups (accumulators of 64 f32 registers a thread)
  static constexpr int kPasses = N > 32 ? 2 : 1;
  static constexpr int kQ = 4 / kPasses;  // parities per pass
  static constexpr int kItems = kPasses * kGroups;
  static constexpr int kHR = 2;  // a tile: one input row and the next
  // one output row of 2 x 64 pixels per consumer warpgroup
  template <int S>
  using Layout = Smem<CIN_P, N, 9, kKG, kHR, S, kConsumers * 2 * kTileW>;
  static constexpr int kStages = ring_stages<Layout>();
  using L = Layout<kStages>;
};

// res_mode: 0 none, 1 post_affine, 2 post_act_half
template <int CIN_P, int N>
__global__ void __launch_bounds__(kThreads, 1)
deconv2x_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                      const __grid_constant__ CUtensorMap omap,
                      const bf16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const bf16* __restrict__ res, bf16* __restrict__ out,
                      int h, int wd, int cin, int cout, int act, int res_mode,
                      int tiles_x, int tiles) {
  using C = Cfg<CIN_P, N>;
  using L = typename C::L;
  using S = Stage<C::kKG, C::kHR>;
  extern __shared__ __align__(128) unsigned char smem[];
  setup<L, CIN_P, N, 9, C::kStages>(smem, w, scale, shift, cin, cout, 0);

  // consumer warpgroup wgi (the producer warp, wgi 2, uses none of this)
  const int wgi = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int g = (wt % 32) / 4;
  const int t = wt % 4;
  const uint32_t w_s = smem_addr(smem);
  constexpr int kPx = 2 * kTileW;  // one output row
  unsigned char* staging =
      smem + L::kStaging + (wgi < kConsumers ? wgi : 0) * kPx * N * 2;
  const float* sc = reinterpret_cast<const float*>(smem + L::kScale);
  const float* sh = reinterpret_cast<const float*>(smem + L::kShift);
  // parity q = 2a + p (output row parity a, column parity p) of this pass
  // in acc[q % kQ]
  constexpr int kQ = C::kQ;
  float acc[kQ][N / 2];

  // tile = (image, input row, 64-column strip); its halo starts there
  auto origin = [&](int tile, int& b, int& y0, int& x0) {
    const int rest = tile / tiles_x;
    x0 = (tile - rest * tiles_x) * kTileW;
    b = rest / h;
    y0 = rest - b * h;
  };
  auto prefetch = [](int) {};
  auto mma = [&](int item, uint32_t stage) {
    const int pass = item / C::kGroups;
    const int kg = item % C::kGroups;
    if (kg == 0) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[q][i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q / kQ != pass) continue;
      const int a = q >> 1;
      const int p = q & 1;
      // row taps: a == 0 -> (di 0, ky 1); a == 1 -> (0, 2), (1, 0); columns
      // alike with (dj, kx) and p
#pragma unroll
      for (int di = 0; di <= a; ++di) {
        const int ky = a == 0 ? 1 : (di == 0 ? 2 : 0);
#pragma unroll
        for (int dj = 0; dj <= p; ++dj) {
          const int kx = p == 0 ? 1 : (dj == 0 ? 2 : 0);
          const int tap = ky * 3 + kx;
#pragma unroll
          for (int kk = 0; kk < C::kKG / 16; ++kk) {
            const uint64_t bd = gmma_desc(
                w_s + ((tap * (CIN_P / 8) + kg * (C::kKG / 8) + 2 * kk) * N) *
                          16,
                N * 16, 128);
            const uint64_t ad =
                gmma_desc(stage + 2 * kk * S::kChunkBytes +
                              (di * kPitch + dj) * 16,
                          S::kChunkBytes, 128);
            wgmma_m64k16(acc[q % kQ], ad, bd);
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kQ; ++q) fence_operands(acc[q]);
  };
  Affine<N> aff;
  aff.load(sc, sh, t);
  // after a pass: its output rows, each whole (both column parities);
  // skip pairs read first, then the math in f32 in the plain version's
  // order, then the bf16 pairs stored
  auto epilogue = [&](int tile, int item) {
    if (item % C::kGroups != C::kGroups - 1) return;
    const int pass = item / C::kGroups;
    int b, iy, x0;
    origin(tile, b, iy, x0);
    const int px = 2 * min(kTileW, wd - x0);
    const int bar = 1 + wgi;  // named barrier of this consumer warpgroup
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a * 2 / kQ != pass) continue;
      const size_t row =
          ((static_cast<size_t>(b) * 2 * h + 2 * iy + a) * 2 * wd + 2 * x0) *
          cout;
      // the last row's TMA store has read the staging
      if (wt == 0) bulk_wait_read();
      named_bar(bar, 128);
      if (res_mode) {
        global_to_staging<N>(staging, kPx, res + row, px, cout, cout, wt);
        cp_async_commit();
        cp_async_wait<0>();
        named_bar(bar, 128);
      }
      dispatch_epilogue(act, res_mode, [&](auto act_c, auto res_c) {
        constexpr int ACT = decltype(act_c)::value;
        constexpr int RES = decltype(res_c)::value;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* d = acc[(2 * a + p) % kQ];
          auto at = [&](int i, int half) {
            return staging +
                   Staging<N>::offset(kPx, 2 * (warp * 16 + g + 8 * half) + p,
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
                float y = __fadd_rn(__fmul_rn(v[j], scj[j]), shj[j]);
                if (RES == 1) y = __fadd_rn(y, rs[j]);
                y = activate_c<ACT>(y);
                if (RES == 2) y = __fmul_rn(__fadd_rn(y, rs[j]), 0.5f);
                v[j] = y;
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
      });
      if (cout % 8 == 0) {
        // one TMA store of the whole output row; the right edge is clipped
        fence_proxy_async();
        named_bar(bar, 128);
        if (wt == 0) {
          tma_store_4d(&omap, staging, 0, 2 * x0, 2 * iy + a, b);
          bulk_commit();
        }
      } else {
        named_bar(bar, 128);
        staging_to_global<N>(out + row, staging, kPx, px, cout, cout, wt);
        named_bar(bar, 128);
      }
    }
  };
  mainloop<C::kKG, C::kHR, C::kStages, C::kItems, C::kGroups>(
      smem + L::kRing, reinterpret_cast<uint64_t*>(smem + L::kFull),
      reinterpret_cast<uint64_t*>(smem + L::kEmpty),
      reinterpret_cast<uint64_t*>(smem + L::kOrder), &tmap, tiles,
      origin, prefetch, mma, epilogue);
  if (threadIdx.x % 128 == 0) bulk_wait_read();  // the stores' sources
}

template <int CIN_P, int N>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, void* out, int n, int h,
                   int wd, int cin, int cout, int act, int res_mode,
                   cudaStream_t stream) {
  using C = Cfg<CIN_P, N>;
  auto kernel = deconv2x_wgmma_kernel<CIN_P, N>;
  const size_t smem = C::L::kBytes;
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(n) * h * tiles_x;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tmap, omap = {};
  cudaError_t err = make_tensor_map(&tmap, x, n, h, wd, cin, C::kHR);
  if (err == cudaSuccess && cout % 8 == 0) {
    err = make_out_map(&omap, out, n, 2 * h, 2 * wd, cout, Staging<N>::kBox,
                       2 * kTileW);
  }
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = sstem::persistent_grid(kernel, kThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      tmap, omap, static_cast<const bf16*>(w), scale, shift,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), h, wd, cin, cout,
      act, res_mode, tiles_x, static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int CIN_P>
cudaError_t launch_n(int cout, const void* x, const void* w, const float* sc,
                     const float* sh, const void* res, void* out, int n, int h,
                     int wd, int cin, int act, int res_mode, cudaStream_t s) {
  if (cout <= 32) {
    return launch<CIN_P, 32>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                             res_mode, s);
  }
  return launch<CIN_P, 64>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                           res_mode, s);
}

}  // namespace wg

}  // namespace

// defined below
extern "C" int sstem_deconv2x_fused_mma(const void* x, const void* w,
                                        const void* scale, const void* shift,
                                        const void* res, void* out, int n,
                                        int h, int wd, int cin, int cout,
                                        int act, int res_mode, void* stream);

// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16, PyTorch's
// ConvTranspose2d weight (cin, cout, 3, 3) permuted to (ky, kx, cin, cout);
// scale, shift (cout,) f32; res (n, 2h, 2w, cout) bf16 or null;
// out (n, 2h, 2w, cout) bf16. cin in [1, 128], cout in [1, 64]; act 0 none,
// 1 relu, 2 leaky 0.2; res_mode 0 none, 1 post_affine, 2 post_act_half.
// The wgmma design takes cin % 8 == 0 and cout >= 16 (kernels/deconv.py:
// design), the mma.sync design the rest.
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
  if (cin % 8 != 0 || cout < 16) {
    return sstem_deconv2x_fused_mma(x, w, scale, shift, res, out, n, h, wd,
                                    cin, cout, act, res_mode, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  switch (pad(cin, 16)) {
    case 16:
      return static_cast<int>(wg::launch_n<16>(cout, x, w, sc, sh, res, out, n,
                                               h, wd, cin, act, res_mode, s));
    case 32:
      return static_cast<int>(wg::launch_n<32>(cout, x, w, sc, sh, res, out, n,
                                               h, wd, cin, act, res_mode, s));
    case 48:
    case 64:
      return static_cast<int>(wg::launch_n<64>(cout, x, w, sc, sh, res, out, n,
                                               h, wd, cin, act, res_mode, s));
    default:  // 80 to 128
      return static_cast<int>(wg::launch_n<128>(cout, x, w, sc, sh, res, out,
                                                n, h, wd, cin, act, res_mode,
                                                s));
  }
}

// the mma.sync design, for the shapes above that the wgmma design does not
// take
// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16, PyTorch's
// ConvTranspose2d weight (cin, cout, 3, 3) permuted to (ky, kx, cin, cout);
// scale, shift (cout,) f32; res (n, 2h, 2w, cout) bf16 or null;
// out (n, 2h, 2w, cout) bf16. cin in [1, 128], cout in [1, 64]; act 0 none,
// 1 relu, 2 leaky 0.2; res_mode 0 none, 1 post_affine, 2 post_act_half.
extern "C" int sstem_deconv2x_fused_mma(const void* x, const void* w,
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
