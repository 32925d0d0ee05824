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
// tensor cores close behind; at the SP path's 128 -> 128 (2x640^2, 241
// GFLOP, 0.42 GB) the tensor cores bound it (0.244 ms).
//
// Four designs, picked by shape in sstem_conv3x3_fused (never on failure;
// kernels/conv3x3.py: design):
//
// wgmma (Cin a multiple of 8, Cout >= 16; every conv of the packed paths
// but the gray-pair first convs, Cin 1 or 2, the IFNet's Cin 6 and the
// narrow heads, Cout 1 or 2): an implicit GEMM on warpgroup tensor
// cores on hopper.cuh's mainloop. M = 64 output pixels of one row, N = the
// block's output channels (32, 64 or 128: one wgmma.m64nNk16), K = 16 input
// channels of one tap; the nine taps accumulate in f32 registers. A block
// is persistent and warp-specialized: one producer warp stages each tile's
// input halo (R + 2 rows of 66 pixels) by TMA into a ring of 2-4 stages
// (mbarriers full / empty); a box reaching past the image reads zeros,
// which is the conv's zero padding. Two consumer warpgroups take alternate
// tiles of R output rows (R = 4, 2, 1 for N = 32, 64, 128: 64 accumulator
// registers a thread) and take turns on the tensor cores, so one's
// epilogue runs during the other's wgmmas. All nine taps' weights stay in
// shared memory, loaded once a block. The layout [Cin/8][pixel][8] makes
// each tap's A operand an address offset (hopper.cuh); TMA over cp.async:
// a cp.async design (128 threads issuing 16-byte copies) spent ~4000
// cycles a tile issuing them and set the pace, one thread issuing one box
// an 8-channel chunk does not (the box still moves 16 bytes a pixel). The
// epilogue keeps the plain version's f32 order on the accumulators, with
// scale and shift in registers and act and residual mode compile-time,
// writes the bf16 pairs into a dense swizzled staging buffer (no bank
// conflicts) and stores each output row with one TMA store (clipped at
// the image edges; element stores when Cout % 8 != 0). The residual comes
// in by cp.async into the same staging, issued before the tile's wgmmas.
//
// Shared memory (bytes; weights + ring stages + staging for both
// consumers), by (Cin_p, N), as the paths call them:
//   (32, 32)   18432 + 4 x 25600 + 32768    R 4
//   (32, 64)   36864 + 4 x 16896 + 32768    R 2
//   (64, 64)   73728 + 3 x 33792 + 32768    R 2
//   (64, 128) 147456 + 3 x 12800 + 32768    R 1, K staged 32 at a time
//   (128, 64) 147456 + 3 x 16896 + 32768    R 2, K staged 32 at a time
// 128 -> 128 keeps 64-channel weight slices resident (the 288 KB of all
// 128 do not fit) and splits the outputs over grid.y, so each slice stages
// the input again, the second time mostly from L2.
//
// What holds it back (chip_smoke.py's readings, PERF.md): the producer's
// 16-byte-wide boxes (~300 cycles of the TMA unit a box), the consumers'
// turns on the tensor cores, and at N = 32 the epilogue. The consumer
// warpgroup index is broadcast from lane 0 (hopper.cuh: mainloop): taken
// as threadIdx.x / 128, ptxas saw the wgmmas on a divergent path and
// serialized them (warning C7520).
//
// narrow_out (Cin a multiple of 8, Cout <= 8: the heads 32 -> 1, 32 -> 2,
// 64 -> 1): the same mainloop, 8-row tiles
// (10 staged rows). With N = 8 a wgmma's work is its A operand's 2 KB
// shared-memory read, so N carries the three row taps instead: for each
// staged input row j and column tap dx, one wgmma.m64n24k16 a 16-channel
// step gives the partials that row adds to output rows j - 1, j, j + 1
// (columns 8 dy + co, the weights laid out so); an output row sums its
// three in f32. Each input row is read three times, not nine. Bound by
// reading the input (0.129 ms at 4 x 1280^2, 32 -> 1); held back by the
// producer's 8-channel TMA boxes (the kernel's note). The staging is the
// output rows' own dense [pixel][cout] layout, copied out 16 bytes a
// thread.
//
// narrow_in (Cin <= 7, Cout <= 64: the gray-pair first convs and the
// IFNet's 2 -> 6, 6 -> 6, 6 -> 32): conv3x3_narrow_in.cu, K = the 3 x 3 x
// Cin patch, its A operand built in registers.
//
// mma.sync (the other shapes, sstem_conv3x3_fused_mma: odd wide Cin such as
// K = 51 or 100, Cout 9 to 15): the first port's design, mma.sync m16n8k16
// from conv_tile.cuh, 8 x 16 output tiles loaded synchronously by 4 warps,
// channels padded to 16 in shared memory, outputs above 64 channels split
// over grid.y.
//
// Offsets into the activations are 64-bit (tensors reach 0.84 GB).

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// the wgmma design
// ---------------------------------------------------------------------------

namespace wg {

using namespace sstem::hopper;
using sstem::smem_addr;

template <int CIN_P, int N>
struct Cfg {
  // output rows per tile (one consumer warpgroup): accumulators of 64 f32
  // registers a thread
  static constexpr int kRows = N <= 32 ? 4 : (N == 64 ? 2 : 1);
  static constexpr int kKG =
      CIN_P <= 32 ? CIN_P : ((CIN_P == 128 || N == 128) ? 32 : 64);
  static constexpr int kItems = CIN_P / kKG;
  static constexpr int kHR = kRows + 2;
  template <int S>
  using Layout = Smem<CIN_P, N, 9, kKG, kHR, S, kConsumers * kRows * kTileW>;
  static constexpr int kStages = ring_stages<Layout>();
  using L = Layout<kStages>;
};

// res_mode: 0 none, 1 added before the affine, 2 after it (both before act)
template <int CIN_P, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                     const __grid_constant__ CUtensorMap omap,
                     const bf16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const bf16* __restrict__ res, bf16* __restrict__ out,
                     int h, int wd, int cin, int cout, int act, int res_mode,
                     int tiles_x, int tiles_y, int tiles) {
  using C = Cfg<CIN_P, N>;
  using L = typename C::L;
  using S = Stage<C::kKG, C::kHR>;
  constexpr int R = C::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int co0 = blockIdx.y * N;
  const int nc = min(N, cout - co0);
  setup<L, CIN_P, N, 9, C::kStages>(smem, w, scale, shift, cin, cout, co0);

  // consumer warpgroup wgi (the producer warp, wgi 2, uses none of this)
  const int wgi = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int g = (wt % 32) / 4;
  const int t = wt % 4;
  const uint32_t w_s = smem_addr(smem);
  constexpr int kPx = R * kTileW;  // staged pixels: the tile's rows
  unsigned char* staging =
      smem + L::kStaging + (wgi < kConsumers ? wgi : 0) * kPx * N * 2;
  const float* sc = reinterpret_cast<const float*>(smem + L::kScale);
  const float* sh = reinterpret_cast<const float*>(smem + L::kShift);
  float acc[R][N / 2];

  auto where = [&](int tile, int& b, int& y0, int& x0) {
    const int rest = tile / tiles_x;
    x0 = (tile - rest * tiles_x) * kTileW;
    b = rest / tiles_y;
    y0 = (rest - b * tiles_y) * R;
  };
  auto origin = [&](int tile, int& b, int& ys, int& xs) {
    where(tile, b, ys, xs);
    ys -= 1;
    xs -= 1;
  };
  const int bar = 1 + wgi;  // named barrier of this consumer warpgroup
  // the last tile's TMA stores have read the staging
  auto staging_free = [&]() {
    if (wt == 0) bulk_wait_read();
    named_bar(bar, 128);
  };
  // the residual rows into the staging, in flight during the wgmmas
  auto prefetch = [&](int tile) {
    if (!res_mode) return;
    staging_free();
    int b, y0, x0;
    where(tile, b, y0, x0);
    const int px = min(kTileW, wd - x0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int oy = y0 + r;
      if (oy < h) {
        global_to_staging<N>(
            staging + r * kTileW * Staging<N>::kRowBytes, kPx,
            res + ((static_cast<size_t>(b) * h + oy) * wd + x0) * cout + co0,
            px, nc, cout, wt);
      }
    }
    cp_async_commit();
  };
  auto mma = [&](int kg, uint32_t stage) {
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int kk = 0; kk < C::kKG / 16; ++kk) {
        const uint64_t bd = gmma_desc(
            w_s + ((tap * (CIN_P / 8) + kg * (C::kKG / 8) + 2 * kk) * N) * 16,
            N * 16, 128);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint64_t ad =
              gmma_desc(stage + 2 * kk * S::kChunkBytes +
                            ((r + tap / 3) * kPitch + tap % 3) * 16,
                        S::kChunkBytes, 128);
          wgmma_m64k16(acc[r], ad, bd);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_operands(acc[r]);
  };
  Affine<N> aff;
  aff.load(sc, sh, t);
  auto epilogue = [&](int tile, int kg) {
    if (kg != C::kItems - 1) return;
    int b, y0, x0;
    where(tile, b, y0, x0);
    if (res_mode) {
      cp_async_wait<0>();  // this thread's residual pieces
      named_bar(bar, 128);
    } else {
      staging_free();
    }
    dispatch_epilogue(act, res_mode, [&](auto act_c, auto res_c) {
      constexpr int ACT = decltype(act_c)::value;
      constexpr int RES = decltype(res_c)::value;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        finish_row<N, ACT, RES>(acc[r], staging, kPx, r * kTileW, warp, g, t,
                                aff);
      }
    });
    store_rows<N, R>(&omap, staging, out, b, y0, x0, h, wd, cout, co0, nc, bar,
                     wt);
  };
  mainloop<C::kKG, C::kHR, C::kStages, C::kItems, C::kItems>(
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
  auto kernel = conv3x3_wgmma_kernel<CIN_P, N>;
  const size_t smem = C::L::kBytes;
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + C::kRows - 1) / C::kRows;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int slices = (cout + N - 1) / N;
  CUtensorMap tmap, omap = {};
  cudaError_t err = make_tensor_map(&tmap, x, n, h, wd, cin, C::kHR);
  if (err == cudaSuccess && cout % 8 == 0) {
    err = make_out_map(&omap, out, n, h, wd, cout, Staging<N>::kBox, kTileW);
  }
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = sstem::persistent_grid(kernel, kThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  const dim3 blocks((grid + slices - 1) / slices, slices);
  kernel<<<blocks, kThreads, smem, stream>>>(
      tmap, omap, static_cast<const bf16*>(w), scale, shift,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), h, wd, cin, cout,
      act, res_mode, tiles_x, tiles_y, static_cast<int>(tiles));
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
  if (cout <= 64 || CIN_P == 128) {  // 128 inputs: 64-channel slices
    return launch<CIN_P, 64>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                             res_mode, s);
  }
  return launch<CIN_P, (CIN_P < 128 ? 128 : 64)>(
      x, w, sc, sh, res, out, n, h, wd, cin, cout, act, res_mode, s);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// the narrow_out design (cin % 8 == 0, cout <= 8)
// ---------------------------------------------------------------------------

namespace nout {

using namespace sstem::hopper;
using sstem::smem_addr;

constexpr int kRows = 8;           // output rows a tile
constexpr int kHR = kRows + 2;     // staged input rows
constexpr int kN = 24;             // wgmma N: three row taps x 8 channels
constexpr int kPx = kRows * kTileW;

template <int CIN_P>
struct Cfg {
  static constexpr int kKG = CIN_P < 32 ? CIN_P : 32;
  static constexpr int kItems = CIN_P / kKG;
  // the staging: kPx pixels of at most 8 channels a consumer
  template <int S>
  using Layout = Smem<CIN_P, kN, 3, kKG, kHR, S, kConsumers * kPx, 8>;
  static constexpr int kStages = ring_stages<Layout>();
  using L = Layout<kStages>;
};

// Weights [3][3][cin][cout] (HWIO) into shared [dx][CIN_P/8][24][8]: for
// column tap dx, B's column n = 8 dy + co holds tap (dy, dx)'s weights of
// output channel co; zero past cin and cout.
template <int CIN_P>
__device__ void load_weights_by_row(bf16* w_s, const bf16* __restrict__ w,
                                    int cin, int cout) {
  const bf16 zero_v = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 3 * CIN_P * kN; i += blockDim.x) {
    const int e = i % 8;
    int rest = i / 8;
    const int n = rest % kN;
    rest /= kN;
    const int k = (rest % (CIN_P / 8)) * 8 + e;
    const int dx = rest / (CIN_P / 8);
    const int dy = n / 8;
    const int co = n % 8;
    w_s[i] = (k < cin && co < cout)
                 ? w[((static_cast<size_t>(dy) * 3 + dx) * cin + k) * cout + co]
                 : zero_v;
  }
}

// An implicit GEMM whose N holds the three row taps: for each staged input
// row j and column tap dx, one wgmma.m64n24k16 a 16-channel step computes,
// for the 64 pixels of row j, the partial sums that row contributes to
// output rows j - 1, j and j + 1 of the tile (tap dy = 0, 1, 2 in columns
// 8 dy ..); an output row sums its three partials. Each input row is read
// from shared memory three times (once a dx) instead of nine (once a tap):
// with N = 8, the wgmmas' A operand reads, 2 KB each, not N, set their
// pace. The rest is the wgmma design's mainloop, whose producer then sets
// the pace: its TMA boxes of 8 channels move 16 bytes a pixel row by row,
// ~7 bytes a cycle an SM on the card (with its wgmmas removed the kernel
// took as long).
// res_mode: 0 none, 1 added before the affine, 2 after it (both before act)
template <int CIN_P>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_narrow_out_kernel(const __grid_constant__ CUtensorMap tmap,
                          const bf16* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const bf16* __restrict__ res, bf16* __restrict__ out,
                          int h, int wd, int cin, int cout, int act,
                          int res_mode, int tiles_x, int tiles_y, int tiles) {
  using C = Cfg<CIN_P>;
  using L = typename C::L;
  using S = Stage<C::kKG, kHR>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L::kEmpty);
  uint64_t* order = reinterpret_cast<uint64_t*>(smem + L::kOrder);
  float* sc = reinterpret_cast<float*>(smem + L::kScale);
  float* sh = reinterpret_cast<float*>(smem + L::kShift);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival (+ TMA bytes)
      mbar_init(&empty[s], 128);  // one consumer warpgroup's threads
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(&order[c], 128);
  }
  load_weights_by_row<CIN_P>(reinterpret_cast<bf16*>(smem), w, cin, cout);
  for (int i = threadIdx.x; i < 8; i += blockDim.x) {
    sc[i] = i < cout ? scale[i] : 0.f;
    sh[i] = i < cout ? shift[i] : 0.f;
  }
  fence_proxy_async();
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int g = (wt % 32) / 4;
  const int t = wt % 4;
  const uint32_t w_s = smem_addr(smem);
  unsigned char* staging =
      smem + L::kStaging + (wgi < kConsumers ? wgi : 0) * kPx * 8 * 2;
  float acc[kHR][kN / 2];

  auto where = [&](int tile, int& b, int& y0, int& x0) {
    const int rest = tile / tiles_x;
    x0 = (tile - rest * tiles_x) * kTileW;
    b = rest / tiles_y;
    y0 = (rest - b * tiles_y) * kRows;
  };
  auto origin = [&](int tile, int& b, int& ys, int& xs) {
    where(tile, b, ys, xs);
    ys -= 1;
    xs -= 1;
  };
  const int bar = 1 + wgi;  // named barrier of this consumer warpgroup
  // the residual rows into the staging (the last tile's stores, which end
  // at a barrier, have read it), before the tile's wgmmas
  auto prefetch = [&](int tile) {
    if (!res_mode) return;
    int b, y0, x0;
    where(tile, b, y0, x0);
    load_dense_rows<kRows>(staging, res, b, y0, x0, h, wd, cout, wt);
  };
  auto mma = [&](int kg, uint32_t stage) {
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < kHR; ++j)
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[j][i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < C::kKG / 16; ++kk) {
        const uint64_t bd = gmma_desc(
            w_s + ((dx * (CIN_P / 8) + kg * (C::kKG / 8) + 2 * kk) * kN) * 16,
            kN * 16, 128);
#pragma unroll
        for (int j = 0; j < kHR; ++j) {
          const uint64_t ad = gmma_desc(
              stage + 2 * kk * S::kChunkBytes + (j * kPitch + dx) * 16,
              S::kChunkBytes, 128);
          wgmma_m64k16(acc[j], ad, bd);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kHR; ++j) fence_operands(acc[j]);
  };
  Affine<8> aff;
  aff.load(sc, sh, t);
  auto epilogue = [&](int tile, int kg) {
    if (kg != C::kItems - 1) return;
    int b, y0, x0;
    where(tile, b, y0, x0);
    named_bar(bar, 128);  // the residual, where the tile has one
    dispatch_epilogue(act, res_mode, [&](auto act_c, auto res_c) {
      constexpr int ACT = decltype(act_c)::value;
      constexpr int RES = decltype(res_c)::value;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // output row r: row taps 0, 1, 2 of input rows r, r + 1, r + 2
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = __fadd_rn(__fadd_rn(acc[r][j], acc[r + 1][4 + j]),
                           acc[r + 2][8 + j]);
        }
        finish_row_dense<ACT, RES>(d, staging + r * kTileW * cout * 2, cout,
                                   warp, g, t, aff);
      }
    });
    store_dense_rows<kRows>(staging, out, b, y0, x0, h, wd, cout, bar, wt);
  };
  mainloop<C::kKG, kHR, C::kStages, C::kItems, C::kItems>(
      smem + L::kRing, full, empty, order, &tmap, tiles, origin, prefetch, mma,
      epilogue);
}

template <int CIN_P>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, void* out, int n, int h,
                   int wd, int cin, int cout, int act, int res_mode,
                   cudaStream_t stream) {
  using C = Cfg<CIN_P>;
  auto kernel = conv3x3_narrow_out_kernel<CIN_P>;
  const size_t smem = C::L::kBytes;
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + kRows - 1) / kRows;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tmap;
  cudaError_t err = make_tensor_map(&tmap, x, n, h, wd, cin, kHR);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = sstem::persistent_grid(kernel, kThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      tmap, static_cast<const bf16*>(w), scale, shift,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), h, wd, cin, cout,
      act, res_mode, tiles_x, tiles_y, static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace nout

}  // namespace

namespace {

bool bad_args(int n, int h, int wd, int cin, int cout, int act, int res_mode,
              const void* res) {
  return n < 1 || h < 1 || wd < 1 || cin < 1 || cin > 128 || cout < 1 ||
         cout > 128 || act < 0 || act > 2 || res_mode < 0 || res_mode > 2 ||
         (res_mode != 0 && res == nullptr);
}

}  // namespace

// defined below
extern "C" int sstem_conv3x3_fused_mma(const void* x, const void* w,
                                       const void* scale, const void* shift,
                                       const void* res, void* out, int n, int h,
                                       int wd, int cin, int cout, int act,
                                       int res_mode, void* stream);
// the narrow_in design (conv3x3_narrow_in.cu), for cin <= 7 and cout <= 64
namespace sstem {
int conv3x3_narrow_in(const void* x, const void* w, const void* scale,
                      const void* shift, const void* res, void* out, int n,
                      int h, int wd, int cin, int cout, int act, int res_mode,
                      void* stream);
}  // namespace sstem

namespace {

// the narrow_out design, for cin % 8 == 0 and cout <= 8 (arguments as
// sstem_conv3x3_fused's, which checks them)
int narrow_out(const void* x, const void* w, const void* scale,
               const void* shift, const void* res, void* out, int n, int h,
               int wd, int cin, int cout, int act, int res_mode,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  switch (pad16(cin)) {
    case 16:
      return static_cast<int>(nout::launch<16>(x, w, sc, sh, res, out, n, h,
                                                wd, cin, cout, act, res_mode, s));
    case 32:
      return static_cast<int>(nout::launch<32>(x, w, sc, sh, res, out, n, h,
                                                wd, cin, cout, act, res_mode, s));
    case 48:
    case 64:
      return static_cast<int>(nout::launch<64>(x, w, sc, sh, res, out, n, h,
                                                wd, cin, cout, act, res_mode, s));
    default:  // 80 to 128
      return static_cast<int>(nout::launch<128>(x, w, sc, sh, res, out, n, h,
                                                 wd, cin, cout, act, res_mode,
                                                 s));
  }
}

}  // namespace

// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16 (HWIO); scale, shift
// (cout,) f32; res (n, h, w, cout) bf16 or null; out (n, h, w, cout) bf16.
// cin, cout in [1, 128]; act 0 none, 1 relu, 2 leaky 0.2; res_mode 0 none,
// 1 before the affine, 2 after it. The design by shape (kernels/conv3x3.py:
// design): wgmma for cin % 8 == 0 and cout >= 16, narrow_out for cin % 8 ==
// 0 and cout <= 8, narrow_in for cin <= 7 and cout <= 64, mma.sync for the
// rest.
extern "C" int sstem_conv3x3_fused(const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   const void* res, void* out, int n, int h,
                                   int wd, int cin, int cout, int act,
                                   int res_mode, void* stream) {
  if (bad_args(n, h, wd, cin, cout, act, res_mode, res)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cin % 8 == 0 && cout <= 8) {
    return narrow_out(x, w, scale, shift, res, out, n, h, wd, cin, cout, act,
                      res_mode, stream);
  }
  if (cin <= 7 && cout <= 64) {
    return sstem::conv3x3_narrow_in(x, w, scale, shift, res, out, n, h, wd,
                                    cin, cout, act, res_mode, stream);
  }
  if (cin % 8 != 0 || cout < 16) {
    return sstem_conv3x3_fused_mma(x, w, scale, shift, res, out, n, h, wd, cin,
                                   cout, act, res_mode, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  switch (pad16(cin)) {
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

// the mma.sync design, for the shapes above that no other design takes
// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16 (HWIO); scale, shift
// (cout,) f32; res (n, h, w, cout) bf16 or null; out (n, h, w, cout) bf16.
// cin, cout in [1, 128]; act 0 none, 1 relu, 2 leaky 0.2; res_mode 0 none,
// 1 before the affine, 2 after it.
extern "C" int sstem_conv3x3_fused_mma(const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   const void* res, void* out, int n, int h,
                                   int wd, int cin, int cout, int act,
                                   int res_mode, void* stream) {
  if (bad_args(n, h, wd, cin, cout, act, res_mode, res)) {
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
