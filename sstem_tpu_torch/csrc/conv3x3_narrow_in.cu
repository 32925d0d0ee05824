// conv3x3_fused.cu's narrow_in design: the fused 3x3 convolution (stride 1,
// zero pad 1) + per-channel affine + optional residual + activation, bf16
// NHWC, for inputs of 1 to 7 channels and outputs of up to 64, for Hopper
// (sm_90a). It computes what conv3x3_fused.cu's other designs compute (the
// same epilogue, hopper.cuh: finish_row) and replaces, at these shapes, the
// same Pallas TPU kernel, sstem_tpu/kernels/conv3x3.py::conv3x3_packed,
// which the JAX serving path runs with the real channels zero-padded to its
// packing width (sstem_tpu/models/serving.py: _packed_conv_args,
// pack_nhwc(pad_c=...)). The packed paths run it on the gray-pair first
// convs: 2 -> 32 and 1 -> 64, and the IFNet's 2 -> 6, 6 -> 6, 6 -> 32, all
// at full resolution.
//
// What bounds it on the H100: the bytes. At 4 x 1280^2, 6 -> 32 reads 12
// and writes 64 bytes a pixel (0.149 ms) for 3.5 GFLOP; 1 -> 64 at 2 x
// 1280^2 writes 128 bytes a pixel (0.127 ms) for 3.8 GFLOP.
//
// Design: an implicit GEMM whose K is the 3 x 3 x cin patch, not the
// channels: K = 9 cin padded to 16, 32 or 64 (cin 1; 2-3; 4-7), M = 64
// output pixels of a row, N = cout padded to 8, 32 or 64. With the
// channels as K (the wgmma design), cin 2 would pad to 16 and do 8x the
// tensor work in nine taps, each reading the halo again. A block is one
// warpgroup, persistent over tiles of R output rows x 64 pixels (R = 8, 4,
// 2 for N = 8, 32, 64). A tile's halo (R + 2 rows of 66 pixels) is
// staged as flat runs of 66 cin bf16 a row, zeros outside the image: where
// cin is even by cp.async in 4-byte granules, the next tile's while this
// one computes (two buffers); where it is odd by 2-byte loads, eight in
// flight a thread (a pixel of odd cin starts at an odd element, so no
// 4-byte granule, wider load or TMA box, whose inner extent and strides
// are multiples of 16 bytes, fits it). Staged by a load and a store per
// element, one latency each, the halo set the pace at cin 6. Then one
// output row at a time: each thread builds its wgmma A fragments in
// registers (the register-A form of wgmma.m64nNk16): for its pixels 16
// warp + g and + 8, the im2col values k = 16 kk + 2t, + 1, + 8, + 9, at
// halo offsets computed once a block (16-bit, two a register; a k past 9
// cin reads 0); the row's wgmmas run against the weights, [K][N] K-major
// as B, resident in shared memory; its epilogue (the wgmma design's: the
// plain version's f32 order on the accumulators) writes the row into a
// bf16 staging. The row loop stays rolled: unrolled, the compiler hoisted
// every row's fragment loads and took all 255 registers (spilling at K =
// 64), so that two blocks fit an SM and nothing hid a block's latencies;
// rolled, at most 128 registers let four or more blocks share an SM, and
// one block's halo loads, wgmma waits and stores run while the others
// compute. A tile's rows leave by one TMA store a row where cout % 8 == 0
// (the staging swizzled as the wgmma design's), as contiguous runs of the
// NHWC output copied 16 bytes a thread where cout <= 8 (a dense [pixel]
// [cout] staging: a row of 64 pixels x 6 channels is 768 contiguous
// bytes), else one bf16 at a time; the residual comes in by cp.async
// or by loads into the same staging first.
//
// Shared memory (bytes): staging R x 64 x N x 2 (8192, 16384, 16384)
// + weights K x N x 2 + scale, shift + two halos (R + 2) x 66 x cin_max x 2
// (cin_max 1, 3, 7 for K = 16, 32, 64): 19 to 39 KB a block.

#include "hopper.cuh"

namespace {

using sstem::bf16;
using sstem::smem_addr;
using namespace sstem::hopper;

constexpr int kBlock = 128;  // threads: one warpgroup
constexpr int kBar = 1;      // the warpgroup's named barrier
constexpr uint32_t kNone = 0xffffu;  // an im2col offset past K = 9 cin

template <int KP, int N>
struct Plan {
  static constexpr int kRows = N == 64 ? 2 : (N == 32 ? 4 : 8);
  static constexpr int kHR = kRows + 2;
  static constexpr int kPx = kRows * kTileW;  // staged output pixels
  static constexpr int kCinMax = KP / 9;
  static constexpr int kStaging = 0;  // 1024-aligned for the TMA swizzles
  static constexpr int kWeights = kStaging + kPx * N * 2;
  static constexpr int kScale = kWeights + KP * N * 2;
  static constexpr int kShift = kScale + N * 4;
  static constexpr int kHalo = kShift + N * 4;  // two buffers
  static constexpr int kHaloBytes = (kHR * kPitch * kCinMax * 2 + 15) / 16 * 16;
  static constexpr int kBytes = kHalo + 2 * kHaloBytes;
};

// The halo offset of im2col value k (tap dy, dx and channel ci: k = (3 dy +
// dx) cin + ci, the HWIO weights' order) from the pixel's own staged
// element at tap (0, 0); kNone past K.
__device__ __forceinline__ uint32_t im2col_offset(int k, int cin) {
  if (k >= 9 * cin) return kNone;
  const int dy = k / (3 * cin);
  return static_cast<uint32_t>(k + dy * (kPitch - 3) * cin);
}

// HR rows of 66 pixels of image b from (ys, xs) on, cin channels each,
// into `halo` as flat runs, zeros outside the image. Even cin: by cp.async
// in 4-byte granules (pairs of elements are 4-byte aligned in both; the
// caller commits and waits); odd cin: 2-byte loads, kBatch in flight.
constexpr int kBatch = 8;

__device__ __forceinline__ void stage_halo(bf16* halo,
                                           const bf16* __restrict__ x, int b,
                                           int ys, int xs, int rows, int h,
                                           int wd, int cin) {
  const int run = kPitch * cin;  // elements a halo row
  const int lo = xs < 0 ? -xs * cin : 0;    // the run inside the image:
  const int hi = min(run, (wd - xs) * cin);  // elements [lo, hi)
  auto src = [&](int r, int e) {
    return x + ((static_cast<size_t>(b) * h + ys + r) * wd + xs) * cin + e;
  };
  auto inside = [&](int r, int e) {
    return ys + r >= 0 && ys + r < h && e >= lo && e < hi;
  };
  if (cin % 2 == 0) {
    const int per_row = run / 2;
    const uint32_t dst = smem_addr(halo);
    for (int i = threadIdx.x; i < rows * per_row; i += kBlock) {
      const int r = i / per_row;
      const int e = (i - r * per_row) * 2;
      const bool in = inside(r, e);
      cp_async_ca<4>(dst + 4 * i, in ? src(r, e) : x, in);
    }
    return;
  }
  uint16_t* h16 = reinterpret_cast<uint16_t*>(halo);
  for (int i0 = threadIdx.x; i0 < rows * run; i0 += kBlock * kBatch) {
    unsigned short v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kBlock;
      const int r = i / run;
      const int e = i - r * run;
      v[j] = i < rows * run && inside(r, e)
                 ? __ldg(reinterpret_cast<const unsigned short*>(src(r, e)))
                 : static_cast<unsigned short>(0);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j * kBlock < rows * run) h16[i0 + j * kBlock] = v[j];
    }
  }
}

// The thread's A fragments of one output row (the m16n8k16 A layout of its
// warp's 16 rows): a[kk][0], a[kk][1] the values k = 16 kk + 2t, + 1 of
// pixels p0 = 16 warp + g and p0 + 8, a[kk][2], a[kk][3] those of k + 8,
// + 9; base0, base1 the two pixels' halo elements at tap (0, 0); off[kk][j]
// the offsets of k and k + 1 (j = 0) or k + 8 and k + 9 (j = 1), 16 bits
// each.
template <int KP, bool EVEN>
__device__ __forceinline__ void build_a(uint32_t (&a)[KP / 16][4],
                                        const bf16* halo, int base0, int base1,
                                        const uint32_t (&off)[KP / 16][2]) {
  const uint16_t* h16 = reinterpret_cast<const uint16_t*>(halo);
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t lo = off[kk][j] & 0xffffu;
      if (EVEN) {
        // k and k + 1 are one pixel's channel pair (cin even, k even)
        a[kk][2 * j] = lo == kNone ? 0u : *reinterpret_cast<const uint32_t*>(
                                              h16 + base0 + lo);
        a[kk][2 * j + 1] = lo == kNone ? 0u
                                       : *reinterpret_cast<const uint32_t*>(
                                             h16 + base1 + lo);
      } else {
        const uint32_t hi = off[kk][j] >> 16;
        auto one = [&](int base, uint32_t o) -> uint32_t {
          return o == kNone ? 0u : h16[base + o];
        };
        a[kk][2 * j] = one(base0, lo) | (one(base0, hi) << 16);
        a[kk][2 * j + 1] = one(base1, lo) | (one(base1, hi) << 16);
      }
    }
  }
}

// keeps the compiler from reusing a fragment's registers before the
// wgmma_wait that ends the wgmmas reading them (emits no instruction; the
// next row's fragments go into the same registers)
template <int KK>
__device__ __forceinline__ void hold(const uint32_t (&a)[KK][4]) {
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][j]) : "memory");
}

// res_mode: 0 none, 1 added before the affine, 2 after it (both before act)
template <int KP, int N>
__global__ void __launch_bounds__(kBlock, N == 8 ? 6 : 4)
conv3x3_narrow_in_kernel(const __grid_constant__ CUtensorMap omap,
                         const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         const bf16* __restrict__ res, bf16* __restrict__ out,
                         int h, int wd, int cin, int cout, int act,
                         int res_mode, int tiles_x, int tiles_y, int tiles) {
  using P = Plan<KP, N>;
  constexpr int R = P::kRows;
  constexpr bool kDense = N == 8;  // cout <= 8: the dense staging
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* staging = smem + P::kStaging;
  bf16* w_s = reinterpret_cast<bf16*>(smem + P::kWeights);
  float* sc = reinterpret_cast<float*>(smem + P::kScale);
  float* sh = reinterpret_cast<float*>(smem + P::kShift);
  const int wt = threadIdx.x;
  const int warp = wt / 32;
  const int g = (wt % 32) / 4;
  const int t = wt % 4;

  // B: the weights as [K / 8][N][8], K = (3 dy + dx) cin + ci, zero past
  // 9 cin and cout
  load_weights_kmajor<KP, N>(w_s, w, 1, 9 * cin, cout, 0);
  for (int i = wt; i < N; i += kBlock) {
    sc[i] = i < cout ? scale[i] : 0.f;
    sh[i] = i < cout ? shift[i] : 0.f;
  }
  fence_proxy_async();  // the weights, visible to the wgmmas
  __syncthreads();
  Affine<N> aff;
  aff.load(sc, sh, t);
  uint32_t off[KP / 16][2];
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 16 * kk + 8 * j + 2 * t;
      off[kk][j] = im2col_offset(k, cin) | (im2col_offset(k + 1, cin) << 16);
    }
  const uint64_t b_desc = gmma_desc(smem_addr(w_s), N * 16, 128);
  const bool even = cin % 2 == 0;

  auto where = [&](int tile, int& b, int& y0, int& x0) {
    const int rest = tile / tiles_x;
    x0 = (tile - rest * tiles_x) * kTileW;
    b = rest / tiles_y;
    y0 = (rest - b * tiles_y) * R;
  };
  // the halo of the block's n-th tile goes to buffer n % 2; even cin stages
  // the next tile's by cp.async while this one computes
  auto stage = [&](int tile, int n) {
    if (tile >= tiles) return;
    int b, y0, x0;
    where(tile, b, y0, x0);
    stage_halo(reinterpret_cast<bf16*>(smem + P::kHalo + (n & 1) * P::kHaloBytes),
               x, b, y0 - 1, x0 - 1, R + 2, h, wd, cin);
    cp_async_commit();
  };
  if (even) stage(blockIdx.x, 0);

  for (int tile = blockIdx.x, n = 0; tile < tiles; tile += gridDim.x, ++n) {
    int b, y0, x0;
    where(tile, b, y0, x0);
    const bf16* halo =
        reinterpret_cast<const bf16*>(smem + P::kHalo + (n & 1) * P::kHaloBytes);
    if (even) {
      cp_async_wait<0>();  // this thread's pieces of this tile's halo
    } else {
      stage(tile, n);
    }
    if (!kDense && wt == 0) bulk_wait_read();  // the last tile's stores
    __syncthreads();  // the halo is staged, the staging and the other
                      // halo buffer free
    if (even) stage(tile + gridDim.x, n + 1);
    if (res_mode) {   // the residual rows into the staging
      if (kDense) {
        load_dense_rows<R>(staging, res, b, y0, x0, h, wd, cout, wt);
      } else {
        const int px = min(kTileW, wd - x0);
        for (int r = 0; r < R && y0 + r < h; ++r) {
          global_to_staging<N>(
              staging + r * kTileW * Staging<N>::kRowBytes, P::kPx,
              res + ((static_cast<size_t>(b) * h + y0 + r) * wd + x0) * cout,
              px, cout, cout, wt);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
    }

    // one output row at a time: its fragments, its wgmmas (other blocks'
    // rows run while this one waits), its epilogue into the staging
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      uint32_t a[KP / 16][4];
      const int base0 = (r * kPitch + warp * 16 + g) * cin;
      if (even) {
        build_a<KP, true>(a, halo, base0, base0 + 8 * cin, off);
      } else {
        build_a<KP, false>(a, halo, base0, base0 + 8 * cin, off);
      }
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      wgmma_fence();  // the fragment's and accumulators' registers
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        wgmma_m64k16_rs(acc, a[kk], b_desc + 2 * kk * N);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      hold(a);
      dispatch_epilogue(act, res_mode, [&](auto act_c, auto res_c) {
        constexpr int ACT = decltype(act_c)::value;
        constexpr int RES = decltype(res_c)::value;
        if constexpr (kDense) {
          finish_row_dense<ACT, RES>(acc, staging + r * kTileW * cout * 2,
                                     cout, warp, g, t, aff);
        } else {
          finish_row<N, ACT, RES>(acc, staging, P::kPx, r * kTileW, warp, g,
                                  t, aff);
        }
      });
    }
    if constexpr (kDense) {
      store_dense_rows<R>(staging, out, b, y0, x0, h, wd, cout, kBar, wt);
    } else {
      store_rows<N, R>(&omap, staging, out, b, y0, x0, h, wd, cout, 0, cout,
                       kBar, wt);
    }
  }
  if (wt == 0) bulk_wait_read();  // the stores' sources
}

template <int KP, int N>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, void* out, int n, int h,
                   int wd, int cin, int cout, int act, int res_mode,
                   cudaStream_t stream) {
  using P = Plan<KP, N>;
  auto kernel = conv3x3_narrow_in_kernel<KP, N>;
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + P::kRows - 1) / P::kRows;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap omap = {};
  cudaError_t err = cudaSuccess;
  if (N > 8 && cout % 8 == 0) {
    err = make_out_map(&omap, out, n, h, wd, cout, Staging<N>::kBox, kTileW);
    if (err != cudaSuccess) return err;
  }
  int grid = 0;
  err = sstem::persistent_grid(kernel, kBlock, P::kBytes, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlock, P::kBytes, stream>>>(
      omap, static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale,
      shift, static_cast<const bf16*>(res), static_cast<bf16*>(out), h, wd, cin,
      cout, act, res_mode, tiles_x, tiles_y, static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_n(const void* x, const void* w, const float* sc,
                     const float* sh, const void* res, void* out, int n, int h,
                     int wd, int cin, int cout, int act, int res_mode,
                     cudaStream_t s) {
  if (cout <= 8) {
    return launch<KP, 8>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                         res_mode, s);
  }
  if (cout <= 32) {
    return launch<KP, 32>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                          res_mode, s);
  }
  return launch<KP, 64>(x, w, sc, sh, res, out, n, h, wd, cin, cout, act,
                        res_mode, s);
}

}  // namespace

// x (n, h, w, cin) bf16; w (3, 3, cin, cout) bf16 (HWIO); scale, shift
// (cout,) f32; res (n, h, w, cout) bf16 or null; out (n, h, w, cout) bf16.
// cin in [1, 7], cout in [1, 64] (any other shape cudaErrorInvalidValue);
// act 0 none, 1 relu, 2 leaky 0.2; res_mode 0 none, 1 before the affine, 2
// after it. sstem_conv3x3_fused (conv3x3_fused.cu) launches it at these
// shapes; it has no C entry point of its own.
namespace sstem {

int conv3x3_narrow_in(const void* x, const void* w, const void* scale,
                      const void* shift, const void* res, void* out, int n,
                      int h, int wd, int cin, int cout, int act, int res_mode,
                      void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cin > 7 || cout < 1 ||
      cout > 64 || act < 0 || act > 2 || res_mode < 0 || res_mode > 2 ||
      (res_mode != 0 && res == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int k = 9 * cin;
  if (k <= 16) {
    return static_cast<int>(launch_n<16>(x, w, sc, sh, res, out, n, h, wd, cin,
                                         cout, act, res_mode, s));
  }
  if (k <= 32) {
    return static_cast<int>(launch_n<32>(x, w, sc, sh, res, out, n, h, wd, cin,
                                         cout, act, res_mode, s));
  }
  return static_cast<int>(launch_n<64>(x, w, sc, sh, res, out, n, h, wd, cin,
                                       cout, act, res_mode, s));
}

}  // namespace sstem
