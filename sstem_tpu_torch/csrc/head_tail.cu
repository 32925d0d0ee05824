// Fused align-corners 2x bilinear upsample + 3x3 conv (stride 1, zero pad 1)
// + bias, the tail of each IFNet kernel head, for Hopper (sm_90a). bf16 NHWC
// half-resolution features in, bf16 planar (N, K, 2Hi, 2Wi) tap maps out,
// the layout the sepconv kernel reads.
//
// Replaces the Pallas TPU kernel sstem_tpu/kernels/head_tail.py::
// head_tail_fused (body _kernel) with dephase_transpose. Semantics:
//
//   up  = bf16(upsample2x_align_corners(x))     (f32 lerps, rounded once)
//   out = bf16(conv3x3(up, w3) + b3)            (f32 sums and bias)
//
// The upsampled values are rounded to bf16 before the conv, where the TPU
// kernel rounds its staged rows. The lerp is PyTorch's upsample_bilinear2d
// with align_corners=True: src = dst * (in - 1) / (out - 1) in f32, the
// second tap clamped at the last row and column.
//
// What bounds it on the H100: per head and group of 4 sections at 640^2 ->
// 1280^2 with K = 51 it reads 0.21 GB (64-channel features) and writes
// 0.67 GB of maps, ~0.26 ms, and does 307 GFLOP of conv at 51 x 51
// channels, 0.310 ms on the tensor cores: operations bound it, with the
// bytes close behind, so the output stream has to overlap the MMAs.
//
// Two designs, picked by shape in sstem_head_tail (never on failure):
//
// wgmma (Cx % 8 == 0, Wi % 4 == 0, K <= 56; the heads of the fused path):
// a persistent, warp-specialized block on hopper.cuh's pieces. A tile is 4
// output rows x 64 columns. One thread of a producer warpgroup TMA-loads
// the tile's half-resolution source, 5 rows x 35 columns x 64 channels
// (zeros past the image and past Cx), into the ring stage of the consumer
// warpgroup that owns the tile (two stages, one per consumer; the
// consumers take alternate tiles; setmaxnreg gives the producer's
// registers to them). The consumer upsamples in shared memory, from that
// stage into its [Cin/8][pixel][8] halo of 6 x 66 upsampled pixels (zero
// outside the image: the conv's padding at full resolution; channels >=
// Cin zero), so each half-resolution pixel is read from device memory
// about once and the full-resolution upsampled tensor never exists. The
// lerp weights follow each output row and column (align corners is not a
// fixed 0.25 / 0.75 stencil); an odd row and the even row below it read
// the same two source rows, and likewise columns, so a thread takes 2 x 2
// pixels of one 8-channel chunk and loads their four corners once. Then
// the tile's wgmma.m64n56k16: M = 64 pixels of a row, N = 56 output
// channels (K = 51 pads to 56, not 64), K = 16 input channels (Cin 51
// pads to 64) of one tap, each tap's A operand an address offset into the
// halo; all nine taps' weights stay resident. The epilogue adds the bias,
// rounds to bf16 and writes each output row's [channel][64 pixels] into a
// 128-byte-swizzled staging (the halo buffer, free once the wgmmas are
// done), from which one TMA store a row sends 128-byte runs of each
// channel plane of the (N, K, 2Hi, 2Wi) output (channels past K and
// pixels past the edge clipped). One consumer's upsample and epilogue run
// while the other's wgmmas do. Shared memory: weights 64512 + 2 x 22400
// ring + 2 x 51200 halo / staging. The warpgroup index is broadcast from
// lane 0 and the tap loop stays rolled: without either, ptxas serializes
// the wgmmas (warning C7520) or spills their descriptors.
//
// What holds it back (chip_smoke.py's readings, PERF.md): shared-memory
// bandwidth. Each m64n56k16 reads its A (2 KB) and B (1.8 KB) from
// shared memory, about as fast as the SM delivers them, and the
// consumers' upsample, whose shared-memory loads and stores wait behind
// them, then sits on each consumer's critical path.
//
// mma.sync (the other shapes, sstem_head_tail_mma): the first port's
// design, the implicit GEMM of conv_tile.cuh over 8 x 16 output tiles
// whose 10 x 18 upsampled halo each block rebuilds from device memory
// (four 16-byte loads a pixel and 8-channel chunk), staged synchronously,
// channels and K padded to 64, the planar output stored a channel at a
// time. The TPU kernel's phase split, lane rolls and phase-planar output
// existed for the TPU's (8, 128) tiling and are not carried over; any
// Hi, Wi >= 1 is taken.

#include "hopper.cuh"

namespace {

using sstem::bf16;

constexpr int kTH = 8;   // output rows per tile
constexpr int kTW = 16;  // output cols per tile (one M-block)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTH / kWarps;
constexpr int kSH = kTH + 2;
constexpr int kSW = kTW + 2;
constexpr int kCP = 64;  // channels (in and out) padded in shared memory

constexpr size_t kSmem =
    static_cast<size_t>(9 * kCP + kSH * kSW) * (kCP + 8) * sizeof(bf16);

struct Lerp {
  int i0, i1;    // the two source indices
  float l0, l1;  // their weights
};

// PyTorch's align_corners=True source index for output index o (o in range).
__device__ __forceinline__ Lerp lerp_taps(int o, int in, float scale) {
  const float src = scale * static_cast<float>(o);
  const int i0 = static_cast<int>(src);
  const int step = i0 < in - 1 ? 1 : 0;
  Lerp r;
  r.i0 = i0;
  r.i1 = i0 + step;
  r.l1 = src - static_cast<float>(i0);
  r.l0 = 1.f - r.l1;
  return r;
}

// The upsampled halo tile of output rows [ys, ys + kSH) and cols
// [xs, xs + kSW) into shared [pixel][kCP + 8]; zero outside the image and for
// channels >= cin. x is (n, hi, wi, cx) with cx >= cin channels.
__device__ void load_upsampled(bf16* in_s, const bf16* __restrict__ x, int b,
                               int ys, int xs, int hi, int wi, int cx, int cin,
                               float sy, float sx, bool vec) {
  constexpr int KS = kCP + 8;
  constexpr int CH = kCP / 8;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  for (int i = threadIdx.x; i < kSH * kSW * CH; i += blockDim.x) {
    const int c8 = i % CH;
    const int p = i / CH;
    const int oy = ys + p / kSW;
    const int ox = xs + p % kSW;
    sstem::Pack8 v;
    v.u = make_uint4(0, 0, 0, 0);
    if (oy >= 0 && oy < ho && ox >= 0 && ox < wo && c8 * 8 < cin) {
      const Lerp ly = lerp_taps(oy, hi, sy);
      const Lerp lx = lerp_taps(ox, wi, sx);
      const bf16* base = x + static_cast<size_t>(b) * hi * wi * cx + c8 * 8;
      const bf16* p00 = base + (static_cast<size_t>(ly.i0) * wi + lx.i0) * cx;
      const bf16* p01 = base + (static_cast<size_t>(ly.i0) * wi + lx.i1) * cx;
      const bf16* p10 = base + (static_cast<size_t>(ly.i1) * wi + lx.i0) * cx;
      const bf16* p11 = base + (static_cast<size_t>(ly.i1) * wi + lx.i1) * cx;
      sstem::Pack8 a, bb, c, d;
      if (vec) {
        a.u = __ldg(reinterpret_cast<const uint4*>(p00));
        bb.u = __ldg(reinterpret_cast<const uint4*>(p01));
        c.u = __ldg(reinterpret_cast<const uint4*>(p10));
        d.u = __ldg(reinterpret_cast<const uint4*>(p11));
      } else {
        a.u = bb.u = c.u = d.u = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c8 * 8 + j < cx) {
            a.h[j] = p00[j];
            bb.h[j] = p01[j];
            c.h[j] = p10[j];
            d.h[j] = p11[j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c8 * 8 + j < cin) {
          const float top = lx.l0 * __bfloat162float(a.h[j]) +
                            lx.l1 * __bfloat162float(bb.h[j]);
          const float bot = lx.l0 * __bfloat162float(c.h[j]) +
                            lx.l1 * __bfloat162float(d.h[j]);
          v.h[j] = __float2bfloat16(ly.l0 * top + ly.l1 * bot);
        }
      }
    }
    *reinterpret_cast<uint4*>(in_s + p * KS + c8 * 8) = v.u;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
head_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int hi, int wi, int cx, int cin, int k, int tiles_x,
                 int tiles_y, long long tiles, float sy, float sx, bool vec) {
  constexpr int KS = kCP + 8;
  constexpr int NB = kCP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* in_s = w_s + 9 * kCP * KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const size_t plane = static_cast<size_t>(ho) * wo;

  sstem::load_weights<kCP, kCP>(w_s, w, 9, cin, k);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = static_cast<int>(rest % tiles_y);
    const int b = static_cast<int>(rest / tiles_y);
    const int y0 = ty * kTH;
    const int x0 = tx * kTW;

    __syncthreads();
    load_upsampled(in_s, x, b, y0 - 1, x0 - 1, hi, wi, cx, cin, sy, sx, vec);
    __syncthreads();

    float acc[kRowsPerWarp][NB][4];
    sstem::zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      sstem::mma_tap<kCP, kCP, kRowsPerWarp>(
          acc, in_s + ((warp * kRowsPerWarp + dy) * kSW + dx) * KS, kSW * KS,
          w_s + tap * kCP * KS, lane);
    }

    bf16* img = out + static_cast<size_t>(b) * k * plane;
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int oy = y0 + warp * kRowsPerWarp + m;
      if (oy >= ho) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + g + half * 8;
        if (ox >= wo) continue;
        bf16* dst = img + static_cast<size_t>(oy) * wo + ox;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int co = nb * 8 + 2 * t + j;
            if (co < k) {
              dst[co * plane] = __float2bfloat16(
                  __fadd_rn(acc[m][nb][2 * half + j], __ldg(bias + co)));
            }
          }
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// the wgmma design
// ---------------------------------------------------------------------------

namespace wg {

using namespace sstem::hopper;
using sstem::smem_addr;

// two consumer warpgroups and a producer warpgroup, of which one thread
// issues the loads: a warpgroup, so that setmaxnreg can hand the
// producer's registers to the consumers (at 288 or 384 threads ptxas caps
// every thread at 168, and the consumers' 112 accumulators spill there)
constexpr int kBlock = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536,
              "registers");
constexpr int kRows = 4;                      // output rows per tile
constexpr int kN = 56;                        // wgmma N: output channels
constexpr int kCinP = 64;                     // input channels, padded
constexpr int kUpRows = kRows + 2;            // upsampled halo rows
constexpr int kUpPixels = kUpRows * kPitch;   // halo pixels, rows of 66
// one 8-channel chunk of the halo: an odd number of 16-byte units, so the
// 8 chunks of one pixel fall in distinct bank groups
constexpr int kChunk = kUpPixels * 16 + 16;
constexpr int kUpBytes = (8 * kChunk + 1023) / 1024 * 1024;
constexpr int kSrcRows = kRows / 2 + 3;       // half-resolution rows a tile reads
constexpr int kSrcCols = kTileW / 2 + 3;      // and columns
constexpr int kSrcBytes = kSrcRows * kSrcCols * 128;  // [row][col][64 ch]
constexpr int kStagingRow = kN * 128;         // [channel][64 pixels] bf16
// shared memory: weights [tap][8][kN][8], ring, halo / staging, barriers
constexpr int kRing = 9 * kCinP * kN * 2;
constexpr int kUp = (kRing + kConsumers * kSrcBytes + 1023) / 1024 * 1024;
constexpr int kFull = kUp + kConsumers * kUpBytes;
constexpr int kEmpty = kFull + kConsumers * 8;
constexpr int kBytes = kEmpty + kConsumers * 8;
static_assert(kBytes <= 232448, "more shared memory than a block has");
static_assert(kRows * kStagingRow <= kUpBytes, "staging outgrows the halo");
static_assert((kChunk / 16) % 2 == 1, "chunk stride");

__device__ __forceinline__ void unpack8(const unsigned char* p, float (&f)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// f32 lerps of 8 channels, rounded to bf16 in pairs (one packed
// conversion a pair); channels from `live` on are zero
__device__ __forceinline__ uint4 lerp8(const float (&top)[8],
                                       const float (&bot)[8], const Lerp& ly,
                                       int live) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = j < live ? ly.l0 * top[j] + ly.l1 * bot[j] : 0.f;
  }
  return make_uint4(pack2u(v[0], v[1]), pack2u(v[2], v[3]),
                    pack2u(v[4], v[5]), pack2u(v[6], v[7]));
}

// The upsampled halo of output rows ys.. (kUpRows) and columns xs..
// (kPitch) from the half-resolution tile src ([row][col][64 ch], origin
// (r0, c0)) into up ([chunk][pixel][8], chunk stride kChunk, kPitch
// pixels a row); zero outside the image and for channels >= cin. A thread
// takes a column pair and one chunk at a time and walks the three row
// pairs: ys and xs are odd, and an odd output index and the even one after
// it interpolate between the same two source indices, so each 2 x 2 block
// of pixels shares its four corners and each column its horizontal lerps
// (PyTorch's order: the two rows' horizontal lerps, then the vertical
// one). The rows' lerps are computed once a tile, the columns' once a
// column pair. Blocks at the image's edges take the pixels one by one.
// The chunks past cin are written as zeros.
__device__ __forceinline__ void upsample(unsigned char* __restrict__ up,
                                         const unsigned char* __restrict__ src,
                                         int ys, int xs, int r0, int c0,
                                         int hi, int wi, int cin, float sy,
                                         float sx, int wt) {
  constexpr int kPairs = kPitch / 2;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const int chunks = min((cin + 7) / 8, 8);  // chunks holding channels
  for (int i = wt; i < (8 - chunks) * kUpPixels; i += 128) {
    *reinterpret_cast<uint4*>(up + chunks * kChunk + i / kUpPixels * kChunk +
                              i % kUpPixels * 16) = make_uint4(0, 0, 0, 0);
  }
  Lerp ly[kUpRows];
  bool in_y[kUpRows];
#pragma unroll
  for (int j = 0; j < kUpRows; ++j) {
    const int oy = ys + j;
    in_y[j] = oy >= 0 && oy < ho;
    ly[j] = lerp_taps(in_y[j] ? oy : 0, hi, sy);
  }
  for (int item = wt; item < kPairs * chunks; item += 128) {
    const int ch = item % chunks;
    const int pc = item / chunks;
    const int live = min(cin - 8 * ch, 8);  // channels of the chunk
    const unsigned char* s0 = src + ch * 16;
    Lerp lx[2];
    bool in_x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ox = xs + 2 * pc + j;
      in_x[j] = ox >= 0 && ox < wo;
      lx[j] = lerp_taps(in_x[j] ? ox : 0, wi, sx);
    }
    const bool cols = in_x[0] && in_x[1] && lx[0].i0 == lx[1].i0 &&
                      lx[0].i1 == lx[1].i1;
    auto corner = [&](int iy, int ix, float (&f)[8]) {
      unpack8(s0 + ((iy - r0) * kSrcCols + ix - c0) * 128, f);
    };
#pragma unroll
    for (int pr = 0; pr < kUpRows / 2; ++pr) {
      const Lerp& y0 = ly[2 * pr];
      const Lerp& y1 = ly[2 * pr + 1];
      unsigned char* dst =
          up + ch * kChunk + (2 * pr * kPitch + 2 * pc) * 16;
      if (cols && in_y[2 * pr] && in_y[2 * pr + 1] && y0.i0 == y1.i0 &&
          y0.i1 == y1.i1) {
        float a[8], b[8], c[8], d[8];
        corner(y0.i0, lx[0].i0, a);
        corner(y0.i0, lx[0].i1, b);
        corner(y0.i1, lx[0].i0, c);
        corner(y0.i1, lx[0].i1, d);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float top[8], bot[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            top[j] = lx[cc].l0 * a[j] + lx[cc].l1 * b[j];
            bot[j] = lx[cc].l0 * c[j] + lx[cc].l1 * d[j];
          }
          *reinterpret_cast<uint4*>(dst + cc * 16) = lerp8(top, bot, y0, live);
          *reinterpret_cast<uint4*>(dst + (kPitch + cc) * 16) =
              lerp8(top, bot, y1, live);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const Lerp& yy = rr == 0 ? y0 : y1;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (in_y[2 * pr + rr] && in_x[cc]) {
              float a[8], b[8], c[8], d[8], top[8], bot[8];
              corner(yy.i0, lx[cc].i0, a);
              corner(yy.i0, lx[cc].i1, b);
              corner(yy.i1, lx[cc].i0, c);
              corner(yy.i1, lx[cc].i1, d);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                top[j] = lx[cc].l0 * a[j] + lx[cc].l1 * b[j];
                bot[j] = lx[cc].l0 * c[j] + lx[cc].l1 * d[j];
              }
              v = lerp8(top, bot, yy, live);
            }
            *reinterpret_cast<uint4*>(dst + (rr * kPitch + cc) * 16) = v;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock, 1)
head_tail_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap omap,
                       const bf16* __restrict__ w,
                       const float* __restrict__ bias, int hi, int wi,
                       int cin, int k, int tiles_x, int tiles_y, int tiles,
                       float sy, float sx) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + kEmpty);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConsumers; ++s) {
      mbar_init(&full[s], 1);      // the producer's arrival (+ TMA bytes)
      mbar_init(&empty[s], 128);   // the consumer warpgroup's threads
    }
  }
  load_weights_kmajor<kCinP, kN>(reinterpret_cast<bf16*>(smem), w, 9, cin, k,
                                 0);
  fence_proxy_async();
  __syncthreads();

  const int ho = 2 * hi;
  const int blk = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = blk < tiles ? (tiles - 1 - blk) / grid + 1 : 0;
  auto where = [&](int tile, int& b, int& y0, int& x0) {
    const int rest = tile / tiles_x;
    x0 = (tile - rest * tiles_x) * kTileW;
    b = rest / tiles_y;
    y0 = (rest - b * tiles_y) * kRows;
  };
  // the first half-resolution row and column that output rows y0 - 1..
  // and columns x0 - 1.. interpolate from
  auto source = [&](int y0, int x0, int& r0, int& c0) {
    r0 = lerp_taps(max(y0 - 1, 0), hi, sy).i0;
    c0 = lerp_taps(max(x0 - 1, 0), wi, sx).i0;
  };
  // the warpgroup (kConsumers: the producer), broadcast from lane 0 so
  // that the compiler sees it uniform over the warp: otherwise it takes the
  // wgmmas below for a divergent path and serializes them
  const int c = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (c == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % 128 != 0) return;
    // tile j goes to consumer j % 2, through its own stage
    for (int j = 0; j < mine; ++j) {
      const int s = j % kConsumers;
      // a fresh barrier passes a wait on parity 1: the first round is free
      mbar_wait(&empty[s], static_cast<uint32_t>(((j / kConsumers) & 1) ^ 1));
      int b, y0, x0, r0, c0;
      where(blk + j * grid, b, y0, x0);
      source(y0, x0, r0, c0);
      mbar_arrive_expect_tx(&full[s], kSrcBytes);
      tma_load_4d(smem_addr(smem + kRing + s * kSrcBytes), &xmap, 0, c0, r0, b,
                  &full[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int g = (wt % 32) / 4;
  const int t = wt % 4;
  const unsigned char* src = smem + kRing + c * kSrcBytes;
  unsigned char* up = smem + kUp + c * kUpBytes;
  const uint64_t a_desc = gmma_desc(smem_addr(up), kChunk, 128);
  const uint64_t b_desc = gmma_desc(smem_addr(smem), kN * 16, 128);
  const int bar = 1 + c;  // named barrier of this consumer warpgroup
  // the bias of the thread's accumulator columns 8i + 2t and 8i + 2t + 1
  float bv[kN / 8][2];
#pragma unroll
  for (int i = 0; i < kN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = 8 * i + 2 * t + j;
      bv[i][j] = co < k ? __ldg(bias + co) : 0.f;
    }
  float acc[kRows][kN / 2];
  for (int lt = c, n = 0; lt < mine; lt += kConsumers, ++n) {
    int b, y0, x0, r0, c0;
    where(blk + lt * grid, b, y0, x0);
    source(y0, x0, r0, c0);
    if (wt == 0) bulk_wait_read();  // the last tile's stores have read `up`
    named_bar(bar, 128);
    mbar_wait(&full[c], static_cast<uint32_t>(n & 1));
    upsample(up, src, y0 - 1, x0 - 1, r0, c0, hi, wi, cin, sy, sx, wt);
    mbar_arrive(&empty[c]);
    fence_proxy_async();  // the halo, visible to the wgmmas
    named_bar(bar, 128);

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[r][i] = 0.f;
    // each operand's descriptor is its first one plus the operand's offset
    // in 16-byte units (the start address field, bits 0-13); the tap loop
    // stays rolled, so the 144 descriptors are not all held in registers
    wgmma_fence();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t a_tap =
          a_desc + (tap / 3) * kPitch + tap % 3;
      const uint64_t b_tap = b_desc + tap * (kCinP / 8) * kN;
#pragma unroll
      for (int kk = 0; kk < kCinP / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          wgmma_m64k16(acc[r], a_tap + (2 * kk * kChunk) / 16 + r * kPitch,
                       b_tap + 2 * kk * kN);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kRows; ++r) fence_operands(acc[r]);
    named_bar(bar, 128);  // every warp's wgmmas are done with the halo

    // the staging of row r: [channel][64 pixels], 16-byte chunks swizzled
    // by the channel (TMA's 128-byte swizzle), so a warp's 2-byte writes
    // (8 pixels x 4 channel pairs) fall in distinct banks
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      unsigned char* st = up + r * kStagingRow;
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = warp * 16 + g + 8 * half;
          // the channel pair rounded by one packed conversion, stored to
          // the pair's two channel rows
          const uint32_t pair =
              pack2u(__fadd_rn(acc[r][4 * i + 2 * half], bv[i][0]),
                     __fadd_rn(acc[r][4 * i + 2 * half + 1], bv[i][1]));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ch = 8 * i + 2 * t + j;
            *reinterpret_cast<uint16_t*>(
                st + ch * 128 + (((px >> 3) ^ (ch & 7)) << 4) + (px & 7) * 2) =
                static_cast<uint16_t>(j == 0 ? pair : pair >> 16);
          }
        }
      }
    }
    fence_proxy_async();  // the staging, visible to the TMA stores
    named_bar(bar, 128);
    if (wt == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (y0 + r < ho) {
          tma_store_4d(&omap, up + r * kStagingRow, x0, y0 + r, 0, b);
        }
      }
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait_read();  // the stores' sources
}

// The tensor maps: x (n, hi, wi, cx) in boxes of 64 channels x kSrcCols x
// kSrcRows (zeros past the tensor), out (n, k, ho, wo) in boxes of 64
// pixels x 1 row x kN channels, 128-byte swizzled (clipped at the tensor).
cudaError_t make_maps(CUtensorMap* xmap, CUtensorMap* omap, const void* x,
                      void* out, int n, int hi, int wi, int cx, int k) {
  Encode encode = nullptr;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cx),
                               static_cast<cuuint64_t>(wi),
                               static_cast<cuuint64_t>(hi),
                               static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(cx) * 2,
                                  static_cast<cuuint64_t>(wi) * cx * 2,
                                  static_cast<cuuint64_t>(hi) * wi * cx * 2};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(kCinP),
                              static_cast<cuuint32_t>(kSrcCols),
                              static_cast<cuuint32_t>(kSrcRows), 1};
  CUresult r = encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(x), xdims, xstrides, xbox, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const cuuint64_t odims[4] = {static_cast<cuuint64_t>(wo),
                               static_cast<cuuint64_t>(ho),
                               static_cast<cuuint64_t>(k),
                               static_cast<cuuint64_t>(n)};
  const cuuint64_t ostrides[3] = {static_cast<cuuint64_t>(wo) * 2,
                                  static_cast<cuuint64_t>(ho) * wo * 2,
                                  static_cast<cuuint64_t>(k) * ho * wo * 2};
  const cuuint32_t obox[4] = {static_cast<cuuint32_t>(kTileW), 1,
                              static_cast<cuuint32_t>(kN), 1};
  r = encode(omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, odims, ostrides,
             obox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int n, int hi, int wi, int cx, int cin, int k,
                   cudaStream_t stream) {
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const int tiles_x = (wo + kTileW - 1) / kTileW;
  const int tiles_y = (ho + kRows - 1) / kRows;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap xmap, omap;
  cudaError_t err = make_maps(&xmap, &omap, x, out, n, hi, wi, cx, k);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = sstem::persistent_grid(head_tail_wgmma_kernel, kBlock, kBytes, tiles,
                               &grid);
  if (err != cudaSuccess) return err;
  // align_corners scale, as PyTorch computes it: (in - 1) / (out - 1) in f32
  const float sy = static_cast<float>(hi - 1) / static_cast<float>(ho - 1);
  const float sx = static_cast<float>(wi - 1) / static_cast<float>(wo - 1);
  head_tail_wgmma_kernel<<<grid, kBlock, kBytes, stream>>>(
      xmap, omap, static_cast<const bf16*>(w), static_cast<const float*>(bias),
      hi, wi, cin, k, tiles_x, tiles_y, static_cast<int>(tiles), sy, sx);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// defined below
extern "C" int sstem_head_tail_mma(const void* x, const void* w,
                                   const void* bias, void* out, int n,
                                   int hi, int wi, int cx, int cin, int k,
                                   void* stream);

// x (n, hi, wi, cx) bf16 half-resolution features, of which the first cin
// channels are the conv's input; w (3, 3, cin, k) bf16 (HWIO); bias (k,)
// f32; out (n, k, 2hi, 2wi) bf16. cin <= cx <= 64 and k <= 64. The wgmma
// design takes cx % 8 == 0, wi % 4 == 0, k <= 56 and 16-byte aligned x and
// out (kernels/head_tail.py: design), the mma.sync design the rest.
extern "C" int sstem_head_tail(const void* x, const void* w, const void* bias,
                               void* out, int n, int hi, int wi, int cx,
                               int cin, int k, void* stream) {
  if (n < 1 || hi < 1 || wi < 1 || cin < 1 || cx < cin || cx > kCP || k < 1 ||
      k > kCP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (cx % 8 != 0 || wi % 4 != 0 || k > wg::kN || !aligned) {
    return sstem_head_tail_mma(x, w, bias, out, n, hi, wi, cx, cin, k, stream);
  }
  return static_cast<int>(wg::launch(x, w, bias, out, n, hi, wi, cx, cin, k,
                                     static_cast<cudaStream_t>(stream)));
}

// x (n, hi, wi, cx) bf16 half-resolution features, of which the first cin
// channels are the conv's input; w (3, 3, cin, k) bf16 (HWIO); bias (k,)
// f32; out (n, k, 2hi, 2wi) bf16. cin <= cx <= 64 and k <= 64. The
// mma.sync design, at any shape.
extern "C" int sstem_head_tail_mma(const void* x, const void* w,
                                   const void* bias, void* out, int n,
                                   int hi, int wi, int cx, int cin, int k,
                                   void* stream) {
  if (n < 1 || hi < 1 || wi < 1 || cin < 1 || cx < cin || cx > kCP || k < 1 ||
      k > kCP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = 2 * hi;
  const int wo = 2 * wi;
  const int tiles_x = (wo + kTW - 1) / kTW;
  const int tiles_y = (ho + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  int grid = 0;
  cudaError_t err = sstem::persistent_grid(head_tail_kernel, kWarps * 32,
                                           kSmem, tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  // align_corners scale, as PyTorch computes it: (in - 1) / (out - 1) in f32
  const float sy = static_cast<float>(hi - 1) / static_cast<float>(ho - 1);
  const float sx = static_cast<float>(wi - 1) / static_cast<float>(wo - 1);
  const bool vec = cx % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  head_tail_kernel<<<grid, kWarps * 32, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), hi, wi, cx, cin,
      k, tiles_x, tiles_y, tiles, sy, sx, vec);
  return static_cast<int>(cudaGetLastError());
}
