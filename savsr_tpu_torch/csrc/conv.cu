// Fused KxK convolution (K = 1 or 3, zero padding) with epilogue — kernels 1
// and 2 of the serving path.
//
// Replaces savsr_tpu/ops/pallas/chw_conv.py::conv3x3_chw (and the Cin
// chunking of conv3x3_chw_parts) and ::conv1x1_chw. Semantics per output
// (b, co, y, x), accumulated in f32 over the concatenated input channels:
//     v = sum_{ci,dy,dx} W[co, ci, dy, dx] * X[ci, y+dy-K/2, x+dx-K/2]
//     v += bias[co]; v += pre_add; v *= out_scale[co]; v = a*v + b*|v|;
//     v += residual;  out = v (rounded to the I/O type)
//
// Bound on the H100: at the main-path shapes (180x320, Cin 64..320, Cout
// 64/128) a 3x3 conv does 2*9*Cin*Cout FLOPs per pixel against (Cin + Cout)
// values moved per pixel. In f32, held to the 67 TFLOP/s CUDA-core rate
// (the strict tier must not use TF32), it is bound by operations. In bf16,
// held to the 989 TFLOP/s tensor-core rate, 64->64 sits at the ridge
// (~290 FLOP per byte) and the wider convs are bound by operations.
//
// Two kernels, one per type:
//
// * f32 (conv_fused_kernel, CUDA cores): a block computes a 64-channel x
//   8-row x 32-column output tile, each warp 8 output channels, each lane
//   one column of 8 rows (64 accumulators). Input channels stream through
//   shared memory 8 at a time with their halo; weights for the 8 channels
//   and 64 outputs are broadcast from shared memory.
//
// * bf16 (conv_wgmma_kernel, tensor cores): an implicit GEMM in the TPU
//   kernel's CHW form, Y[co, pix] = sum_k W[co, k] X[k, pix], on wgmma
//   (m64n128k16) with f32 accumulators. A tile is 64 output channels (the
//   wgmma M) x 4 rows x 64 columns; two consumer warpgroups take 2 rows each
//   (N = 128). K is walked as (16-channel step) x (tap). The grid is
//   persistent (one block per SM walks tiles i, i + grid, ...), and a ring of
//   shared-memory stages, guarded by mbarriers, runs across tiles, so the
//   next tile's loads overlap this tile's epilogue.
//   Per stage one producer thread issues a TMA copy of the (4 + K - 1)-row
//   slab of 16 channels through a tensor map ordered (W, C, H, B), so that
//   each row lands as [16 ch][64 px], one 128-byte-swizzled MN-major block
//   of 2 KB, and the B operand of tap (dy, dx) is a buffer at a 2 KB row
//   offset dy; TMA's out-of-bounds zero fill is the
//   conv's zero padding (image borders, and channels past the end of a part,
//   Cin 3 or 6). The TPU kernel's dx-im2col (three copies at column starts
//   x0-1, x0, x0+1) cannot come from TMA: a tiled TMA box must start on a
//   16-byte boundary in its innermost dimension (x0 - 1 is refused with an
//   illegal-instruction fault on the H100). So TMA brings the aligned slab
//   (the dx = 1 buffer) and two 8-pixel-wide halo boxes, and a shift
//   warpgroup rebuilds the dx = 0 and dx = 2 buffers from them in shared
//   memory (one 2-byte funnel shift per 32-bit word) before the consumers
//   see the stage. One bulk copy brings the stage's weights, repacked by the
//   wrapper (ops/conv.py pack_weight) into the K-major core-matrix layout
//   the A operand reads. The epilogue runs on the accumulator fragments in
//   registers, in the TPU order. Bound: at 64->64 the conv sits at the bf16
//   ridge (bytes 0.035 ms, operations 0.034 ms at 8x180x320); the wider
//   convs are bound by operations, so the design's aim is to keep the tensor
//   cores fed: loads, shifts and the epilogue all overlap the MMAs of
//   another stage or tile.
//
// Layout: NCHW. Input channel parts are read through separate pointers (f32)
// or tensor maps (bf16), each with its own batch stride, so a channel concat
// is never copied. f32 weights are [Cout, Cin, K, K], shared or per sample
// (w_bstride elements apart); bf16 weights come packed (ops/conv.py
// pack_weight), shared or per sample.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAXP = 8;       // channel parts per launch
constexpr int TW = 32;        // tile columns (one per lane)
constexpr int TH = 8;         // tile rows (per lane)
constexpr int CT = 64;        // output channels per block
constexpr int CPW = 8;        // output channels per warp
constexpr int CI = 8;         // input channels per shared-memory stage
constexpr int WS = CT + 4;    // weight row stride in shared memory (16-byte rows)
constexpr int THREADS = 256;  // 8 warps x 8 channels = CT

struct Parts {
  const void* p[MAXP];
  long long bstride[MAXP];
  int c[MAXP];
  int n;
};

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
conv_fused_kernel(Parts parts, int Cin, int H, int W, int Cout,
                  const T* __restrict__ wt, long long w_bstride,
                  const T* __restrict__ bias, const T* __restrict__ pre,
                  const float* __restrict__ scale, long long s_bstride,
                  int lrelu, float la, float lb,
                  const T* __restrict__ res, T* __restrict__ out) {
  constexpr int HALO = KS / 2;
  constexpr int IR = TH + 2 * HALO;
  constexpr int IC = TW + 2 * HALO;
  constexpr int KK = KS * KS;
  __shared__ float s_in[CI][IR][IC];
  __shared__ __align__(16) float s_w[CI * KK][WS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int ntile = (Cout + CT - 1) / CT;
  const int b = blockIdx.z / ntile;
  const int co0 = (blockIdx.z % ntile) * CT;
  const long long HW = (long long)H * W;
  const T* wb = wt + b * w_bstride;

  float acc[CPW][TH];
#pragma unroll
  for (int i = 0; i < CPW; ++i)
#pragma unroll
    for (int r = 0; r < TH; ++r) acc[i][r] = 0.f;

  int cbase = 0;
  for (int p = 0; p < parts.n; ++p) {
    const T* xp = static_cast<const T*>(parts.p[p]) + b * parts.bstride[p];
    const int cp = parts.c[p];
    for (int c0 = 0; c0 < cp; c0 += CI) {
      __syncthreads();
      for (int e = threadIdx.x; e < CI * IR * IC; e += THREADS) {
        const int ci = e / (IR * IC), r = (e / IC) % IR, c = e % IC;
        const int gy = y0 + r - HALO, gx = x0 + c - HALO;
        float v = 0.f;
        if (c0 + ci < cp && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = ld(xp, (c0 + ci) * HW + (long long)gy * W + gx);
        s_in[ci][r][c] = v;
      }
      // weights of CI input channels: a contiguous run of CI*KK per output
      for (int e = threadIdx.x; e < CT * CI * KK; e += THREADS) {
        const int co = e / (CI * KK), r = e % (CI * KK);
        float v = 0.f;
        if (co0 + co < Cout && c0 + r / KK < cp)
          v = ld(wb, ((long long)(co0 + co) * Cin + cbase + c0) * KK + r);
        s_w[r][co] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          float col[IR];
#pragma unroll
          for (int r = 0; r < IR; ++r) col[r] = s_in[ci][r][lane + dx];
#pragma unroll
          for (int dy = 0; dy < KS; ++dy) {
            const float4* wp =
                reinterpret_cast<const float4*>(&s_w[ci * KK + dy * KS + dx][warp * CPW]);
            const float4 wa = wp[0], wc = wp[1];
            const float wv[CPW] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
            for (int i = 0; i < CPW; ++i)
#pragma unroll
              for (int r = 0; r < TH; ++r) acc[i][r] = fmaf(wv[i], col[r + dy], acc[i][r]);
          }
        }
      }
    }
    cbase += cp;
  }

  const int gx = x0 + lane;
  if (gx >= W) return;
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int oc = co0 + warp * CPW + i;
    if (oc >= Cout) continue;
    const float bv = bias ? ld(bias, oc) : 0.f;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const int gy = y0 + r;
      if (gy >= H) break;
      const long long idx = ((long long)b * Cout + oc) * HW + (long long)gy * W + gx;
      float v = acc[i][r] + bv;
      if (pre) v += ld(pre, idx);
      if (scale) v *= scale[b * s_bstride + oc];
      if (lrelu) v = la * v + lb * fabsf(v);
      if (res) v += ld(res, idx);
      st(out, idx, v);
    }
  }
}

template <typename T, int KS>
cudaError_t launch(const Parts& parts, int Cin, int B, int H, int W, int Cout,
                   const void* wt, long long w_bstride, const void* bias,
                   const void* pre, const float* scale, long long s_bstride,
                   int lrelu, float la, float lb, const void* res, void* out,
                   cudaStream_t stream) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * ((Cout + CT - 1) / CT));
  conv_fused_kernel<T, KS><<<grid, THREADS, 0, stream>>>(
      parts, Cin, H, W, Cout, static_cast<const T*>(wt), w_bstride,
      static_cast<const T*>(bias), static_cast<const T*>(pre), scale, s_bstride,
      lrelu, la, lb, static_cast<const T*>(res), static_cast<T*>(out));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM fed by TMA
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 4;                  // output rows per tile
constexpr int TC_COLS = 64;                 // output columns per tile (one 128 B line)
constexpr int TC_CO = 64;                   // output channels per tile (wgmma M)
constexpr int TC_CI = 16;                   // input channels per stage (wgmma K)
constexpr int TC_CONSUMERS = 2;             // consumer warpgroups, TC_ROWS / 2 rows each
constexpr int TC_SHIFT_WARP = TC_CONSUMERS * 4;      // first warp of the shift warpgroup
constexpr int TC_PRODUCER_WARP = TC_SHIFT_WARP + 4;  // the TMA warp
constexpr int TC_THREADS = (TC_PRODUCER_WARP + 1) * 32;
constexpr int ROW_BYTES = TC_CI * TC_COLS * 2;       // 2 KB: one slab row, [16 ch][64 px]
constexpr int TAP_BYTES = TC_CO * TC_CI * 2;         // 2 KB: one tap's weights, [64 co][16 ci]
constexpr int HALO_PX = 8;                           // TMA's 16-byte granule
constexpr int HALO_BYTES = TC_CI * HALO_PX * 2;      // 256 B: [16 ch][8 px]

// Per part, two maps of the bf16 tensor with its dimensions ordered (W, C,
// H, B), so that one box lands as [row][16 ch][px], the layout the B
// operand reads: the slab (box 64 x 16 x slab rows, 128-byte swizzle) and
// the halos (box 8 x 16 x slab rows, no swizzle).
struct TmaParts {
  CUtensorMap center[MAXP];
  CUtensorMap halo[MAXP];
  int c[MAXP];
  int n;
};

// One pipeline stage: 16 input channels of the (TC_ROWS + KS - 1)-row slab
// and their weights. The center buffer (TMA, 128-byte swizzle) is the B
// operand of the dx = 1 taps; for KS = 3 the shift warpgroup builds the
// dx = 0 and dx = 2 buffers from it and the two 8-pixel halo boxes.
template <int KS>
struct TcCfg {
  static constexpr int HALO = KS / 2;
  static constexpr int SLAB = TC_ROWS + 2 * HALO;
  static constexpr int KK = KS * KS;
  static constexpr int BUF = SLAB * ROW_BYTES;
  static constexpr int SHIFT0 = BUF, SHIFT2 = 2 * BUF;  // KS = 3 only
  static constexpr int W_OFF = KS == 3 ? 3 * BUF : BUF;
  static constexpr int HALO_OFF = W_OFF + KK * TAP_BYTES;  // [left/right][row][16 ch][8 px]
  static constexpr int STAGE_BYTES = HALO_OFF + (KS == 3 ? SLAB * 2 * HALO_BYTES : 0);
  static constexpr int STAGES = KS == 3 ? 3 : 8;  // 3x3: 57 KB a stage, 1x1: 10 KB
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");
};

struct Tile {
  int x0, y0, b, ct;
};

__device__ __forceinline__ Tile tile_of(int t, int nx, int ny, int nct) {
  Tile r;
  r.x0 = (t % nx) * TC_COLS;
  t /= nx;
  r.y0 = (t % ny) * TC_ROWS;
  t /= ny;
  r.ct = t % nct;
  r.b = t / nct;
  return r;
}

// pixel i of a shifted line from two neighbouring 32-bit words (2 px each):
// the high pixel of ``lo`` and the low pixel of ``hi``
__device__ __forceinline__ uint32_t straddle(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5432);
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (64 output channels
// x 4 rows x 64 columns each); every role walks the same (tile, chunk)
// sequence through the ring, so the producer loads the next tile's stages
// while the consumers run this tile's epilogue.
template <int KS>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ TmaParts parts, int nchunk, int ntiles, int nx, int ny,
                  int nct, int H, int W, int Cout, const __nv_bfloat16* __restrict__ wpk,
                  long long w_bstride, const __nv_bfloat16* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ pre, const float* __restrict__ scale,
                  long long s_bstride, int lrelu, float la, float lb,
                  const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out) {
  using C = TcCfg<KS>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // tma_full: the stage's copies landed; full: (3x3) its shifted buffers are
  // built too; empty: the consumers are done with it
  __shared__ __align__(8) uint64_t tma_full[C::STAGES], full[C::STAGES], empty[C::STAGES];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&tma_full[s], 1);
      mbar_init(&full[s], 4);                  // one arrival per shift warp
      mbar_init(&empty[s], TC_CONSUMERS * 4);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == TC_PRODUCER_WARP) {
    // one thread issues the stage's copies (TMA takes warp-uniform
    // operands): the slab, the halo boxes that are inside the image, and the
    // weights in one bulk copy
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(t, nx, ny, nct);
      const bool left = KS == 3 && tl.x0 > 0, right = KS == 3 && tl.x0 + TC_COLS < W;
      const uint32_t bytes =
          C::BUF + C::KK * TAP_BYTES + (int(left) + int(right)) * C::SLAB * HALO_BYTES;
      const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(
          wpk + tl.b * w_bstride + (long long)tl.ct * nchunk * C::KK * TC_CO * TC_CI);
      int chunk = 0;
      for (int p = 0; p < parts.n; ++p) {
        for (int c0 = 0; c0 < parts.c[p]; c0 += TC_CI, ++chunk) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&tma_full[stage], bytes);
          uint8_t* st = smem + stage * C::STAGE_BYTES;
          const int y = tl.y0 - C::HALO;
          tma_load_4d(st, &parts.center[p], &tma_full[stage], tl.x0, c0, y, tl.b);
          if (left)
            tma_load_4d(st + C::HALO_OFF, &parts.halo[p], &tma_full[stage], tl.x0 - HALO_PX, c0,
                        y, tl.b);
          if (right)
            tma_load_4d(st + C::HALO_OFF + C::SLAB * HALO_BYTES, &parts.halo[p], &tma_full[stage],
                        tl.x0 + TC_COLS, c0, y, tl.b);
          bulk_load(st + C::W_OFF, wsrc + (long long)chunk * C::KK * TAP_BYTES, C::KK * TAP_BYTES,
                    &tma_full[stage]);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (warp >= TC_SHIFT_WARP) {
    // shift warpgroup (3x3): thread (row r, channel c) rebuilds line c of
    // slab row r shifted by one pixel each way: dx = 0 reads x - 1, dx = 2
    // reads x + 1, with the halo pixel (or the zero padding) at the end
    if (KS == 1) return;
    const int tid = threadIdx.x - TC_SHIFT_WARP * 32;
    const int r = tid / TC_CI, c = tid % TC_CI;
    const bool active = r < C::SLAB;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(t, nx, ny, nct);
      const bool left = tl.x0 > 0, right = tl.x0 + TC_COLS < W;
      for (int k = 0; k < nchunk; ++k) {
        mbar_wait(&tma_full[stage], phase);
        uint8_t* st = smem + stage * C::STAGE_BYTES;
        if (active) {
          const int line = r * ROW_BYTES + c * 128;
          const int sw = c % 8;  // the 128-byte swizzle: 16-byte chunk j sits at j ^ (c % 8)
          uint4 v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = *reinterpret_cast<const uint4*>(st + line + ((j ^ sw) << 4));
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(st + C::HALO_OFF) +
                                   (r * TC_CI + c) * HALO_PX;
          const uint32_t lpx = left ? __bfloat16_as_ushort(h[HALO_PX - 1]) : 0u;
          const uint32_t rpx =
              right ? __bfloat16_as_ushort(h[C::SLAB * TC_CI * HALO_PX]) : 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t prev = j > 0 ? v[j - 1].w : (lpx << 16);
            const uint32_t next = j < 7 ? v[j + 1].x : rpx;
            const uint4 d0 = make_uint4(straddle(prev, v[j].x), straddle(v[j].x, v[j].y),
                                        straddle(v[j].y, v[j].z), straddle(v[j].z, v[j].w));
            const uint4 d2 = make_uint4(straddle(v[j].x, v[j].y), straddle(v[j].y, v[j].z),
                                        straddle(v[j].z, v[j].w), straddle(v[j].w, next));
            *reinterpret_cast<uint4*>(st + C::SHIFT0 + line + ((j ^ sw) << 4)) = d0;
            *reinterpret_cast<uint4*>(st + C::SHIFT2 + line + ((j ^ sw) << 4)) = d2;
          }
        }
        // the generic-proxy writes must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[stage]);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroups: wg takes output rows y0 + 2*wg, y0 + 2*wg + 1 of
  // each tile
  const int wg = warp / 4;
  uint64_t* ready = KS == 3 ? full : tma_full;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(t, nx, ny, nct);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int held = -1;  // the stage whose MMAs may still be running
    for (int k = 0; k < nchunk; ++k) {
      mbar_wait(&ready[stage], phase);
      const uint32_t st = smem_u32(smem + stage * C::STAGE_BYTES);
      const uint32_t a0 = st + C::W_OFF;
      const uint32_t b0 = st + wg * (TC_ROWS / TC_CONSUMERS) * ROW_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          // A: the tap's [64 co][16 ci] as 8x8 core matrices, K halves 128 B
          // apart, 8-row groups 256 B apart; B: the dx buffer from slab row
          // dy, 64 px per row (the next row 2 KB on), channels 0-7 / 8-15
          // 1 KB apart
          const uint32_t buf = KS == 1 ? 0 : dx == 0 ? C::SHIFT0 : dx == 1 ? 0 : C::SHIFT2;
          const uint64_t da = make_desc(a0 + (dy * KS + dx) * TAP_BYTES, 128, 256, kInterleave);
          const uint64_t db = make_desc(b0 + buf + dy * ROW_BYTES, ROW_BYTES, 1024, kSwizzle128);
          wgmma_m64n128k16_bf16(acc, da, db);
        }
      }
      wgmma_commit();
      // keep this stage's MMAs in flight; release the one before it
      wgmma_wait<1>();
      fence_regs(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);

    // epilogue on the fragments: acc[4i + 2j + c] is output channel
    // 16*(warp%4) + lane/4 + 8j, pixel n = 8i + 2*(lane%4) + c of the
    // warpgroup's 2 x 64 tile (row n / 64, column n % 64)
    const long long HW = (long long)H * W;
    const bool pairs = (W & 1) == 0;  // x is even, so a pair is 4-byte aligned
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = tl.ct * TC_CO + 16 * (warp % 4) + lane / 4 + 8 * j;
      if (co >= Cout) continue;
      const float bv = bias ? __bfloat162float(bias[co]) : 0.f;
      const float sv = scale ? scale[tl.b * s_bstride + co] : 1.f;
      const long long cbase = ((long long)tl.b * Cout + co) * HW;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int y = tl.y0 + wg * (TC_ROWS / TC_CONSUMERS) + i / 8;
        const int x = tl.x0 + 8 * (i % 8) + 2 * (lane % 4);
        if (y >= H || x >= W) continue;
        const long long idx = cbase + (long long)y * W + x;
        float v[2] = {acc[4 * i + 2 * j] + bv, acc[4 * i + 2 * j + 1] + bv};
        const int nv = x + 1 < W ? 2 : 1;
        if (pairs && nv == 2) {
          if (pre) {
            const float2 q =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pre + idx));
            v[0] += q.x;
            v[1] += q.y;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            v[c] *= sv;
            if (lrelu) v[c] = la * v[c] + lb * fabsf(v[c]);
          }
          if (res) {
            const float2 q =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + idx));
            v[0] += q.x;
            v[1] += q.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (c == nv) break;
            if (pre) v[c] += __bfloat162float(pre[idx + c]);
            v[c] *= sv;
            if (lrelu) v[c] = la * v[c] + lb * fabsf(v[c]);
            if (res) v[c] += __bfloat162float(res[idx + c]);
            out[idx + c] = __float2bfloat16_rn(v[c]);
          }
        }
      }
    }
  }
}

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // a part's tensor map was refused

template <int KS>
int launch_wgmma(const TmaParts& parts, int nchunk, int B, int H, int W, int Cout,
                 const void* wt, long long w_bstride, const void* bias, const void* pre,
                 const float* scale, long long s_bstride, int lrelu, float la, float lb,
                 const void* res, void* out, cudaStream_t stream) {
  using C = TcCfg<KS>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_wgmma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int nct = (Cout + TC_CO - 1) / TC_CO;
  const int nx = (W + TC_COLS - 1) / TC_COLS, ny = (H + TC_ROWS - 1) / TC_ROWS;
  const int ntiles = nx * ny * nct * B;
  const int grid = ntiles < sms ? ntiles : sms;
  conv_wgmma_kernel<KS><<<grid, TC_THREADS, C::SMEM, stream>>>(
      parts, nchunk, ntiles, nx, ny, nct, H, W, Cout, static_cast<const __nv_bfloat16*>(wt),
      w_bstride, static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(pre),
      scale, s_bstride, lrelu, la, lb, static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  if (e == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (e == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a channel part's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16. Null pointers switch an epilogue term off.
// part_pitch: each part's row pitch in elements (f32: must equal W; bf16: a
// multiple of 8, with 16-byte aligned base and batch stride, for TMA).
// f32 weights are [(B,) Cout, Cin, K, K]; bf16 weights are packed as
// ops/conv.py pack_weight lays them out, w_bstride elements per sample.
extern "C" int savsr_conv_fused(int ksize, int dtype, int nparts,
                                const void* const* part_ptrs, const int* part_ch,
                                const long long* part_bstride, const long long* part_pitch,
                                int B, int H, int W, int Cout, const void* wt,
                                long long w_bstride, const void* bias, const void* pre,
                                const void* scale, long long s_bstride, int lrelu, float la,
                                float lb, const void* res, void* out, void* stream) {
  if (nparts < 1 || nparts > MAXP || (ksize != 1 && ksize != 3) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Parts parts{};
    int cin = 0;
    for (int i = 0; i < nparts; ++i) {
      if (part_pitch[i] != W) return static_cast<int>(cudaErrorInvalidValue);
      parts.p[i] = part_ptrs[i];
      parts.c[i] = part_ch[i];
      parts.bstride[i] = part_bstride[i];
      cin += part_ch[i];
    }
    parts.n = nparts;
    cudaError_t e = ksize == 3 ? launch<float, 3>(parts, cin, B, H, W, Cout, wt, w_bstride, bias,
                                                  pre, sc, s_bstride, lrelu, la, lb, res, out, s)
                               : launch<float, 1>(parts, cin, B, H, W, Cout, wt, w_bstride, bias,
                                                  pre, sc, s_bstride, lrelu, la, lb, res, out, s);
    return static_cast<int>(e);
  }

  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  TmaParts parts{};
  int nchunk = 0;
  for (int i = 0; i < nparts; ++i) {
    // (W, C, H, B): the strides need not grow with the dimension
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)part_ch[i], (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)part_pitch[i] * H * 2,
                                   (cuuint64_t)part_pitch[i] * 2,
                                   (cuuint64_t)part_bstride[i] * 2};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const cuuint32_t slab = TC_ROWS + ksize - 1;
    const cuuint32_t box_center[4] = {TC_COLS, TC_CI, slab, 1};
    const cuuint32_t box_halo[4] = {HALO_PX, TC_CI, slab, 1};
    void* base = const_cast<void*>(part_ptrs[i]);
    if (encode(&parts.center[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
               box_center, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&parts.halo[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box_halo,
               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return ERR_ENCODE;
    parts.c[i] = part_ch[i];
    nchunk += (part_ch[i] + TC_CI - 1) / TC_CI;
  }
  parts.n = nparts;
  return ksize == 3 ? launch_wgmma<3>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bias, pre, sc,
                                      s_bstride, lrelu, la, lb, res, out, s)
                    : launch_wgmma<1>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bias, pre, sc,
                                      s_bstride, lrelu, la, lb, res, out, s);
}
