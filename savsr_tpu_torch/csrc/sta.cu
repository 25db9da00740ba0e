// Fused STA filtering — kernel 3 of the serving path.
//
// Replaces savsr_tpu/ops/pallas/sta_kernel.py::sta_conv_fused. Per LR pixel
// p and channel c, with the 5x5 neighbourhood of a replicate-padded x:
//     K[c*25 + t](p) = LeakyReLU_0.1( sum_ci Wk[c*25 + t, ci] * st[ci](p) + bias[c*25 + t] )
//     out[c](p)      = sum_t K[c*25 + t](p) * x[c](clamp(y + t/5 - 2), clamp(x + t%5 - 2))
// (LeakyReLU in abs form 0.55 v + 0.45 |v|, then K is rounded to the I/O
// type, the TPU kernel's rounding point). The 25C-channel kernel tensor K
// (184 MB at 720p in bf16) never reaches device memory, as on the TPU.
//
// Bound on the H100: the K product is 2*25*C*C FLOPs per pixel, the 25-tap
// filter 2*25*C more, against 3*C values moved: both kernels are bound by
// operations. In bf16 the K product can run on the tensor cores (989
// TFLOP/s) but the filter, a per-pixel per-channel multiply-add, has no
// matrix form and runs at the 67 TFLOP/s CUDA-core rate; f32 runs all of it
// on the CUDA cores. Two kernels:
//
// * sta_kernel<T> (CUDA cores; f32, and bf16 at channel counts the
//   tensor-core kernel does not take): a block takes a 4x16 pixel tile. It
//   stages st[C][64 px] and the tile's replicate-padded 8x20 neighbourhood
//   of x in shared memory, then walks the 25 taps: per tap it stages
//   Wk_t[C x C] in shared memory, computes K_t for its 64 channels x 64
//   pixels (each thread 4 channels x 4 pixels, f32 FMA), applies the
//   LeakyReLU and rounds to the I/O type, and multiply-accumulates the tap's
//   shifted x into 16 output accumulators held in registers for all 25 taps.
//
// * sta_mma_kernel<C> (bf16, C = 16, 32, 64; tensor cores): per tap the K
//   product of a tile of 64 pixels is one GEMM, M = the pixels, N = the C
//   output channels, K = the C input channels, which wgmma computes from
//   bf16 operands into f32 accumulators: the TPU kernel's bf16 dot_general
//   with f32 accumulation (the bias is added to the sum in f32 after it).
//   Persistent blocks, one per SM. All 25 taps' weights (200 KB at C = 64,
//   packed once on the host in the wgmma B layout, ops/sta.py
//   sta_pack_index) and the bias (f32, tap-major) are loaded into shared
//   memory once per block, so nothing is restaged per tap or tile; they
//   leave room for one tile's operands. The block's two warpgroups work on
//   the same 8x8-pixel tile and split the taps (0..12 and 13..24), so each
//   wgmma is m64nCk16 (a narrow N runs the tensor cores at a fraction of
//   their rate) and each thread keeps one f32 output fragment (C/2 values)
//   across its taps. Each warp's two tile rows are its 16 rows of M; its st
//   fragments (A, the mma.sync A layout) stay in registers for all its taps.
//   Per tap: C/16 wgmmas (the first overwrites the accumulators, so no other
//   instruction writes them and ptxas keeps the four in flight together),
//   then the epilogue on the fragment: bias and LeakyReLU in f32, round to
//   bf16, times x of the shifted pixel, added to the output fragment in tap
//   order. The tile's st and x's 12x12 replicate-padded neighbourhood are
//   loaded at the tile's start (prefetched into L2 while the previous tile
//   computed: hints, no registers), through one shared region, with
//   channels innermost at a pixel stride of C/2 + 4 words (4 mod 8: the 8
//   pixels x 4 channel pairs of a fragment load hit 32 banks), so a channel
//   pair is one 32-bit load at a fixed offset from the thread's base for the
//   tap. At the end the warpgroups exchange half of their sums through the
//   same region; each adds the two (taps 0..12 + taps 13..24), rounds once
//   to bf16 and stores half the channels. The epilogue's CUDA-core
//   instructions (about 9 per pixel, channel and tap) and the loads at the
//   tile's start set the pace (scripts/torch_kernel_variants.py). Loading
//   the next tile's operands into registers during the taps (then spills),
//   overlapping one tap's products with the previous tap's epilogue (a
//   second accumulator set: spills), four warpgroups (spills at 128
//   registers), three tap groups and an output stage for 16-byte stores
//   were each slower on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CMAX = 64;     // channels per block (C <= 64, C % 4 == 0)
constexpr int TR = 4;        // tile rows
constexpr int TC = 16;       // tile columns
constexpr int NP = TR * TC;  // pixels per tile
constexpr int KS = 5, PAD = 2, TAPS = KS * KS;
constexpr int XR = TR + 2 * PAD, XC = TC + 2 * PAD;
constexpr int WSTR = CMAX + 4;  // shared row stride of Wk_t (16-byte rows)
constexpr int THREADS = 256;    // 16 channel groups x 16 pixel groups

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sta_kernel(const T* __restrict__ x, const T* __restrict__ stf, const T* __restrict__ wk,
           const T* __restrict__ bias, T* __restrict__ out, int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_st = smem;                  // [CMAX][NP]
  float* s_w = s_st + CMAX * NP;       // [CMAX (ci)][WSTR] : Wk_t transposed
  float* s_x = s_w + CMAX * WSTR;      // [CMAX][XR][XC]

  const int tid = threadIdx.x;
  const int tc = tid / 16, tp = tid % 16;  // channels 4*tc.., pixels 4*tp..
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TR, x0 = blockIdx.x * TC;
  const long long HW = (long long)H * W;
  const T* xb = x + b * C * HW;
  const T* sb = stf + b * C * HW;

  for (int e = tid; e < C * NP; e += THREADS) {
    const int c = e / NP, p = e % NP;
    const int gy = min(y0 + p / TC, H - 1), gx = min(x0 + p % TC, W - 1);
    s_st[c * NP + p] = ld(sb, c * HW + (long long)gy * W + gx);
  }
  for (int e = tid; e < C * XR * XC; e += THREADS) {
    const int c = e / (XR * XC), r = (e / XC) % XR, q = e % XC;
    const int gy = min(max(y0 + r - PAD, 0), H - 1);
    const int gx = min(max(x0 + q - PAD, 0), W - 1);
    s_x[e] = ld(xb, c * HW + (long long)gy * W + gx);
  }

  const bool active = 4 * tc < C;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < TAPS; ++t) {
    __syncthreads();
    // Wk_t[c][ci] = wk[(c*25 + t)*C + ci], staged as s_w[ci][c]
    for (int e = tid; e < C * C; e += THREADS) {
      const int c = e / C, ci = e % C;
      s_w[ci * WSTR + c] = ld(wk, ((long long)c * TAPS + t) * C + ci);
    }
    __syncthreads();
    if (!active) continue;
    float k[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) k[i][j] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(&s_w[ci * WSTR + 4 * tc]);
      const float4 sv = *reinterpret_cast<const float4*>(&s_st[ci * NP + 4 * tp]);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) k[i][j] = fmaf(wa[i], sa[j], k[i][j]);
    }
    const int dy = t / KS, dx = t % KS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * tc + i;
      const float bv = ld(bias, (long long)c * TAPS + t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * tp + j, r = p / TC, q = p % TC;
        float v = k[i][j] + bv;
        v = round_to(0.55f * v + 0.45f * fabsf(v), x);
        acc[i][j] = fmaf(v, s_x[(c * XR + r + dy) * XC + q + dx], acc[i][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = 4 * tp + j, gy = y0 + p / TC, gx = x0 + p % TC;
    if (gy >= H || gx >= W) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st(out + b * C * HW, (4 * tc + i) * HW + (long long)gy * W + gx, acc[i][j]);
  }
}

constexpr size_t SMEM_BYTES = sizeof(float) * (CMAX * NP + CMAX * WSTR + CMAX * XR * XC);

template <typename T>
cudaError_t launch(const void* x, const void* st, const void* wk, const void* bias, void* out,
                   int B, int C, int H, int W, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(sta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  sta_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(st), static_cast<const T*>(wk),
      static_cast<const T*>(bias), static_cast<T*>(out), C, H, W);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int MT = 8;                // tile rows and columns: 64 pixels, the wgmma M
constexpr int HALO = MT + 2 * PAD;   // 12: neighbourhood rows and columns
constexpr int HPX = HALO * HALO;     // 144 neighbourhood pixels
constexpr int WG_TAPS = 13;          // taps of warpgroup 0 (warpgroup 1: the other 12)

template <int C>
struct StaCfg {
  static constexpr int THREADS = 256;          // two warpgroups
  static constexpr int PW = C / 2 + 4;         // 32-bit words per staged pixel: C/2
                                               // channel pairs, padded to 4 mod 8
  static constexpr int TAP_BYTES = C * C * 2;  // the B operand of one tap
  static constexpr int W_BYTES = TAPS * TAP_BYTES;
  static constexpr int BIAS_OFF = W_BYTES;     // f32 [25][C]
  static constexpr int HALO_OFF = BIAS_OFF + TAPS * C * 4;
  static constexpr int HALO_WORDS = HPX * PW;
  static constexpr int SMEM = HALO_OFF + HALO_WORDS * 4;
  static constexpr int PAIRS = HPX * C / 2;                   // x channel pairs staged per tile
  static constexpr int NLD = (PAIRS + THREADS - 1) / THREADS;  // of them per thread
  static constexpr int NST = MT * MT * C / 2 / THREADS;        // st channel pairs per thread
  static_assert(MT * MT * C / 2 % THREADS == 0, "whole st channel pairs per thread");
  static_assert(C / 4 * THREADS <= HALO_WORDS, "the partial-sum exchange fits the halo");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ uint16_t ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// the first pixel (y0, x0) and sample of tile `tile`
struct StaTile {
  int b, y0, x0;
};
__device__ __forceinline__ StaTile sta_tile(int tile, int tiles_x, int tiles_y) {
  const int tx = tile % tiles_x, r = tile / tiles_x;
  return StaTile{r / tiles_y, (r % tiles_y) * MT, tx * MT};
}

// loads of a tile's operands into registers, all issued before any is
// used: the thread's share of st's 64 pixels and of x's replicate-padded
// 12x12 neighbourhood, each as channel pairs
template <int C>
__device__ __forceinline__ void sta_fetch(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                          StaTile tl, int H, int W,
                                          uint16_t (&sn)[StaCfg<C>::NST][2],
                                          uint16_t (&hn)[StaCfg<C>::NLD][2]) {
  const long long HW = (long long)H * W;
  const bf16* sb = st + (long long)tl.b * C * HW;
#pragma unroll
  for (int k = 0; k < StaCfg<C>::NST; ++k) {
    const int e = threadIdx.x + StaCfg<C>::THREADS * k;
    const int p = e % (MT * MT), cp = e / (MT * MT);
    const int gy = min(tl.y0 + p / MT, H - 1), gx = min(tl.x0 + p % MT, W - 1);
    const bf16* src = sb + (long long)(2 * cp) * HW + (long long)gy * W + gx;
    sn[k][0] = ldg_u16(src);
    sn[k][1] = ldg_u16(src + HW);
  }
  const bf16* xb = x + (long long)tl.b * C * HW;
#pragma unroll
  for (int k = 0; k < StaCfg<C>::NLD; ++k) {
    const int e = threadIdx.x + StaCfg<C>::THREADS * k;
    if (e >= StaCfg<C>::PAIRS) break;
    const int P = e % HPX, cp = e / HPX;
    const int gy = min(max(tl.y0 + P / HALO - PAD, 0), H - 1);
    const int gx = min(max(tl.x0 + P % HALO - PAD, 0), W - 1);
    const bf16* src = xb + (long long)(2 * cp) * HW + (long long)gy * W + gx;
    hn[k][0] = ldg_u16(src);
    hn[k][1] = ldg_u16(src + HW);
  }
}

// hints that bring the next tile's operands into L2 while this tile
// computes (no register holds them): one per channel row of st's 8 rows and
// of x's 12 neighbourhood rows, so the loads at the next tile's start hit L2
template <int C>
__device__ __forceinline__ void sta_prefetch(const bf16* x, const bf16* st, StaTile tl, int H,
                                             int W) {
  const long long HW = (long long)H * W;
  for (int e = threadIdx.x; e < C * (MT + HALO); e += StaCfg<C>::THREADS) {
    const int c = e / (MT + HALO), r = e % (MT + HALO);
    const bf16* p = r < MT ? st + ((long long)tl.b * C + c) * HW +
                                 (long long)min(tl.y0 + r, H - 1) * W + tl.x0
                           : x + ((long long)tl.b * C + c) * HW +
                                 (long long)min(max(tl.y0 + r - MT - PAD, 0), H - 1) * W +
                                 max(tl.x0 - PAD, 0);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

// start tap t's K product into acc: C/16 wgmmas (A from the registers a, B
// from the tap's weights in shared memory), the first overwriting acc, one
// commit group; no other instruction writes acc
template <int C>
__device__ __forceinline__ void sta_issue(float (&acc)[C / 2], const uint32_t (&a)[C / 16][4],
                                          uint32_t w_tap) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < C / 16; ++kb)
    wgmma_m64nNk16_bf16_rs<C>(acc, a[kb], make_desc(w_tap + kb * C * 32, 128, 256, kInterleave),
                              kb > 0);
  wgmma_commit();
}

// tap t's epilogue: K = bf16(lrelu(acc + bias)), out += K * x at the pixel
// shifted by the tap. acc[4i + 2j + c] is pixel (2w + j, g) of the tile,
// channel 8i + 2q + c; hx0: the thread's staged channel pair 2q, 2q+1 of
// pixel (2w, g) at tap 0 (row j = 1 is HALO pixels on, n-tile i 4 pairs on);
// bias_tap: the tap's bias at channel 2q
template <int C>
__device__ __forceinline__ void sta_epilogue(float (&out)[C / 2], const float (&acc)[C / 2],
                                             const uint32_t* hx0, const float* bias_tap, int t) {
  const uint32_t* hx = hx0 + ((t / KS) * HALO + t % KS) * StaCfg<C>::PW;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const float2 bv = *reinterpret_cast<const float2*>(bias_tap + 8 * i);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v0 = acc[4 * i + 2 * j] + bv.x, v1 = acc[4 * i + 2 * j + 1] + bv.y;
      v0 = 0.55f * v0 + 0.45f * fabsf(v0);
      v1 = 0.55f * v1 + 0.45f * fabsf(v1);
      const uint32_t k = pack_bf16x2(v0, v1);
      const uint32_t xv = hx[j * HALO * StaCfg<C>::PW + 4 * i];
      out[4 * i + 2 * j] = fmaf(bf16_lo(k), bf16_lo(xv), out[4 * i + 2 * j]);
      out[4 * i + 2 * j + 1] = fmaf(bf16_hi(k), bf16_hi(xv), out[4 * i + 2 * j + 1]);
    }
  }
}

// the end of a tile, warpgroup WG: it leaves its sums of the n-tiles the
// other warpgroup stores in its region of `swap` (shared memory), then,
// after a barrier, stores n-tiles [WG C/16, (WG+1) C/16) of the tile as bf16,
// its own sum plus the other's (register indices stay compile-time)
template <int C, int WG>
__device__ __forceinline__ void sta_give(const float (&o)[C / 2], float* swap, int ltid) {
  constexpr int HALF = C / 4;
#pragma unroll
  for (int e = 0; e < HALF; ++e) swap[(WG * HALF + e) * 128 + ltid] = o[(1 - WG) * HALF + e];
}

template <int C, int WG>
__device__ __forceinline__ void sta_store(const float (&o)[C / 2], const float* swap, int ltid,
                                          bf16* __restrict__ out, StaTile tl, int H, int W,
                                          int warp, int g, int q) {
  constexpr int HALF = C / 4, KEEP = WG * HALF;
  const float* theirs = swap + (1 - WG) * HALF * 128 + ltid;
  const long long HW = (long long)H * W;
  bf16* ob = out + (long long)tl.b * C * HW + (long long)(2 * KEEP + 2 * q) * HW;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int y = tl.y0 + 2 * warp + j, xx = tl.x0 + g;
    if (y >= H || xx >= W) continue;
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * j + c;  // o[KEEP + e]: n-tile KEEP/4 + i, row j
        ob[(long long)(8 * i + c) * HW + (long long)y * W + xx] =
            __float2bfloat16_rn(o[KEEP + e] + theirs[e * 128]);
      }
  }
}

template <int C>
__global__ void __launch_bounds__(StaCfg<C>::THREADS, 1)
sta_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
               const uint4* __restrict__ wpack, const float4* __restrict__ bias_t,
               bf16* __restrict__ out, int B, int H, int W) {
  using Cfg = StaCfg<C>;
  extern __shared__ __align__(1024) uint8_t sta_smem[];
  const int tid = threadIdx.x;
  // the warpgroup index through a shuffle, so that ptxas sees it uniform
  // across the warp: branches on it (the tap range) are then not divergent,
  // which would serialize the wgmmas
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int ltid = tid % 128, warp = ltid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;

  // all taps' weights and the bias, once per block
  for (int e = tid; e < Cfg::W_BYTES / 16; e += Cfg::THREADS)
    cp_async16(reinterpret_cast<uint4*>(sta_smem) + e, wpack + e);
  for (int e = tid; e < TAPS * C / 4; e += Cfg::THREADS)
    cp_async16(reinterpret_cast<float4*>(sta_smem + Cfg::BIAS_OFF) + e, bias_t + e);
  cp_async_wait_all();
  __syncthreads();
  const uint32_t w_base = smem_u32(sta_smem);
  const float* s_bias = reinterpret_cast<const float*>(sta_smem + Cfg::BIAS_OFF);
  uint32_t* halo = reinterpret_cast<uint32_t*>(sta_smem + Cfg::HALO_OFF);
  // after the taps the halo holds the partial sums the warpgroups exchange
  float* swap = reinterpret_cast<float*>(halo);
  const uint32_t* hx0 = halo + (2 * warp * HALO + g) * Cfg::PW + q;
  const int t0 = wg == 0 ? 0 : WG_TAPS, t1 = wg == 0 ? WG_TAPS : TAPS;

  const int tiles_x = (W + MT - 1) / MT, tiles_y = (H + MT - 1) / MT;
  const int ntiles = B * tiles_x * tiles_y;
  // the accumulators: written by the wgmmas alone, zeroed once so that no
  // register starts undefined
  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const StaTile tl = sta_tile(tile, tiles_x, tiles_y);
    // the tile's operands, through the shared region that holds st's 64
    // pixels, then x's neighbourhood (pixel stride PW both)
    uint16_t sn[Cfg::NST][2];
    uint16_t hn[Cfg::NLD][2];
    sta_fetch<C>(x, st, tl, H, W, sn, hn);
    __syncthreads();  // the previous tile's reads of the region
#pragma unroll
    for (int k = 0; k < Cfg::NST; ++k) {
      const int e = tid + Cfg::THREADS * k;
      halo[(e % (MT * MT)) * Cfg::PW + e / (MT * MT)] = pack_u16(sn[k][0], sn[k][1]);
    }
    __syncthreads();
    // A: rows g and g+8 are pixels (2w, g) and (2w+1, g), k = the input
    // channel (pairs 8 kb + q, then + 4)
    uint32_t a[C / 16][4];
#pragma unroll
    for (int kb = 0; kb < C / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kb][r] = halo[(16 * warp + g + 8 * (r & 1)) * Cfg::PW + 8 * kb + 4 * (r >> 1) + q];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < Cfg::NLD; ++k) {
      const int e = tid + Cfg::THREADS * k;
      if (e < Cfg::PAIRS) halo[(e % HPX) * Cfg::PW + e / HPX] = pack_u16(hn[k][0], hn[k][1]);
    }
    __syncthreads();
    if (tile + gridDim.x < ntiles)
      sta_prefetch<C>(x, st, sta_tile(tile + gridDim.x, tiles_x, tiles_y), H, W);

    // each warpgroup sums its taps in order into its own f32 output fragment
    float o[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
    const float* bq = s_bias + 2 * q;
#pragma unroll 1
    for (int t = t0; t < t1; ++t) {
      sta_issue<C>(acc, a, w_base + t * Cfg::TAP_BYTES);
      wgmma_wait<0>();
      fence_regs(acc);
      sta_epilogue<C>(o, acc, hx0, bq + t * C, t);
    }

    // each warpgroup stores half the channels, its own sum plus the other's
    // (taps 0..12 + taps 13..24), which the other leaves in shared memory
    __syncthreads();
    if (wg == 0)
      sta_give<C, 0>(o, swap, ltid);
    else
      sta_give<C, 1>(o, swap, ltid);
    __syncthreads();
    if (wg == 0)
      sta_store<C, 0>(o, swap, ltid, out, tl, H, W, warp, g, q);
    else
      sta_store<C, 1>(o, swap, ltid, out, tl, H, W, warp, g, q);
  }
}

template <int C>
cudaError_t launch_mma(const void* x, const void* st, const void* wpack, const void* bias_t,
                       void* out, int B, int H, int W, int sms, cudaStream_t stream) {
  using Cfg = StaCfg<C>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(sta_mma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int ntiles = B * ((H + MT - 1) / MT) * ((W + MT - 1) / MT);
  const int grid = ntiles < sms ? ntiles : sms;
  sta_mma_kernel<C><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(st), static_cast<const uint4*>(wpack),
      static_cast<const float4*>(bias_t), static_cast<bf16*>(out), B, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x, st, out: [B, C, H, W]; wk: [25C, C] (kernel_conv.0 weight, rows c*25+t);
// bias: [25C]. dtype: 0 = float32, 1 = bfloat16.
extern "C" int savsr_sta_fused(int dtype, const void* x, const void* st, const void* wk,
                               const void* bias, void* out, int B, int C, int H, int W,
                               void* stream) {
  if (C < 4 || C > CMAX || C % 4 != 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch<float>(x, st, wk, bias, out, B, C, H, W, s)
                                     : launch<__nv_bfloat16>(x, st, wk, bias, out, B, C, H, W, s));
}

// The tensor-core kernel (bf16): x, st, out [B, C, H, W] bf16 with C 16, 32
// or 64; wpack: the weights packed by ops/sta.py sta_pack_index(C) (25*C*C
// bf16, 16-byte aligned); bias_t: f32 [25][C] (bias[c*25 + t] at [t][c]);
// sms: the card's SM count (one persistent block per SM).
extern "C" int savsr_sta_mma(const void* x, const void* st, const void* wpack, const void* bias_t,
                             void* out, int B, int C, int H, int W, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (C == 16) e = launch_mma<16>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  if (C == 32) e = launch_mma<32>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  if (C == 64) e = launch_mma<64>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  return static_cast<int>(e);
}
