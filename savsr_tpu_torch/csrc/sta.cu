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
// * sta_f32_kernel<CP, ROUND> (CUDA cores; f32, true f32 for the strict
//   tier, and bf16 at channel counts the tensor-core kernel does not take,
//   which the wrapper widens to f32 and runs with ROUND: K rounded to bf16,
//   the output rounded once by the wrapper). Per pixel the K product is
//   2*25*C*C FLOPs and the filter 2*25*C, so at C = 64 the FMA pipe bounds
//   it (104K FMAs a pixel, 1.43 ms at 8 x 180x320 at 67 TFLOP/s); the design
//   aims to keep that pipe issuing. Persistent blocks, one per SM (256
//   threads, up to 255 registers each), walk tiles of 8 x 32 pixels. A
//   tile's st (its 256 pixels) and x's replicate-padded 12 x 36
//   neighbourhood are staged in shared memory by 4-byte cp.async with
//   clamped source coordinates (the replicate padding costs nothing) and
//   prefetched into L2 during the previous tile. Per tap the K product is
//   a shared-memory GEMM, C output channels x 256 pixels x C input channels,
//   in which each thread keeps an 8 x 8 register tile (channels cg + 8i,
//   pixels in rows pr, pr + 4 and columns g + 8j) and loads per input
//   channel two float4 of weights and two float4 of st: 64 FMAs for 4
//   16-byte loads. Its epilogue adds the bias, applies the LeakyReLU and
//   multiply-adds x of the tap's shifted pixel into the 8 x 8 output sums,
//   which stay in registers for all 25 taps (128 live accumulators: the
//   reason for one block per SM). The weights are packed once on the host
//   (ops/sta.py pack_sta_weights_f32: [tap][ci][column], column 8 cg + i
//   holding channel cg + 8i, so a thread's 8 channels are two float4 and the
//   x loads of a warp's 4 channel groups x 8 columns fall in 32 distinct
//   banks at the 440-float plane stride) and streamed a tap at a time by
//   16-byte cp.async into a double buffer while the previous tap computes:
//   one barrier a tap, 16 KB per tap per 256 pixels (0.72 GB from L2 a
//   launch at 8 x 180x320, where the 4x16-pixel tiles of PR 1 read 2.95 GB).
//   The bias (tap-major, packed alike) is staged once per block. C is padded
//   to 16, 32 or 64 (zero weights). What the variants showed
//   (scripts/torch_kernel_variants.py --kernels sta_f32, H100, 8 x 180x320,
//   C = 64): the K product is ~1.8 of its 2.25 ms (~78% of the FMA rate);
//   the weight stream is hidden under it, the tile staging costs ~0.1 ms and
//   the epilogue's x loads ~0.06; the L2 prefetch saves ~0.03. The K loop is
//   unrolled by 8 input channels (4 and 2 are 3% and 9% slower).
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
//
// * sta_fast_kernel<C> (the fast serving tier: f32 weights and carries at
//   matmul_precision default, C = 16, 32, 64; ops/sta.py sends other C to
//   sta_f32_kernel without ROUND): the TPU kernel's f32 mode at DEFAULT
//   precision. The K product is sta_mma_kernel's per-tap wgmma (A = st
//   rounded to bf16 as each warp loads its fragments from the f32 planes,
//   B = the tap's weights packed from their bf16 values, f32 sums); bias,
//   LeakyReLU, K (not rounded) times x and the sum over taps are f32, and
//   so is the output. Shared memory decides the layout: at C = 64 the 25
//   taps' bf16 weights (204,800 B) would leave 27,648 B of the 232,448,
//   and x's f32 12 x 12 x 64 neighbourhood alone is 36,864 B. So the
//   weights are streamed: a producer warp bulk-copies each tap's 8,192 B
//   into a ring of FT_STAGES = 8 slots (65,536 B; full/empty mbarriers),
//   the same 25 taps for every tile, from L2. The room this frees takes a
//   wider tile, 8 x 16 pixels (the two consumer warpgroups one 8 x 8 half
//   each, so a tap's copy serves 128 pixels: 0.74 GB of L2 reads a launch
//   at 8 x 180x320), and two f32 buffers of x's 12 x 20 neighbourhood
//   (plane stride FT_XS = 260 floats, 4 mod 32, so that a warp's 8 columns
//   x 4 channels of one epilogue load hit 32 banks; 2 x 66,560 B), the next
//   tile's landing by 4-byte cp.async from clamped coordinates (replicate
//   padding) under this tile's taps, beside the f32 bias (6,400 B): 205,184
//   B. Each warpgroup sums its 25 taps in order into one f32 fragment (C/2
//   values a thread) and stores its half straight from it (a warp's store:
//   4 channel planes x 8 pixels, whole 32-byte sectors). 149 registers at
//   C = 64 (288 threads: up to 224), no spills. What the variants showed
//   (scripts/torch_kernel_variants.py --kernels sta_fast; H100, 8 x
//   180x320, C = 64, ms saved of 0.53-0.55 with the part off): the f32
//   epilogue 0.17, the wgmmas 0.12-0.14, x's staging 0.12-0.13, the
//   st loads 0.04-0.05, the epilogue's x loads 0.05-0.06, the output
//   stores 0.04: it is paced, as the bf16 kernel is, by the epilogue's
//   CUDA-core instructions beside the MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int KS = 5, PAD = 2, TAPS = KS * KS;

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int F_ROWS = 8;                 // tile rows
constexpr int F_COLS = 32;                // tile columns
constexpr int F_NP = F_ROWS * F_COLS;     // 256 pixels
constexpr int F_HR = F_ROWS + 2 * PAD;    // 12 neighbourhood rows
constexpr int F_HC = F_COLS + 2 * PAD;    // 36 neighbourhood columns
constexpr int F_CS = 440;                 // x plane stride (floats): >= 12 x 36, 24 mod 32
constexpr int F_THREADS = 256;            // 8 channel groups x 32 pixel groups

template <int CP>  // channels padded to 16, 32 or 64
struct StaF32Cfg {
  static constexpr int CB = CP / 8;                     // channels per thread
  static constexpr int W_TAP = CP * CP;                 // floats of one tap's weights
  static constexpr int OFF_BIAS = 2 * W_TAP;            // after two tap buffers: [25][CP]
  static constexpr int OFF_ST = OFF_BIAS + TAPS * CP;   // [CP][256 slots]
  static constexpr int OFF_X = OFF_ST + CP * F_NP;      // [CP][F_CS]
  static constexpr int SMEM = (OFF_X + CP * F_CS) * 4;
  static_assert(OFF_ST % 4 == 0 && SMEM <= 232448, "shared memory");
};
static_assert(F_HR * F_HC <= F_CS && F_CS % 32 == 24, "x plane stride");

// the tile's operands by 4-byte cp.async: st's 256 pixels (thread tid keeps
// pixel (tid / 32, tid % 32) for every channel, at slot 128 (row / 4) +
// 4 (8 (row % 4) + col % 8) + col / 8, channels past C zero) and x's
// 12 x 36 neighbourhood (replicate padding by clamped source coordinates)
template <int CP>
__device__ __forceinline__ void sta_f32_stage(float* s_st, float* s_x, const float* x,
                                              const float* st, int b, int y0, int x0, int C,
                                              int H, int W) {
  const long long HW = (long long)H * W;
  const int tid = threadIdx.x;
  {
    const int r = tid / F_COLS, q = tid % F_COLS;
    const int slot = (r >> 2) * 128 + 4 * (8 * (r & 3) + (q & 7)) + (q >> 3);
    const float* p = st + (long long)b * C * HW + (long long)min(y0 + r, H - 1) * W +
                     min(x0 + q, W - 1);
#pragma unroll 8
    for (int c = 0; c < CP; ++c) cp_async4_zfill(s_st + c * F_NP + slot, p + (c < C ? c : 0) * HW, c < C);
  }
  for (int q = tid; q < F_HR * F_HC; q += F_THREADS) {
    const int r = q / F_HC, cc = q % F_HC;
    const float* p = x + (long long)b * C * HW +
                     (long long)min(max(y0 + r - PAD, 0), H - 1) * W + min(max(x0 + cc - PAD, 0), W - 1);
    float* d = s_x + r * F_HC + cc;
    for (int c = 0; c < C; ++c) cp_async4(d + c * F_CS, p + c * HW);
  }
}

// L2 hints for a tile's rows (st: 8, x: 12 rows of two 128-byte lines), so
// that its staging at the next tile's start reads L2
__device__ __forceinline__ void sta_f32_prefetch(const float* x, const float* st, int b, int y0,
                                                 int x0, int C, int H, int W) {
  constexpr int N = F_ROWS + 2 * F_HR;
  for (int e = threadIdx.x; e < C * N; e += F_THREADS) {
    const int c = e / N, r = e % N;
    const long long plane = ((long long)b * C + c) * H;
    const float* p;
    if (r < F_ROWS) {
      p = st + (plane + min(y0 + r, H - 1)) * W + x0;
    } else {
      const int rr = (r - F_ROWS) / 2, half = (r - F_ROWS) % 2;
      p = x + (plane + min(max(y0 + rr - PAD, 0), H - 1)) * W +
          min(max(x0 - PAD + 32 * half, 0), W - 1);
    }
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

template <int CB>
__device__ __forceinline__ void load_cb(float (&w)[CB], const float* p) {
  if constexpr (CB == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else if constexpr (CB == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    w[0] = a.x, w[1] = a.y;
  }
}

// one tap's packed weights [CP][CP] into a buffer, 16-byte cp.async
template <int CP>
__device__ __forceinline__ void sta_f32_issue_tap(float* dst, const float* wpk, int tap) {
  const float* src = wpk + tap * StaF32Cfg<CP>::W_TAP;
  for (int e = threadIdx.x; e < StaF32Cfg<CP>::W_TAP / 4; e += F_THREADS)
    cp_async16(dst + 4 * e, src + 4 * e);
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (tile: column
// fastest, then row, then sample). Thread (warp w, lane l): channel group
// cg = 4 (w % 2) + l / 8 (channels cg + 8i), pixel rows pr = w / 2 and
// pr + 4, columns g + 8j with g = l % 8.
template <int CP, bool ROUND>
__global__ void __launch_bounds__(F_THREADS, 1)
sta_f32_kernel(const float* __restrict__ x, const float* __restrict__ st,
               const float* __restrict__ wpk, const float* __restrict__ bias_p,
               float* __restrict__ out, int B, int C, int H, int W) {
  using Cfg = StaF32Cfg<CP>;
  constexpr int CB = Cfg::CB;
  extern __shared__ __align__(16) float fsm[];
  float* s_bias = fsm + Cfg::OFF_BIAS;
  float* s_st = fsm + Cfg::OFF_ST;
  float* s_x = fsm + Cfg::OFF_X;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = 4 * (warp & 1) + (lane >> 3), g = lane & 7, pr = warp >> 1;
  const int pg = 8 * pr + g;
  const int tiles_x = (W + F_COLS - 1) / F_COLS, tiles_y = (H + F_ROWS - 1) / F_ROWS;
  const int ntiles = B * tiles_x * tiles_y;

  for (int e = tid; e < TAPS * CP / 4; e += F_THREADS) cp_async16(s_bias + 4 * e, bias_p + 4 * e);
  sta_f32_issue_tap<CP>(fsm, wpk, 0);
  int step = 0;  // taps run so far: tap weights alternate between the buffers
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    const int b = rest / tiles_y, y0 = (rest % tiles_y) * F_ROWS, x0 = tx * F_COLS;
    sta_f32_stage<CP>(s_st, s_x, x, st, b, y0, x0, C, H, W);
    cp_async_wait_all();
    __syncthreads();
    if (tile + gridDim.x < ntiles) {
      const int nt = tile + gridDim.x, ntx = nt % tiles_x, nr = nt / tiles_x;
      sta_f32_prefetch(x, st, nr / tiles_y, (nr % tiles_y) * F_ROWS, ntx * F_COLS, C, H, W);
    }
    float o[CB][8];
#pragma unroll
    for (int i = 0; i < CB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < TAPS; ++t, ++step) {
      // the next tap's weights land in the other buffer under this tap
      sta_f32_issue_tap<CP>(fsm + ((step + 1) & 1) * Cfg::W_TAP, wpk, t + 1 < TAPS ? t + 1 : 0);
      const float* wt = fsm + (step & 1) * Cfg::W_TAP + CB * cg;
      const float* sp = s_st + 4 * pg;
      float k[CB][8];
#pragma unroll
      for (int i = 0; i < CB; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) k[i][j] = 0.f;
#pragma unroll 8
      for (int ci = 0; ci < CP; ++ci) {
        float wv[CB];
        load_cb<CB>(wv, wt + ci * CP);
        const float4 a0 = *reinterpret_cast<const float4*>(sp + ci * F_NP);
        const float4 a1 = *reinterpret_cast<const float4*>(sp + ci * F_NP + 128);
        const float sv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < CB; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) k[i][j] = fmaf(wv[i], sv[j], k[i][j]);
      }
      // K = lrelu(k + bias) (rounded to bf16 with ROUND), times x at the
      // pixel shifted by the tap, added to the output sums in tap order
      const int dy = t / KS, dx = t % KS;
      const float* xb = s_x + cg * F_CS + (pr + dy) * F_HC + g + dx;
      const float* bt = s_bias + t * CP + CB * cg;
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const float bv = bt[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = k[i][j] + bv;
          v = 0.55f * v + 0.45f * fabsf(v);
          if constexpr (ROUND) v = __bfloat162float(__float2bfloat16_rn(v));
          o[i][j] = fmaf(v, xb[8 * i * F_CS + (j >> 2) * 4 * F_HC + 8 * (j & 3)], o[i][j]);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // the next tap's weights landed; everyone is done with this tap's
    }
    const long long HW = (long long)H * W;
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int c = cg + 8 * i;
      if (c >= C) continue;
      float* oc = out + ((long long)b * C + c) * HW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int y = y0 + pr + 4 * (j >> 2), xx = x0 + g + 8 * (j & 3);
        if (y < H && xx < W) oc[(long long)y * W + xx] = o[i][j];
      }
    }
  }
  cp_async_wait_all();  // the last tap's prefetch of tap 0
}

template <int CP, bool ROUND>
cudaError_t launch_f32(const void* x, const void* st, const void* wpk, const void* bias_p,
                       void* out, int B, int C, int H, int W, int sms, cudaStream_t stream) {
  using Cfg = StaF32Cfg<CP>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(sta_f32_kernel<CP, ROUND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const long long ntiles =
      (long long)B * ((H + F_ROWS - 1) / F_ROWS) * ((W + F_COLS - 1) / F_COLS);
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  sta_f32_kernel<CP, ROUND><<<grid, F_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(st), static_cast<const float*>(wpk),
      static_cast<const float*>(bias_p), static_cast<float*>(out), B, C, H, W);
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

// ---------------------------------------------------------------------------
// the fast tier (f32 at default precision) on the tensor cores
// ---------------------------------------------------------------------------

constexpr int FT_ROWS = 8, FT_COLS = 16;   // tile: two 8x8 halves, one a warpgroup
constexpr int FT_HR = FT_ROWS + 2 * PAD;   // 12 neighbourhood rows
constexpr int FT_HC = FT_COLS + 2 * PAD;   // 20 neighbourhood columns
constexpr int FT_XS = 260;                 // x plane stride (floats): >= 12 x 20, 4 mod 32
constexpr int FT_STAGES = 8;               // weight ring: taps in flight
constexpr int FT_CONSUMERS = 256;          // two warpgroups
constexpr int FT_THREADS = FT_CONSUMERS + 32;  // + one producer warp
static_assert(FT_HR * FT_HC <= FT_XS && FT_XS % 32 == 4, "fast x plane stride");

template <int C>
struct StaFastCfg {
  static constexpr int TAP_BYTES = C * C * 2;              // one tap's bf16 B operand
  static constexpr int BIAS_OFF = FT_STAGES * TAP_BYTES;   // f32 [25][C]
  static constexpr int X_OFF = BIAS_OFF + TAPS * C * 4;    // two f32 [C][FT_XS] buffers
  static constexpr int X_FLOATS = C * FT_XS;
  static constexpr int BAR_OFF = X_OFF + 2 * X_FLOATS * 4;  // full[8], empty[8]
  static constexpr int SMEM = BAR_OFF + 2 * FT_STAGES * 8;
  static_assert(BIAS_OFF % 16 == 0 && X_OFF % 16 == 0 && BAR_OFF % 8 == 0, "alignment");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(FT_CONSUMERS) : "memory");
}

__device__ __forceinline__ StaTile sta_fast_tile(int tile, int tiles_x, int tiles_y) {
  const int tx = tile % tiles_x, r = tile / tiles_x;
  return StaTile{r / tiles_y, (r % tiles_y) * FT_ROWS, tx * FT_COLS};
}

// x's replicate-padded 12 x 20 neighbourhood of a tile into a buffer [C][row
// 12][column 20] by 4-byte cp.async from clamped coordinates (consecutive
// threads: consecutive columns, so the reads coalesce and the stores hit
// consecutive banks), committed as one group
template <int C>
__device__ __forceinline__ void sta_fast_stage_x(float* s_x, const float* __restrict__ x,
                                                 StaTile tl, int H, int W) {
  const long long HW = (long long)H * W;
  const float* xb = x + (long long)tl.b * C * HW;
  for (int e = threadIdx.x; e < C * FT_HR * FT_HC; e += FT_CONSUMERS) {
    const int c = e / (FT_HR * FT_HC), p = e % (FT_HR * FT_HC);
    const int gy = min(max(tl.y0 + p / FT_HC - PAD, 0), H - 1);
    const int gx = min(max(tl.x0 + p % FT_HC - PAD, 0), W - 1);
    cp_async4(s_x + c * FT_XS + p, xb + c * HW + (long long)gy * W + gx);
  }
  cp_async_commit();
}

// L2 hints for a tile's st rows (the A loads at its start then hit L2)
template <int C>
__device__ __forceinline__ void sta_fast_prefetch(const float* st, StaTile tl, int H, int W) {
  const long long HW = (long long)H * W;
  for (int e = threadIdx.x; e < C * FT_ROWS; e += FT_CONSUMERS) {
    const int c = e / FT_ROWS, r = e % FT_ROWS;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(st + ((long long)tl.b * C + c) * HW +
                                                  (long long)min(tl.y0 + r, H - 1) * W + tl.x0));
  }
}

// the warp's A fragments (its 16 rows of M: pixels (2 warp, g) and (2 warp +
// 1, g) of its half, k = the input channel) straight from st's f32 planes,
// rounded to bf16 as they are packed (a warp's load is 4 channel planes x 8
// consecutive pixels: whole 32-byte sectors)
template <int C>
__device__ __forceinline__ void sta_fast_a(uint32_t (&a)[C / 16][4], const float* __restrict__ st,
                                           StaTile tl, int H, int W, int col0, int warp, int g,
                                           int q) {
  const long long HW = (long long)H * W;
  const float* sb = st + (long long)tl.b * C * HW + min(tl.x0 + col0 + g, W - 1);
  const long long r0 = (long long)min(tl.y0 + 2 * warp, H - 1) * W;
  const long long r1 = (long long)min(tl.y0 + 2 * warp + 1, H - 1) * W;
  float v[C / 16][4][2];
#pragma unroll
  for (int kb = 0; kb < C / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* p = sb + (long long)(16 * kb + 8 * (r >> 1) + 2 * q) * HW + ((r & 1) ? r1 : r0);
      v[kb][r][0] = __ldg(p);
      v[kb][r][1] = __ldg(p + HW);
    }
#pragma unroll
  for (int kb = 0; kb < C / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kb][r] = pack_bf16x2(v[kb][r][0], v[kb][r][1]);
}

// tap t's epilogue in f32: K = lrelu(acc + bias) (not rounded), out += K *
// x at the pixel shifted by the tap. acc[4i + 2j + c]: pixel row 2 warp + j
// of the half, column g, channel 8i + 2q + c; xt: the thread's x at channel
// 2q, that row j = 0 and column, shifted by the tap; bias_tap: the tap's
// bias at channel 2q
template <int C>
__device__ __forceinline__ void sta_fast_epilogue(float (&out)[C / 2], const float (&acc)[C / 2],
                                                  const float* xt, const float* bias_tap) {
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const float2 bv = *reinterpret_cast<const float2*>(bias_tap + 8 * i);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = acc[4 * i + 2 * j + c] + (c ? bv.y : bv.x);
        v = 0.55f * v + 0.45f * fabsf(v);
        out[4 * i + 2 * j + c] =
            fmaf(v, xt[(8 * i + c) * FT_XS + j * FT_HC], out[4 * i + 2 * j + c]);
      }
  }
}

template <int C>
__global__ void __launch_bounds__(FT_THREADS, 1)
sta_fast_kernel(const float* __restrict__ x, const float* __restrict__ st,
                const uint8_t* __restrict__ wpack, const float4* __restrict__ bias_t,
                float* __restrict__ out, int B, int H, int W) {
  using Cfg = StaFastCfg<C>;
  extern __shared__ __align__(1024) uint8_t fsm_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm_raw + Cfg::BAR_OFF);
  uint64_t* empty = full + FT_STAGES;
  const int tid = threadIdx.x;
  const int tiles_x = (W + FT_COLS - 1) / FT_COLS, tiles_y = (H + FT_ROWS - 1) / FT_ROWS;
  const int ntiles = B * tiles_x * tiles_y;
  if (tid == 0) {
    for (int s = 0; s < FT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FT_CONSUMERS / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= FT_CONSUMERS) {
    // the producer: tap t's weights (the same for every tile) into the ring
    // by one bulk copy, FT_STAGES taps ahead of the consumers
    if (tid != FT_CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      for (int t = 0; t < TAPS; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], Cfg::TAP_BYTES);
        bulk_load(fsm_raw + stage * Cfg::TAP_BYTES, wpack + t * Cfg::TAP_BYTES, Cfg::TAP_BYTES,
                  &full[stage]);
        if (++stage == FT_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    return;
  }

  // the consumers: warpgroup wg takes columns [8 wg, 8 wg + 8) of each tile
  // (the warpgroup index through a shuffle, so that ptxas sees it uniform)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  const int col0 = 8 * wg;
  float* s_bias = reinterpret_cast<float*>(fsm_raw + Cfg::BIAS_OFF);
  float* s_x = reinterpret_cast<float*>(fsm_raw + Cfg::X_OFF);
  for (int e = tid; e < TAPS * C / 4; e += FT_CONSUMERS)
    cp_async16(reinterpret_cast<float4*>(s_bias) + e, bias_t + e);
  if (blockIdx.x < ntiles)
    sta_fast_stage_x<C>(s_x, x, sta_fast_tile(blockIdx.x, tiles_x, tiles_y), H, W);
  const uint32_t ring = smem_u32(fsm_raw);
  const float* bq = s_bias + 2 * q;
  int stage = 0, it = 0;
  uint32_t phase = 0;
  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const StaTile tl = sta_fast_tile(tile, tiles_x, tiles_y);
    uint32_t a[C / 16][4];
    sta_fast_a<C>(a, st, tl, H, W, col0, warp, g, q);
    // the other buffer (the previous tile's) takes the next tile's x under this one
    consumers_sync();
    if (tile + gridDim.x < ntiles) {
      const StaTile nt = sta_fast_tile(tile + gridDim.x, tiles_x, tiles_y);
      sta_fast_stage_x<C>(s_x + ((it + 1) & 1) * Cfg::X_FLOATS, x, nt, H, W);
      sta_fast_prefetch<C>(st, nt, H, W);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    consumers_sync();  // this tile's x (and, at the first, the bias) landed for all

    const float* xt = s_x + (it & 1) * Cfg::X_FLOATS + 2 * q * FT_XS + 2 * warp * FT_HC + col0 + g;
    float o[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < TAPS; ++t) {
      mbar_wait(&full[stage], phase);
      sta_issue<C>(acc, a, ring + stage * Cfg::TAP_BYTES);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == FT_STAGES) {
        stage = 0;
        phase ^= 1;
      }
      sta_fast_epilogue<C>(o, acc, xt + (t / KS) * FT_HC + t % KS, bq + t * C);
    }

    const long long HW = (long long)H * W;
    const int xx = tl.x0 + col0 + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int y = tl.y0 + 2 * warp + j;
      if (y >= H || xx >= W) continue;
      float* ob = out + ((long long)tl.b * C + 2 * q) * HW + (long long)y * W + xx;
#pragma unroll
      for (int i = 0; i < C / 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) ob[(long long)(8 * i + c) * HW] = o[4 * i + 2 * j + c];
    }
  }
}

template <int C>
cudaError_t launch_fast(const void* x, const void* st, const void* wpack, const void* bias_t,
                        void* out, int B, int H, int W, int sms, cudaStream_t stream) {
  using Cfg = StaFastCfg<C>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(sta_fast_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int ntiles = B * ((H + FT_ROWS - 1) / FT_ROWS) * ((W + FT_COLS - 1) / FT_COLS);
  const int grid = ntiles < sms ? ntiles : sms;
  sta_fast_kernel<C><<<grid, FT_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(st),
      static_cast<const uint8_t*>(wpack), static_cast<const float4*>(bias_t),
      static_cast<float*>(out), B, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// The CUDA-core kernel: x, st, out [B, C, H, W] f32 (1 <= C <= 64); wpk:
// the weights packed by ops/sta.py sta_f32_pack_index (25 * CP * CP f32, CP
// = C padded to 16, 32 or 64, 16-byte aligned); bias_p: f32 [25][CP] packed
// alike; round_k: K rounded to bf16 (the widened bf16 route); sms: the
// card's SM count (one persistent block per SM).
extern "C" int savsr_sta_f32(const void* x, const void* st, const void* wpk, const void* bias_p,
                             void* out, int B, int C, int H, int W, int round_k, int sms,
                             void* stream) {
  if (C < 1 || C > 64 || B < 1 || H < 1 || W < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (C <= 16)
    e = round_k ? launch_f32<16, true>(x, st, wpk, bias_p, out, B, C, H, W, sms, s)
                : launch_f32<16, false>(x, st, wpk, bias_p, out, B, C, H, W, sms, s);
  else if (C <= 32)
    e = round_k ? launch_f32<32, true>(x, st, wpk, bias_p, out, B, C, H, W, sms, s)
                : launch_f32<32, false>(x, st, wpk, bias_p, out, B, C, H, W, sms, s);
  else
    e = round_k ? launch_f32<64, true>(x, st, wpk, bias_p, out, B, C, H, W, sms, s)
                : launch_f32<64, false>(x, st, wpk, bias_p, out, B, C, H, W, sms, s);
  return static_cast<int>(e);
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

// The fast tier's tensor-core kernel: x, st, out [B, C, H, W] f32 with C 16,
// 32 or 64; wpack: the bf16 weights packed by ops/sta.py sta_pack_index(C)
// (25*C*C bf16, 16-byte aligned); bias_t: f32 [25][C]; sms: the card's SM
// count (one persistent block per SM).
extern "C" int savsr_sta_fast(const void* x, const void* st, const void* wpack,
                              const void* bias_t, void* out, int B, int C, int H, int W, int sms,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (C == 16) e = launch_fast<16>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  if (C == 32) e = launch_fast<32>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  if (C == 64) e = launch_fast<64>(x, st, wpack, bias_t, out, B, H, W, sms, s);
  return static_cast<int>(e);
}
