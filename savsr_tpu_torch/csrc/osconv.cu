// Per-sample-weight KxK convolution (K = 1 or 3, stride 1, any zero padding
// 0..K-1) and its per-sample weight gradient — kernels 6 and 7, the OSConv
// engine of the training path.
//
// osconv_agg_kernel replaces savsr_tpu/ops/pallas/osconv_kernel.py::
// osconv_pallas_agg: for sample b, with its own weight agg[b],
//     y[b, o, h, w] = sum_{dy,dx,i} xpad[b, i, h+dy, w+dx] * agg[b, dy, dx, i, o]
// (xpad = x zero-padded by `pad`), f32 accumulation, output in the I/O type,
// no bias and no epilogue. The training backward calls the same kernel for
// dx: on the cotangent, with the taps flipped and the channel axes swapped,
// at padding K-1-pad.
//
// osconv_dagg_kernel and osconv_dagg_wgmma_kernel replace ::osconv_pallas_dagg:
//     dagg[b, dy*K+dx, i, o] = sum_{h,w} xpad[b, i, h+dy, w+dx] * g[b, o, h, w]
// f32 accumulation and f32 output for both input types.
//
// Which kernel runs (ops/osconv.py chooses by dtype and padding alone): bf16
// at padding K/2, the training path's case, runs on the tensor cores — the
// forward and dx on csrc/conv.cu's conv_wgmma_kernel (the bf16 conv, which
// takes a per-sample weight, repacked by the wrapper), the weight gradient on
// osconv_dagg_wgmma_kernel below. f32 (the train-parity tier: true f32, no
// TF32) and bf16 at any other padding run the CUDA-core kernels
// osconv_agg_kernel and osconv_dagg_kernel.
//
// Bound on the H100: at the training shapes (8 samples of 60x60, Cin 64..320,
// Cout 64, or the reverse for dx) each does 2*9*Cin*Cout FLOPs per pixel
// against (Cin + Cout) values moved per pixel plus the 9*Cin*Cout weights of
// each sample, so both are bound by operations: in f32 held to the 67 TFLOP/s
// CUDA-core rate, in bf16 to the 989 TFLOP/s tensor-core rate. The CUDA-core
// kernels work in f32 (bf16 inputs are widened on load) and cannot approach
// the bf16 bound; that is why bf16 goes to the tensor cores.
//
// Design, CUDA-core forward/dx: a block computes a 64-channel x 8-row x
// 32-column output tile; each warp owns 8 output channels, each lane one
// column of 8 rows (64 accumulators in registers). Input channels stream
// through shared memory 8 at a time with a bounds-checked halo (no padded
// copy of x), the sample's weights for those channels are broadcast from
// shared memory. The weight layout [tap][Cin][Cout] makes the weight loads
// contiguous in Cout.
//
// Design, CUDA-core weight gradient: the TPU kernel carries its [P, Cin,
// Cout] accumulator across the sequential row-tile steps of one sample;
// blocks on this card run in no order and carry nothing over. Here a block
// owns one (sample, 32-input-channel tile, 64-output-channel tile, chunk of
// pixel rows) and keeps all K*K taps of its tile in registers (each thread:
// 2 input channels x 4 output channels x 9 taps) while it walks its chunk's
// pixels 2 rows x 32 columns at a time through shared memory; the 3x3 window
// of x slides along the row in registers. With more than one chunk the
// blocks write f32 partials [chunk][B][P][Cin][Cout] and a second kernel
// adds them in chunk order, so the sum order is fixed and the result is the
// same from run to run (no atomics).
//
// Design, tensor-core weight gradient (osconv_dagg_wgmma_kernel, bf16,
// padding K/2): per (sample, tap) the gradient is a GEMM, M = Cin, N = Cout,
// K = the pixels, and in NCHW both operands are K-major (a channel's pixels
// are contiguous). The tap's shift is moved from x to g:
//     dagg[dy, dx, i, o] = sum_{h,w} x[i, h, w] * g[o, h - dy + P, w - dx + P]
// (P = K/2, g zero outside), the same pairs of pixels, so x is read as it
// lies and only the 64-channel g is shifted. A block owns (sample, 64-Cin
// tile, 64-Cout tile, chunk of rows) and walks the chunk one 64-pixel row
// box at a time (the GEMM's K step: four k16 wgmmas). A ring stage holds one
// x row box and one g row box (TMA, 128-byte swizzle, the K-major operand
// layout; out-of-bounds rows, columns and channels are zero-filled, which is
// the padding) plus, for K = 3, two 8-pixel halo boxes of g; a shift warp
// pair rebuilds the g row shifted one pixel each way in shared memory (a
// tiled TMA box cannot start off a 16-byte boundary), and lays the three
// shifts out side by side so that one m64n192k16 wgmma covers the three dx
// taps. K consumer warpgroups, one per dy, each hold [64 Cin x (K*64)] f32
// accumulators (96 registers a thread for K = 3): consumer dy multiplies
// the x row of step t-P by the g row of step t-dy, so a stage stays in use
// for 2P steps and the chunk walks 2P more g rows than x rows. Partials are
// written once per chunk in f32 and added in chunk order by
// dagg_reduce_kernel, as for the CUDA-core kernel: deterministic.
//
// Layout: x [B, Cin, H, W], g and y [B, Cout, Ho, Wo] (NCHW, contiguous; the
// tensor-core kernel takes a row pitch, a multiple of 8), agg [B, K, K, Cin,
// Cout], dagg [B, K*K, Cin, Cout].

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// forward / dx
// ---------------------------------------------------------------------------

constexpr int TW = 32;      // tile columns (one per lane)
constexpr int TH = 8;       // tile rows (per lane)
constexpr int CT = 64;      // output channels per block
constexpr int CPW = 8;      // output channels per warp (8 warps x 8 = CT)
constexpr int CI = 8;       // input channels per shared-memory stage
constexpr int WS = CT + 4;  // weight row stride in shared memory (16-byte rows)

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
osconv_agg_kernel(const T* __restrict__ x, const T* __restrict__ agg, T* __restrict__ out,
                  int Cin, int H, int W, int Cout, int Ho, int Wo, int pad) {
  constexpr int IR = TH + KS - 1;
  constexpr int IC = TW + KS - 1;
  constexpr int KK = KS * KS;
  __shared__ float s_in[CI][IR][IC];
  __shared__ __align__(16) float s_w[CI * KK][WS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int ntile = (Cout + CT - 1) / CT;
  const int b = blockIdx.z / ntile;
  const int co0 = (blockIdx.z % ntile) * CT;
  const long long HW = (long long)H * W;
  const T* xb = x + (long long)b * Cin * HW;
  const T* wb = agg + (long long)b * KK * Cin * Cout;

  float acc[CPW][TH];
#pragma unroll
  for (int i = 0; i < CPW; ++i)
#pragma unroll
    for (int r = 0; r < TH; ++r) acc[i][r] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    __syncthreads();
    for (int e = threadIdx.x; e < CI * IR * IC; e += THREADS) {
      const int ci = e / (IR * IC), r = (e / IC) % IR, c = e % IC;
      const int gy = y0 + r - pad, gx = x0 + c - pad;
      float v = 0.f;
      if (c0 + ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = ld(xb, (c0 + ci) * HW + (long long)gy * W + gx);
      s_in[ci][r][c] = v;
    }
    // weights of CI input channels, all taps: contiguous in Cout
    for (int e = threadIdx.x; e < CI * KK * CT; e += THREADS) {
      const int co = e % CT, rr = e / CT;  // rr = ci * KK + tap
      const int ci = rr / KK, tap = rr % KK;
      float v = 0.f;
      if (co0 + co < Cout && c0 + ci < Cin)
        v = ld(wb, ((long long)tap * Cin + c0 + ci) * Cout + co0 + co);
      s_w[rr][co] = v;
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

  const int gx = x0 + lane;
  if (gx >= Wo) return;
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int oc = co0 + warp * CPW + i;
    if (oc >= Cout) continue;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const int gy = y0 + r;
      if (gy >= Ho) break;
      st(out, (((long long)b * Cout + oc) * Ho + gy) * Wo + gx, acc[i][r]);
    }
  }
}

template <typename T, int KS>
cudaError_t launch_agg(const void* x, const void* agg, void* out, int B, int Cin, int H,
                       int W, int Cout, int pad, cudaStream_t stream) {
  const int Ho = H + 2 * pad - KS + 1, Wo = W + 2 * pad - KS + 1;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * ((Cout + CT - 1) / CT));
  osconv_agg_kernel<T, KS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(agg), static_cast<T*>(out), Cin, H, W,
      Cout, Ho, Wo, pad);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// per-sample weight gradient
// ---------------------------------------------------------------------------

constexpr int DI = 32;             // input channels per block (16 thread groups x 2)
constexpr int DO = 64;             // output channels per block (16 thread groups x 4)
constexpr int DR = 2;              // pixel rows per shared-memory stage
constexpr int DC = 32;             // pixel columns per shared-memory stage
constexpr int DPIX = DR * DC + 1;  // odd row stride: the 16 o-groups hit 16 banks

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
osconv_dagg_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ out,
                   int Cin, int H, int W, int Cout, int Ho, int Wo, int pad,
                   int rows_per_chunk, long long chunk_stride) {
  constexpr int KK = KS * KS;
  constexpr int XR = DR + KS - 1;
  constexpr int XC = DC + KS - 1;
  __shared__ float s_x[DI][XR][XC];
  __shared__ float s_g[DO][DPIX];

  const int og = threadIdx.x & 15;  // owns output channels og + 16k, k = 0..3
  const int ig = threadIdx.x >> 4;  // owns input channels 2*ig, 2*ig + 1
  const int n_otile = (Cout + DO - 1) / DO;
  const int i0 = (blockIdx.x / n_otile) * DI;
  const int o0 = (blockIdx.x % n_otile) * DO;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const long long HW = (long long)H * W, HoWo = (long long)Ho * Wo;
  const T* xb = x + (long long)b * Cin * HW;
  const T* gb = g + (long long)b * Cout * HoWo;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(Ho, row0 + rows_per_chunk);

  float acc[2][4][KK];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int t = 0; t < KK; ++t) acc[ii][k][t] = 0.f;

  for (int y0 = row0; y0 < row1; y0 += DR) {
    for (int x0 = 0; x0 < Wo; x0 += DC) {
      __syncthreads();
      for (int e = threadIdx.x; e < DI * XR * XC; e += THREADS) {
        const int ci = e / (XR * XC), r = (e / XC) % XR, c = e % XC;
        const int gy = y0 + r - pad, gx = x0 + c - pad;
        float v = 0.f;
        if (i0 + ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = ld(xb, (i0 + ci) * HW + (long long)gy * W + gx);
        s_x[ci][r][c] = v;
      }
      // cotangent tile; rows past this chunk and columns past Wo are zero
      for (int e = threadIdx.x; e < DO * DR * DC; e += THREADS) {
        const int o = e / (DR * DC), r = (e / DC) % DR, c = e % DC;
        const int gy = y0 + r, gx = x0 + c;
        float v = 0.f;
        if (o0 + o < Cout && gy < row1 && gx < Wo)
          v = ld(gb, (o0 + o) * HoWo + (long long)gy * Wo + gx);
        s_g[o][r * DC + c] = v;
      }
      __syncthreads();
      for (int r = 0; r < DR; ++r) {
        float xw[2][KS][KS];  // the KxK window of x at the current pixel
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int dy = 0; dy < KS; ++dy)
#pragma unroll
            for (int dx = 1; dx < KS; ++dx) xw[ii][dy][dx] = s_x[ig * 2 + ii][r + dy][dx - 1];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
              for (int dx = 0; dx + 1 < KS; ++dx) xw[ii][dy][dx] = xw[ii][dy][dx + 1];
              xw[ii][dy][KS - 1] = s_x[ig * 2 + ii][r + dy][c + KS - 1];
            }
          float gv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) gv[k] = s_g[og + 16 * k][r * DC + c];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int dy = 0; dy < KS; ++dy)
#pragma unroll
                for (int dx = 0; dx < KS; ++dx)
                  acc[ii][k][dy * KS + dx] =
                      fmaf(xw[ii][dy][dx], gv[k], acc[ii][k][dy * KS + dx]);
        }
      }
    }
  }

  float* ob = out + chunk * chunk_stride + (long long)b * KK * Cin * Cout;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int i = i0 + ig * 2 + ii;
    if (i >= Cin) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + og + 16 * k;
      if (o >= Cout) continue;
#pragma unroll
      for (int t = 0; t < KK; ++t) ob[((long long)t * Cin + i) * Cout + o] = acc[ii][k][t];
    }
  }
}

// out[e] = sum over chunks, in chunk order (a fixed order: deterministic)
__global__ void dagg_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   long long n, int nchunks) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nchunks; ++t) s += part[t * n + e];
    out[e] = s;
  }
}

template <typename T, int KS>
cudaError_t launch_dagg(const void* x, const void* g, float* out, float* scratch, int nchunks,
                        int rows_per_chunk, int B, int Cin, int H, int W, int Cout, int pad,
                        cudaStream_t stream) {
  const int Ho = H + 2 * pad - KS + 1, Wo = W + 2 * pad - KS + 1;
  const long long n = (long long)B * KS * KS * Cin * Cout;
  dim3 grid(((Cin + DI - 1) / DI) * ((Cout + DO - 1) / DO), nchunks, B);
  osconv_dagg_kernel<T, KS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), nchunks > 1 ? scratch : out, Cin, H,
      W, Cout, Ho, Wo, pad, rows_per_chunk, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nchunks == 1) return e;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  dagg_reduce_kernel<<<blocks < 1024 ? blocks : 1024, THREADS, 0, stream>>>(scratch, out, n,
                                                                            nchunks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// per-sample weight gradient on the tensor cores (bf16, padding K/2)
// ---------------------------------------------------------------------------

constexpr int TG_CH = 64;                              // Cin (wgmma M) and Cout per block
constexpr int TG_PX = 64;                              // pixels per step: one 128-byte row
constexpr int TG_BOX = TG_CH * TG_PX * 2;              // 8 KB: one [64 ch][64 px] row box
constexpr int TG_HALO_PX = 8;                          // TMA's 16-byte granule
constexpr int TG_HALO_BYTES = TG_CH * TG_HALO_PX * 2;  // 1 KB: [64 ch][8 px]

// One ring stage: the x row box (A operand) and the g row shifted for dx =
// 0..K-1 side by side (the B operand of one wgmma, N = 64*K): [x][g read at
// w+1][g][g read at w-1] for K = 3, the middle one from TMA; then the two
// halo boxes of g. Consumer warpgroups first, then the TMA warp, then (K = 3)
// the two shift warps, one g channel per thread.
template <int KS>
struct DgCfg {
  static constexpr int HALO = KS / 2;
  static constexpr int N = TG_CH * KS;
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = TG_BOX;
  static constexpr int GC_OFF = B_OFF + HALO * TG_BOX;
  static constexpr int HALO_OFF = B_OFF + KS * TG_BOX;  // [left, right][64 ch][8 px]
  static constexpr int STAGE_BYTES = HALO_OFF + (KS == 3 ? 2 * TG_HALO_BYTES : 0);
  static constexpr int STAGES = KS == 3 ? 6 : 8;  // 3x3: 34 KB a stage, 1x1: 16 KB
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  static constexpr int PRODUCER_WARP = 4 * KS;
  static constexpr int THREADS = 32 * (PRODUCER_WARP + 1 + (KS == 3 ? 2 : 0));
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");
};

// pixel i of a shifted line from two neighbouring 32-bit words (2 px each):
// the high pixel of ``lo`` and the low pixel of ``hi``
__device__ __forceinline__ uint32_t straddle(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5432);
}

template <int KS>
__device__ __forceinline__ void dagg_mma(float (&acc)[DgCfg<KS>::N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (KS == 3)
    hopper::wgmma_m64n192k16_bf16_kk(acc, da, db);
  else
    hopper::wgmma_m64n64k16_bf16_kk(acc, da, db);
}

// Grid: (Cin tiles x Cout tiles, row chunks, B). Every role walks the same
// step sequence: for each 64-pixel column tile, the g rows row0 - P ..
// row1 - 1 + P of the chunk (x rows only where they lie inside the chunk).
template <int KS>
__global__ void __launch_bounds__(DgCfg<KS>::THREADS, 1)
osconv_dagg_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap hmap, float* __restrict__ out,
                         int Cin, int H, int W, int Cout, int rows_per_chunk,
                         long long chunk_stride) {
  using C = DgCfg<KS>;
  using namespace hopper;
  constexpr int S = C::STAGES, P = C::HALO, KK = KS * KS;
  extern __shared__ uint8_t smem_raw[];
  // tma_full: the stage's copies landed; full: (3x3) its shifted g rows are
  // built too; empty: every consumer is done with it
  __shared__ __align__(8) uint64_t tma_full[S], full[S], empty[S];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int n_otile = (Cout + TG_CH - 1) / TG_CH;
  const int i0 = (blockIdx.x / n_otile) * TG_CH, o0 = (blockIdx.x % n_otile) * TG_CH;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int row0 = chunk * rows_per_chunk;
  const int nrows = min(H, row0 + rows_per_chunk) - row0;
  const int steps = nrows + 2 * P;  // per column tile
  const int nx = (W + TG_PX - 1) / TG_PX;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&tma_full[s], 1);
      mbar_init(&full[s], 2);            // one arrival per shift warp
      mbar_init(&empty[s], 4 * KS);      // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::PRODUCER_WARP) {
    if (lane != 0) return;
    int u = 0;
    for (int cx = 0; cx < nx; ++cx) {
      const int x0 = cx * TG_PX;
      const bool left = KS == 3 && x0 > 0, right = KS == 3 && x0 + TG_PX < W;
      for (int t = 0; t < steps; ++t, ++u) {
        const int s = u % S;
        mbar_wait(&empty[s], ((u / S) & 1) ^ 1);
        const int r = row0 - P + t;
        const bool has_x = t >= P && t < nrows + P;
        mbar_arrive_expect_tx(&tma_full[s], TG_BOX * (1 + int(has_x)) +
                                                (int(left) + int(right)) * TG_HALO_BYTES);
        uint8_t* st = smem + s * C::STAGE_BYTES;
        tma_load_4d(st + C::GC_OFF, &gmap, &tma_full[s], x0, o0, r, b);
        if (has_x) tma_load_4d(st + C::X_OFF, &xmap, &tma_full[s], x0, i0, r, b);
        if (left)
          tma_load_4d(st + C::HALO_OFF, &hmap, &tma_full[s], x0 - TG_HALO_PX, o0, r, b);
        if (right)
          tma_load_4d(st + C::HALO_OFF + TG_HALO_BYTES, &hmap, &tma_full[s], x0 + TG_PX, o0, r,
                      b);
      }
    }
    return;
  }

  if (warp > C::PRODUCER_WARP) {
    // shift warps (3x3): thread o rebuilds g channel o of the stage's row
    // read one pixel to the right (dx = 0) and to the left (dx = 2), with the
    // halo pixel, or the zero padding, at the end
    if constexpr (KS == 3) {
      const int o = (warp - C::PRODUCER_WARP - 1) * 32 + lane;
      const int line = o * 128, sw = o % 8;  // 128-byte swizzle: chunk j sits at j ^ (o % 8)
      int u = 0;
      for (int cx = 0; cx < nx; ++cx) {
        const int x0 = cx * TG_PX;
        const bool left = x0 > 0, right = x0 + TG_PX < W;
        for (int t = 0; t < steps; ++t, ++u) {
          const int s = u % S;
          mbar_wait(&tma_full[s], (u / S) & 1);
          uint8_t* st = smem + s * C::STAGE_BYTES;
          uint4 v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = *reinterpret_cast<const uint4*>(st + C::GC_OFF + line + ((j ^ sw) << 4));
          const __nv_bfloat16* h =
              reinterpret_cast<const __nv_bfloat16*>(st + C::HALO_OFF) + o * TG_HALO_PX;
          const uint32_t lpx = left ? __bfloat16_as_ushort(h[TG_HALO_PX - 1]) : 0u;
          const uint32_t rpx = right ? __bfloat16_as_ushort(h[TG_CH * TG_HALO_PX]) : 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t prev = j > 0 ? v[j - 1].w : (lpx << 16);
            const uint32_t next = j < 7 ? v[j + 1].x : rpx;
            const uint4 plus = make_uint4(straddle(v[j].x, v[j].y), straddle(v[j].y, v[j].z),
                                          straddle(v[j].z, v[j].w), straddle(v[j].w, next));
            const uint4 minus = make_uint4(straddle(prev, v[j].x), straddle(v[j].x, v[j].y),
                                           straddle(v[j].y, v[j].z), straddle(v[j].z, v[j].w));
            *reinterpret_cast<uint4*>(st + C::B_OFF + line + ((j ^ sw) << 4)) = plus;
            *reinterpret_cast<uint4*>(st + C::B_OFF + 2 * TG_BOX + line + ((j ^ sw) << 4)) =
                minus;
          }
          // the generic-proxy writes must be visible to wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup dy: at step t (t >= 2P) the x row of step t - P
  // against the g row of step t - dy (g row h - dy + P for x row h)
  const int dy = warp / 4;
  uint64_t* ready = KS == 3 ? full : tma_full;
  float acc[C::N / 2];
#pragma unroll
  for (int i = 0; i < C::N / 2; ++i) acc[i] = 0.f;
  int u = 0;
  for (int cx = 0; cx < nx; ++cx) {
    for (int t = 0; t < steps; ++t, ++u) {
      mbar_wait(&ready[u % S], (u / S) & 1);
      if (t < 2 * P) continue;
      const uint32_t xa = smem_u32(smem + ((u - P) % S) * C::STAGE_BYTES + C::X_OFF);
      const uint32_t gb = smem_u32(smem + ((u - dy) % S) * C::STAGE_BYTES + C::B_OFF);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < TG_PX / 16; ++k)
        dagg_mma<KS>(acc, make_desc(xa + 32 * k, 16, 1024, kSwizzle128),
                     make_desc(gb + 32 * k, 16, 1024, kSwizzle128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // the oldest stage in use (its x row served step t - 1, its g row now)
      if (lane == 0) mbar_arrive(&empty[(u - 2 * P) % S]);
    }
    // the column tile's last 2P stages, not released above
    if (lane == 0)
      for (int q = 1; q <= 2 * P; ++q) mbar_arrive(&empty[(u - q) % S]);
  }

  // acc[4i + 2j + c]: input channel i0 + 16*(warp%4) + lane/4 + 8j, column
  // n = 8i + 2*(lane%4) + c = dx*64 + (output channel - o0)
  float* ob = out + chunk * chunk_stride + (long long)b * KK * Cin * Cout;
  const bool pairs = (Cout & 1) == 0;  // o is even, so a pair is 8-byte aligned
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ci = i0 + 16 * (warp % 4) + lane / 4 + 8 * j;
    if (ci >= Cin) continue;
#pragma unroll
    for (int i = 0; i < C::N / 8; ++i) {
      const int n = 8 * i + 2 * (lane % 4);
      const int o = o0 + n % TG_CH;
      if (o >= Cout) continue;
      float* p = ob + ((long long)(dy * KS + n / TG_CH) * Cin + ci) * Cout + o;
      const float a0 = acc[4 * i + 2 * j], a1 = acc[4 * i + 2 * j + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(a0, a1);
      } else {
        p[0] = a0;
        if (o + 1 < Cout) p[1] = a1;
      }
    }
  }
}

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // a tensor map was refused

template <int KS>
int launch_dagg_wgmma(const void* x, long long x_bstride, long long x_pitch, const void* g,
                      long long g_bstride, long long g_pitch, float* out, float* scratch,
                      int nchunks, int rows_per_chunk, int B, int Cin, int H, int W, int Cout,
                      cudaStream_t stream) {
  using C = DgCfg<KS>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(osconv_dagg_wgmma_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  // maps ordered (W, C, H, B), so that a box lands as [ch][px]
  CUtensorMap xmap, gmap, hmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)W, (cuuint64_t)Cin, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t gdims[4] = {(cuuint64_t)W, (cuuint64_t)Cout, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)x_pitch * H * 2, (cuuint64_t)x_pitch * 2,
                              (cuuint64_t)x_bstride * 2};
  const cuuint64_t gstr[3] = {(cuuint64_t)g_pitch * H * 2, (cuuint64_t)g_pitch * 2,
                              (cuuint64_t)g_bstride * 2};
  const cuuint32_t box[4] = {TG_PX, TG_CH, 1, 1};
  const cuuint32_t hbox[4] = {TG_HALO_PX, TG_CH, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstr, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(g), gdims, gstr, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(g), gdims, gstr, hbox,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  const long long n = (long long)B * KS * KS * Cin * Cout;
  dim3 grid(((Cin + TG_CH - 1) / TG_CH) * ((Cout + TG_CH - 1) / TG_CH), nchunks, B);
  osconv_dagg_wgmma_kernel<KS><<<grid, C::THREADS, C::SMEM, stream>>>(
      xmap, gmap, hmap, nchunks > 1 ? scratch : out, Cin, H, W, Cout, rows_per_chunk, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nchunks == 1) return static_cast<int>(e);
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  dagg_reduce_kernel<<<blocks < 1024 ? blocks : 1024, THREADS, 0, stream>>>(scratch, out, n,
                                                                            nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  if (e == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (e == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16; ksize 1 or 3; 0 <= pad <= ksize - 1.
extern "C" int savsr_osconv_agg(int ksize, int dtype, const void* x, const void* agg, void* out,
                                int B, int Cin, int H, int W, int Cout, int pad, void* stream) {
  if ((ksize != 1 && ksize != 3) || dtype < 0 || dtype > 1 || pad < 0 || pad >= ksize)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = ksize == 3 ? launch_agg<float, 3>(x, agg, out, B, Cin, H, W, Cout, pad, s)
                   : launch_agg<float, 1>(x, agg, out, B, Cin, H, W, Cout, pad, s);
  else
    e = ksize == 3 ? launch_agg<__nv_bfloat16, 3>(x, agg, out, B, Cin, H, W, Cout, pad, s)
                   : launch_agg<__nv_bfloat16, 1>(x, agg, out, B, Cin, H, W, Cout, pad, s);
  return static_cast<int>(e);
}

// The pixel rows are cut into `nchunks` chunks of `rows_per_chunk` rows (a
// multiple of 2); with nchunks > 1, `scratch` holds nchunks f32 copies of the
// output's size for the partial sums.
extern "C" int savsr_osconv_dagg(int ksize, int dtype, const void* x, const void* g, void* out,
                                 void* scratch, int nchunks, int rows_per_chunk, int B, int Cin,
                                 int H, int W, int Cout, int pad, void* stream) {
  const int Ho = H + 2 * pad - ksize + 1;
  if ((ksize != 1 && ksize != 3) || dtype < 0 || dtype > 1 || pad < 0 || pad >= ksize ||
      nchunks < 1 || rows_per_chunk < DR || rows_per_chunk % DR != 0 ||
      (long long)nchunks * rows_per_chunk < Ho || (nchunks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e;
  if (dtype == 0)
    e = ksize == 3
            ? launch_dagg<float, 3>(x, g, o, sc, nchunks, rows_per_chunk, B, Cin, H, W, Cout, pad, s)
            : launch_dagg<float, 1>(x, g, o, sc, nchunks, rows_per_chunk, B, Cin, H, W, Cout, pad, s);
  else
    e = ksize == 3 ? launch_dagg<__nv_bfloat16, 3>(x, g, o, sc, nchunks, rows_per_chunk, B, Cin, H,
                                                   W, Cout, pad, s)
                   : launch_dagg<__nv_bfloat16, 1>(x, g, o, sc, nchunks, rows_per_chunk, B, Cin, H,
                                                   W, Cout, pad, s);
  return static_cast<int>(e);
}

// The tensor-core weight gradient: bf16, padding ksize / 2 (so Ho = H, Wo =
// W). x and g are read through TMA: a row pitch (elements) that is a
// multiple of 8, a 16-byte aligned base and batch stride. The rows are cut
// into `nchunks` chunks of `rows_per_chunk` (any count); with nchunks > 1,
// `scratch` holds nchunks f32 copies of the output's size.
extern "C" int savsr_osconv_dagg_wgmma(int ksize, const void* x, long long x_bstride,
                                       long long x_pitch, const void* g, long long g_bstride,
                                       long long g_pitch, void* out, void* scratch, int nchunks,
                                       int rows_per_chunk, int B, int Cin, int H, int W,
                                       int Cout, void* stream) {
  if ((ksize != 1 && ksize != 3) || x_pitch % 8 != 0 || g_pitch % 8 != 0 || x_pitch < W ||
      g_pitch < W || x_bstride % 8 != 0 || g_bstride % 8 != 0 || nchunks < 1 ||
      rows_per_chunk < 1 || (long long)nchunks * rows_per_chunk < H ||
      (nchunks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  return ksize == 3 ? launch_dagg_wgmma<3>(x, x_bstride, x_pitch, g, g_bstride, g_pitch, o, sc,
                                           nchunks, rows_per_chunk, B, Cin, H, W, Cout, s)
                    : launch_dagg_wgmma<1>(x, x_bstride, x_pitch, g, g_bstride, g_pitch, o, sc,
                                           nchunks, rows_per_chunk, B, Cin, H, W, Cout, s);
}
