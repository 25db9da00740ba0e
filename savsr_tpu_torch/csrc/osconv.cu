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
// osconv_agg_kernel and osconv_dagg_kernel (f32 only: the wrapper widens bf16
// inputs first).
//
// Bound on the H100: at the training shapes (8 samples of 60x60, Cin 64..320,
// Cout 64, or the reverse for dx) each does 2*9*Cin*Cout FLOPs per pixel
// against (Cin + Cout) values moved per pixel plus the 9*Cin*Cout weights of
// each sample, so both are bound by operations: in f32 held to the 67 TFLOP/s
// CUDA-core rate, in bf16 to the 989 TFLOP/s tensor-core rate. The CUDA-core
// kernels work in f32 (bf16 inputs are widened) and cannot approach the bf16
// bound; that is why bf16 goes to the tensor cores.
//
// Design, CUDA-core forward/dx: a block computes a 64-channel x 8-row x
// 32-column output tile; each warp owns 8 output channels, each lane one
// column of 8 rows (64 accumulators in registers). Input channels stream
// through shared memory 8 at a time with a bounds-checked halo (no padded
// copy of x), the sample's weights for those channels are broadcast from
// shared memory. The weight layout [tap][Cin][Cout] makes the weight loads
// contiguous in Cout.
//
// Design, CUDA-core weight gradient (f32; bf16 inputs are widened by the
// wrapper): per (sample, tap) the gradient is a GEMM, M = Cin, N = Cout, K =
// the pixels, and the tap's shift is moved from x to g (as on the tensor
// cores below), so x rows are staged as they lie. The TPU kernel carries its
// [P, Cin, Cout] accumulator across the sequential row-tile steps of one
// sample; blocks on this card run in no order and carry nothing over. Here a
// block owns (sample, 64-Cin tile, 64-Cout tile, chunk of pixel rows,
// segment of up to 64 columns) and one group of 128 threads per dy tap, each
// thread 8 Cin x 4 Cout x the K dx taps (96 f32 accumulators at K = 3). It
// walks its chunk one x row at a time: 4-byte cp.async lands the next x row
// and the next g row (a ring of K + 1 g rows, zero columns at the image's
// edges) while the block computes the current one, and along the row the
// threads take 4 pixels at a time, so 4 pixels are 12 16-byte shared loads
// for 384 FMAs. The wrapper sizes the chunks so
// that the blocks fill one wave of the card's SMs (one block per SM). With
// more than one chunk or segment the blocks write f32 partials [part][B][P]
// [Cin][Cout] and a second kernel adds them in part order, so the sum order
// is fixed and the result is the same from run to run (no atomics).
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

constexpr int DG_CH = 64;   // Cin and Cout per block (8 and 16 thread groups x 8 and 4)
constexpr int DG_SEG = 64;  // pixel columns per block (a longer row is cut into segments)
// row pitches (floats), 4 mod 8: 16-byte loads of 8 rows hit distinct banks.
// An x row holds the segment's columns; a g row holds column c of the image
// at c - c0 - pad + DG_G0, so the column of step j (x column c0 + j, g
// column c0 + j + pad) sits at j + DG_G0 and the two before it (the dx taps
// reach back 2) at j + 2 and j + 3
constexpr int DG_XP = DG_SEG + 4;
constexpr int DG_G0 = 4;
constexpr int DG_GP = DG_SEG + 12;

template <int KS>
struct DgRows {
  static constexpr int THREADS = 128 * KS;  // one group of 128 per dy tap
  static constexpr int NG = KS + 1;          // g rows in the ring: KS in use, 1 landing
  static constexpr int X_FLOATS = 2 * DG_CH * DG_XP;
  static constexpr int SMEM = 4 * (X_FLOATS + NG * DG_CH * DG_GP);
};

// cp.async of one channel row per warp at a time, 4 bytes a lane: x row y
// (the segment's columns) into x slot `xs`, and g row gr, if 0 <= gr < Ho
// (the columns the segment's steps read, clipped to the image), into its
// ring slot gr % NG
template <int KS>
__device__ __forceinline__ void dagg_stage_x(float* s_x, const float* xb, int y, int i0, int Cin,
                                             int H, int W, int c0, int sw, int xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xd = s_x + xs * DG_CH * DG_XP;
  for (int ci = warp; ci < DG_CH && i0 + ci < Cin; ci += DgRows<KS>::THREADS / 32)
    for (int c = lane; c < sw; c += 32)
      hopper::cp_async4(xd + ci * DG_XP + c,
                        xb + (long long)(i0 + ci) * H * W + (long long)y * W + c0 + c);
}

template <int KS>
__device__ __forceinline__ void dagg_stage_g(float* s_g, const float* gb, int gr, int o0, int Cout,
                                             int Ho, int Wo, int c0, int sw, int pad) {
  if (gr < 0 || gr >= Ho) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* gd = s_g + (gr % DgRows<KS>::NG) * DG_CH * DG_GP + DG_G0 - c0 - pad;
  // the columns steps 0..sw-1 read, and the two before (zero off the image)
  const int g0 = max(c0 + pad - 2, 0), g1 = min(c0 + sw + pad, Wo);
  for (int o = warp; o < DG_CH && o0 + o < Cout; o += DgRows<KS>::THREADS / 32)
    for (int c = g0 + lane; c < g1; c += 32)
      hopper::cp_async4(gd + o * DG_GP + c,
                        gb + (long long)(o0 + o) * Ho * Wo + (long long)gr * Wo + c);
}

// The weight gradient as shifted-g GEMMs (see the file's comment): a block
// owns (sample, 64-Cin tile, 64-Cout tile, chunk of x rows, segment of x
// columns) and KS groups of 128 threads, one per dy. Thread (cig, cog) of a
// group holds input channels cig + 8k (k < 8) x output channels cog + 16m (m
// < 4) x the KS dx taps: 96 f32 accumulators at KS = 3. Each step stages one
// x row and the newest g row (a ring of KS + 1 g rows) with cp.async while
// the previous step computes; group dy multiplies x row y by g row y + pad -
// dy. Along the row the threads walk 4 pixels at a time: per pixel quad 8
// 16-byte x loads and 4 16-byte g loads (the g columns of the two steps
// before stay in registers for the dx taps), and 8 x 4 x KS x 4 FMAs. The 2
// x 16 threads of a warp read 2 x rows (broadcast) and 16 g rows at a
// pitch of 4 mod 8 (distinct banks for each 8-thread phase).
template <int KS>
__global__ void __launch_bounds__(DgRows<KS>::THREADS, 1)
osconv_dagg_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ out, int Cin, int H, int W, int Cout, int Ho, int Wo,
                   int pad, int rows_per_chunk, int nseg, long long chunk_stride) {
  using Cfg = DgRows<KS>;
  constexpr int KK = KS * KS;
  extern __shared__ __align__(16) float dg_smem[];
  float* s_x = dg_smem;                 // [2][DG_CH][DG_XP]
  float* s_g = dg_smem + Cfg::X_FLOATS;  // [NG][DG_CH][DG_GP] (see DG_G0)

  const int dy = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int cog = lt % 16, cig = lt / 16;
  const int n_otile = (Cout + DG_CH - 1) / DG_CH;
  const int i0 = (blockIdx.x / n_otile) * DG_CH, o0 = (blockIdx.x % n_otile) * DG_CH;
  const int part = blockIdx.y, b = blockIdx.z;
  const int chunk = part / nseg, c0 = (part % nseg) * DG_SEG;
  const int sw = min(DG_SEG, W - c0);
  const int r0 = chunk * rows_per_chunk, r1 = min(H, r0 + rows_per_chunk);
  const float* xb = x + (long long)b * Cin * H * W;
  const float* gb = g + (long long)b * Cout * Ho * Wo;

  // columns off the image (g) or past the segment (x, read by the last
  // 4-pixel step) stay zero: the copies never write them
  for (int e = threadIdx.x; e < Cfg::X_FLOATS + Cfg::NG * DG_CH * DG_GP; e += Cfg::THREADS)
    dg_smem[e] = 0.f;
  __syncthreads();

  float acc[8][4][KS];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int d = 0; d < KS; ++d) acc[k][m][d] = 0.f;

  // the g rows that x row r0 needs before its newest one, then the first step
  for (int gr = r0 + pad - KS + 1; gr < r0 + pad; ++gr)
    dagg_stage_g<KS>(s_g, gb, gr, o0, Cout, Ho, Wo, c0, sw, pad);
  if (r0 < r1) {
    dagg_stage_x<KS>(s_x, xb, r0, i0, Cin, H, W, c0, sw, 0);
    dagg_stage_g<KS>(s_g, gb, r0 + pad, o0, Cout, Ho, Wo, c0, sw, pad);
  }
  hopper::cp_async_commit();

  for (int y = r0; y < r1; ++y) {
    if (y + 1 < r1) {  // the next step's rows land while this one computes
      dagg_stage_x<KS>(s_x, xb, y + 1, i0, Cin, H, W, c0, sw, (y + 1 - r0) & 1);
      dagg_stage_g<KS>(s_g, gb, y + 1 + pad, o0, Cout, Ho, Wo, c0, sw, pad);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const int gr = y + pad - dy;
    if (gr >= 0 && gr < Ho) {
      const float* xr = s_x + ((y - r0) & 1) * DG_CH * DG_XP + cig * DG_XP;
      const float* grow = s_g + (gr % Cfg::NG) * DG_CH * DG_GP + cog * DG_GP;
      float2 prev[4];  // per output channel the g columns of steps j0 - 2, j0 - 1
#pragma unroll
      for (int m = 0; m < 4; ++m)
        prev[m] = *reinterpret_cast<const float2*>(grow + 16 * m * DG_GP + DG_G0 - 2);
      for (int j0 = 0; j0 < sw; j0 += 4) {  // 4 pixels a step: 16-byte loads
        float4 gv[4], xv[8];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          gv[m] = *reinterpret_cast<const float4*>(grow + 16 * m * DG_GP + DG_G0 + j0);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          xv[k] = *reinterpret_cast<const float4*>(xr + 8 * k * DG_XP + j0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float xk = u == 0 ? xv[k].x : u == 1 ? xv[k].y : u == 2 ? xv[k].z : xv[k].w;
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
              for (int d = 0; d < KS; ++d) {  // tap dx = d reads the column of step j0 + u - d
                const int s = u - d;
                const float gk = s == 0 ? gv[m].x : s == 1 ? gv[m].y : s == 2 ? gv[m].z
                               : s == 3 ? gv[m].w : s == -1 ? prev[m].y : prev[m].x;
                acc[k][m][d] = fmaf(xk, gk, acc[k][m][d]);
              }
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) prev[m] = make_float2(gv[m].z, gv[m].w);
      }
    }
    __syncthreads();
  }

  float* ob = out + part * chunk_stride + (long long)b * KK * Cin * Cout;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = i0 + cig + 8 * k;
    if (i >= Cin) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int o = o0 + cog + 16 * m;
      if (o >= Cout) continue;
#pragma unroll
      for (int d = 0; d < KS; ++d)
        ob[((long long)(dy * KS + d) * Cin + i) * Cout + o] = acc[k][m][d];
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

template <int KS>
cudaError_t launch_dagg(const float* x, const float* g, float* out, float* scratch, int nchunks,
                        int rows_per_chunk, int B, int Cin, int H, int W, int Cout, int pad,
                        cudaStream_t stream) {
  using Cfg = DgRows<KS>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(osconv_dagg_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int Ho = H + 2 * pad - KS + 1, Wo = W + 2 * pad - KS + 1;
  const int nseg = (W + DG_SEG - 1) / DG_SEG, nparts = nchunks * nseg;
  const long long n = (long long)B * KS * KS * Cin * Cout;
  dim3 grid(((Cin + DG_CH - 1) / DG_CH) * ((Cout + DG_CH - 1) / DG_CH), nparts, B);
  osconv_dagg_kernel<KS><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      x, g, nparts > 1 ? scratch : out, Cin, H, W, Cout, Ho, Wo, pad, rows_per_chunk, nseg, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nparts == 1) return e;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  dagg_reduce_kernel<<<blocks < 1024 ? blocks : 1024, THREADS, 0, stream>>>(scratch, out, n,
                                                                            nparts);
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

// f32 on the CUDA cores. The pixel rows of x are cut into `nchunks` chunks
// of `rows_per_chunk` rows and each row into segments of DG_SEG columns (the
// wrapper's plan: ops/osconv.py dagg_plan); with more than one part (chunk
// x segment), `scratch` holds that many f32 copies of the output's size for
// the partial sums.
extern "C" int savsr_osconv_dagg(int ksize, const void* x, const void* g, void* out,
                                 void* scratch, int nchunks, int rows_per_chunk, int B, int Cin,
                                 int H, int W, int Cout, int pad, void* stream) {
  const int nparts = nchunks * ((W + DG_SEG - 1) / DG_SEG);
  if ((ksize != 1 && ksize != 3) || pad < 0 || pad >= ksize || nchunks < 1 ||
      rows_per_chunk < 1 || (long long)nchunks * rows_per_chunk < H ||
      (nparts > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const int r = rows_per_chunk;
  return static_cast<int>(
      ksize == 3 ? launch_dagg<3>(xf, gf, o, sc, nchunks, r, B, Cin, H, W, Cout, pad, s)
                 : launch_dagg<1>(xf, gf, o, sc, nchunks, r, B, Cin, H, W, Cout, pad, s));
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
