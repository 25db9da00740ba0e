// Fused STAU upsampler — kernel 4 of the serving path.
//
// Replaces savsr_tpu/ops/pallas/stau_kernel.py::stau_upsample_fused. Per HR
// pixel P, with precomputed LR sampling coordinates (pix planes, f32):
//     f0   = bilinear(x,   fy_f(P), fx_f(P))     zeros padding, align_corners=True
//     sa   = bilinear(sta, fy_s(P), fx_s(P))
//     z_n  = Wc_n f0                  (n experts, Wc_n: [C/8, C])
//     fc   = sum_n r_n(P) z_n
//     fea  = f0 + sum_n r_n(P) We_n fc (We_n: [C, C/8])
//     out  = Wfus [sa; fea] + bias    (Wfus: [Cout, 2C])
// with the TPU kernel's rounding points: f0, sa, r_n*fc and fea are rounded
// to the I/O type before the next product (no-ops in f32).
//
// The TPU kernel samples with "hat" matrices on the MXU over a band of LR
// rows per group of HR rows (band starts j0/g0 precomputed on the host).
// Here each HR pixel gathers its 4 taps.
//
// Bound on the H100: ~12.3K multiply-adds per HR pixel at C=64 against
// ~(Cout + 8) values moved per HR pixel (the LR inputs are small): ~190
// FLOP per byte in f32, bound by operations at the 67 TFLOP/s CUDA-core
// rate; in bf16, against the 989 TFLOP/s tensor-core rate, bound by bytes
// (the output write). Two kernels, one per type:
//
// * f32 (stau_kernel, CUDA cores): persistent blocks (2 per SM) keep all
//   expert and fusion weights in shared memory and walk 64-pixel row
//   segments. Per segment the block gathers f0 and sa from device memory
//   into shared memory, then runs the three small products as shared-memory
//   GEMMs (f32 FMA, 4x4 register tiles).
//
// * bf16 (stau_mma_kernel, tensor cores): the sampling positions depend
//   only on the static coordinate embedding, so the wrapper plans, once per
//   (shape, scale), the LR window each tile of 8 HR rows x 64 HR columns
//   reads (ops/stau.py stau_window_plan: per sampler a box of LR rows and
//   columns, its left edge on an 8-pixel boundary). A persistent block (one
//   per SM, 16 warps) walks tiles (spatial tile, sample); while it computes
//   one tile, cp.async brings the next tile's two boxes (NCHW) into a
//   landing buffer, and between tiles the block transposes them into the
//   staging buffer with channels innermost (a pixel's C channels in one
//   2C-byte slot, ordered so that lane q of a quad reads its 4*C/16
//   channels as one contiguous run), so a tap of 16 channels is one or two
//   16-byte shared loads instead of 16 scalar device loads. Tiles whose
//   boxes exceed the staging capacity (large offsets) gather straight from
//   device memory with the same arithmetic. Each warp takes 32 pixels of a
//   tile row in two passes of 16 (one m16 tile), pixels as the MMA's M, and
//   runs the small products on mma.sync m16n8k16 (bf16 in, f32
//   accumulators): compress Z = F0 * Wc^T (N = 4 experts x 8, padded), the
//   routing on the Z fragments in registers, STK (built from the fragments:
//   an accumulator fragment of n-tiles 2k, 2k+1 is the A fragment of k-block
//   k), expand FEA = F0 + STK * We^T. The fusion [sa | fea] * Wfus^T runs on
//   wgmma (m64nCk16, A from the four warps' registers, Wfus from shared
//   memory), the sa half in flight while the warps compute f0 and the
//   experts. No intermediate leaves the registers. The weights sit in shared
//   memory, packed once (ops/stau.py pack_stau_weights). The output tile
//   goes through shared memory and leaves as 16-byte stores along W. The
//   bilinear taps stay f32 FMAs on the CUDA cores, as in the f32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CMAX = 64;    // feature channels (C % 8 == 0, C <= 64)
constexpr int KMAX = 32;    // n_experts * C/8
constexpr int OMAX = 64;    // output channels
constexpr int NP = 64;      // HR pixels per segment
constexpr int NPLANE = 8;   // fy_f, fx_f, fy_s, fx_s, r_0..r_3
constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }

// bilinear sample of one [h, w] plane, zeros outside the image
template <typename T>
__device__ __forceinline__ float bilinear(const T* plane, int h, int w, float fy, float fx) {
  const float yf = floorf(fy), xf = floorf(fx);
  const float wy1 = fy - yf, wx1 = fx - xf;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  float v = 0.f;
  // compare in float before converting: coordinates may lie far outside
  const bool ya = yf >= 0.f && yf <= h - 1, yb = yf + 1.f >= 0.f && yf + 1.f <= h - 1;
  const bool xa = xf >= 0.f && xf <= w - 1, xb = xf + 1.f >= 0.f && xf + 1.f <= w - 1;
  const int y = (int)fmaxf(fminf(yf, (float)h), -1.f);
  const int x = (int)fmaxf(fminf(xf, (float)w), -1.f);
  if (ya && xa) v += (wy0 * wx0) * ld(plane, (long long)y * w + x);
  if (ya && xb) v += (wy0 * wx1) * ld(plane, (long long)y * w + x + 1);
  if (yb && xa) v += (wy1 * wx0) * ld(plane, (long long)(y + 1) * w + x);
  if (yb && xb) v += (wy1 * wx1) * ld(plane, (long long)(y + 1) * w + x + 1);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stau_kernel(const T* __restrict__ x, const T* __restrict__ sta, const float* __restrict__ pix,
            const T* __restrict__ wc, const T* __restrict__ we, const T* __restrict__ wfus,
            const float* __restrict__ bias, T* __restrict__ out, int B, int C, int NE, int Cout,
            int h, int w, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_wc = smem;                       // [KMAX][CMAX]        Wc rows
  float* s_weT = s_wc + KMAX * CMAX;        // [KMAX][CMAX]        We transposed: [k][c]
  float* s_wfT = s_weT + KMAX * CMAX;       // [2*CMAX][OMAX]      Wfus transposed: [k][o]
  float* s_bias = s_wfT + 2 * CMAX * OMAX;  // [OMAX]
  float* s_pix = s_bias + OMAX;             // [NPLANE][NP]
  float* s_f0 = s_pix + NPLANE * NP;        // [CMAX][NP]
  float* s_cat = s_f0 + CMAX * NP;          // [2*CMAX][NP]: sa rows then fea rows
  float* s_stk = s_cat + 2 * CMAX * NP;     // [KMAX][NP]

  const int tid = threadIdx.x;
  const int E = C / 8, K = NE * E;
  for (int e = tid; e < K * C; e += THREADS) s_wc[(e / C) * CMAX + e % C] = ld(wc, e);
  for (int e = tid; e < C * K; e += THREADS) {  // we: [C][K]
    const int c = e / K, k = e % K;
    s_weT[k * CMAX + c] = ld(we, e);
  }
  for (int e = tid; e < Cout * 2 * C; e += THREADS) {  // wfus: [Cout][2C]
    const int o = e / (2 * C), k = e % (2 * C);
    s_wfT[k * OMAX + o] = ld(wfus, e);
  }
  for (int e = tid; e < Cout; e += THREADS) s_bias[e] = bias[e];

  const int segs_per_row = (W + NP - 1) / NP;
  const long long nseg = (long long)B * H * segs_per_row;
  const long long HWo = (long long)H * W, hw = (long long)h * w;
  const int tc = tid / 16, tp = tid % 16;  // 4x4 register tiles

  for (long long sg = blockIdx.x; sg < nseg; sg += gridDim.x) {
    const int b = (int)(sg / ((long long)H * segs_per_row));
    const int rem = (int)(sg % ((long long)H * segs_per_row));
    const int Y = rem / segs_per_row, X0 = (rem % segs_per_row) * NP;
    __syncthreads();  // previous segment done with shared buffers (and weights staged)
    for (int e = tid; e < (4 + NE) * NP; e += THREADS) {
      const int q = e / NP, p = e % NP;
      s_pix[q * NP + p] = X0 + p < W ? pix[q * HWo + (long long)Y * W + X0 + p] : 0.f;
    }
    __syncthreads();
    // 1. gathers: f0 from x at (fy_f, fx_f), sa from sta at (fy_s, fx_s)
    const T* xb = x + (long long)b * C * hw;
    const T* sb = sta + (long long)b * C * hw;
    for (int e = tid; e < C * NP; e += THREADS) {
      const int c = e / NP, p = e % NP;
      s_f0[c * NP + p] =
          round_to(bilinear(xb + c * hw, h, w, s_pix[0 * NP + p], s_pix[1 * NP + p]), x);
      s_cat[c * NP + p] =
          round_to(bilinear(sb + c * hw, h, w, s_pix[2 * NP + p], s_pix[3 * NP + p]), x);
    }
    __syncthreads();
    // 2. per (o, p): z_n = Wc_n[o] . f0, fc = sum_n r_n z_n, stk[n*E+o] = r_n fc
    for (int e = tid; e < E * NP; e += THREADS) {
      const int o = e / NP, p = e % NP;
      float fc = 0.f;
      for (int n = 0; n < NE; ++n) {
        const float* wrow = s_wc + (n * E + o) * CMAX;
        float z = 0.f;
        for (int c = 0; c < C; ++c) z = fmaf(wrow[c], s_f0[c * NP + p], z);
        fc = fmaf(s_pix[(4 + n) * NP + p], z, fc);
      }
      for (int n = 0; n < NE; ++n)
        s_stk[(n * E + o) * NP + p] = round_to(s_pix[(4 + n) * NP + p] * fc, x);
    }
    __syncthreads();
    // 3. fea[c] = f0[c] + sum_k We[c][k] stk[k]   (4 channels x 4 pixels per thread)
    if (4 * tc < C) {
      float a[4][4] = {};
      for (int k = 0; k < K; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_weT[k * CMAX + 4 * tc]);
        const float4 sv = *reinterpret_cast<const float4*>(&s_stk[k * NP + 4 * tp]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(wa[i], sa[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * tc + i, p = 4 * tp + j;
          s_cat[(C + c) * NP + p] = round_to(a[i][j] + s_f0[c * NP + p], x);
        }
    }
    __syncthreads();
    // 4. out[o] = Wfus[o] . [sa; fea] + bias   (4 outputs x 4 pixels per thread)
    if (4 * tc < Cout) {
      float a[4][4] = {};
      for (int k = 0; k < 2 * C; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_wfT[k * OMAX + 4 * tc]);
        const float4 sv = *reinterpret_cast<const float4*>(&s_cat[k * NP + 4 * tp]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(wa[i], sa[j], a[i][j]);
      }
      T* ob = out + (long long)b * Cout * HWo + (long long)Y * W + X0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = 4 * tc + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * tp + j;
          if (X0 + p < W) st(ob, o * HWo + p, a[i][j] + s_bias[o]);
        }
      }
    }
  }
}

constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * KMAX * CMAX + 2 * CMAX * OMAX + OMAX + NPLANE * NP + CMAX * NP +
                     2 * CMAX * NP + KMAX * NP);

template <typename T>
cudaError_t launch(const void* x, const void* sta, const float* pix, const void* wc,
                   const void* we, const void* wfus, const float* bias, void* out, int B, int C,
                   int NE, int Cout, int h, int w, int H, int W, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(stau_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nseg = (long long)B * H * ((W + NP - 1) / NP);
  const int grid = (int)(nseg < 2LL * sms ? nseg : 2LL * sms);
  stau_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(sta), pix, static_cast<const T*>(wc),
      static_cast<const T*>(we), static_cast<const T*>(wfus), bias, static_cast<T*>(out), B, C,
      NE, Cout, h, w, H, W);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: staged LR windows, products on mma.sync
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_ROWS = 8;          // HR rows per tile
constexpr int TC_COLS = 64;         // HR columns per tile
constexpr int TC_PASS = 16;         // pixels per warp pass: one m16 tile
constexpr int TC_WARPS = 16;        // two per row, 32 columns (two passes) each
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int STAGE_CAP = 600;      // staged LR pixel slots, both samplers' boxes together
constexpr int NE_PAD = 4;           // experts (fewer: zero weights, zero routing); each
                                    // expert's C/8 compress outputs padded to 8
constexpr int OUT_PITCH = TC_PASS + 8;  // bf16 per channel row of a warp's output tile

template <int CB>  // C = 16 * CB channels (CB 1, 2 or 4), Cout = C
struct StauCfg {
  static constexpr int C = 16 * CB;
  static constexpr int NT = 2 * CB;          // 8-wide n-tiles of C
  static constexpr int SLOT = 2 * C;         // bytes per staged LR pixel
  // packed weights in 256-byte blocks: compress and expand as mma.sync B
  // fragments, 128 bf16 per (k-block, n-tile), compress [CB][4], expand
  // [2][NT]; fusion as the wgmma B operand, K-major 8x8 core matrices, 16 C
  // bf16 per k-block of 16, [2 CB][C / 8][2][8][8]
  static constexpr int WC_OFF = 0, WE_OFF = 4 * CB, WF_OFF = WE_OFF + 2 * NT;
  static constexpr int W_BLOCKS = WF_OFF + 2 * CB * NT;
  static constexpr int WF_KBLOCK = 32 * C;  // bytes of a fusion k-block
  static constexpr int OFF_BIAS = W_BLOCKS * 256;
  static constexpr int OFF_STAGE = OFF_BIAS + 64 * 4;
  static constexpr int OFF_RAW = OFF_STAGE + STAGE_CAP * SLOT;
  static constexpr int OFF_OUT = OFF_RAW + (STAGE_CAP + 16) * SLOT;  // raw_stride pads
  static constexpr int SMEM = OFF_OUT + TC_WARPS * C * OUT_PITCH * 2;
  static_assert(SMEM <= 232448, "shared memory");
};

// one spatial tile's plan (ops/stau.py stau_window_plan): per sampler the LR
// box's first row and column and its rows and columns; zero sizes: gather
// from device memory
struct Plan {
  int yf, xf, ys, xs, nrf, ncf, nrs, ncs;
};

__device__ __forceinline__ Plan load_plan(const int4* plan, int st) {
  const int4 a = plan[2 * st], b = plan[2 * st + 1];
  return Plan{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// the staging position of channel c: lane q of a quad reads positions
// [4 CB q, 4 CB (q + 1)), k-block kb of them at 4 kb: channels 16 kb + 2q,
// +1, 16 kb + 8 + 2q, +1 — the two registers of the lane's A fragment
template <int CB>
__device__ __forceinline__ int stage_pos(int c) {
  const int kb = c / 16, r = c % 16;
  return 4 * CB * ((r % 8) / 2) + 4 * kb + 2 * (r / 8) + (r % 2);
}

// the landing buffer's channel stride for a box of npx pixels: an odd
// number of 16-byte units, so that stage_transpose reads without bank
// conflicts
__device__ __forceinline__ int raw_stride(int npx) { return (npx / 8) % 2 ? npx : npx + 8; }

// cp.async (16-byte pieces, ``vec``) or plain loads of one box of ``src`` (one
// sample, [C, h, w]) into the landing buffer as [C][raw_stride(nr nc)]. A
// thread keeps one 8-pixel position of the box (neighbouring threads take
// neighbouring positions along a row) and walks the channels.
template <int CB>
__device__ __forceinline__ void stage_issue(bf16* raw, const bf16* src, int h, int w, int y0,
                                            int x0, int nr, int nc, bool vec) {
  constexpr int C = 16 * CB;
  const int per_row = nc / 8, npos = nr * per_row;  // npos <= STAGE_CAP / 8 < TC_THREADS
  const int step = TC_THREADS / npos;
  if ((int)threadIdx.x >= step * npos) return;
  const int pos = threadIdx.x % npos, r = pos / per_row, k = pos % per_row;
  const long long hw = (long long)h * w;
  const int S = raw_stride(nr * nc), xs = x0 + 8 * k;
  bf16* dst = raw + r * nc + 8 * k;
  const bf16* g = src + ((long long)y0 + r) * w + xs;
  for (int c = threadIdx.x / npos; c < C; c += step) {
    if (vec) {
      cp_async16(dst + c * S, g + c * hw);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[c * S + j] = xs + j < w ? g[c * hw + j] : __float2bfloat16_rn(0.f);
    }
  }
}

// landing buffer -> staging slots [npx][2C bytes], channel c at
// stage_pos(c); a thread moves 8 pixels of one channel pair. Lanes take
// consecutive pairs, so the 4-byte writes of a warp fall in distinct banks;
// lanes 4-7 of each 8 read the pair's odd channel first, which with the odd
// stride puts the 16-byte reads of 8 lanes in distinct bank groups.
template <int CB>
__device__ __forceinline__ void stage_transpose(uint8_t* stage, const bf16* raw, int npx) {
  constexpr int C = 16 * CB, PAIRS = C / 2;
  const int n = PAIRS * (npx / 8), S = raw_stride(npx);
  for (int i = threadIdx.x; i < n; i += TC_THREADS) {
    const int cp = i % PAIRS, k = i / PAIRS, t = (cp >> 2) & 1;
    const uint4 first = *reinterpret_cast<const uint4*>(raw + (2 * cp + t) * S + 8 * k);
    const uint4 second = *reinterpret_cast<const uint4*>(raw + (2 * cp + 1 - t) * S + 8 * k);
    const uint4 lo = t ? second : first, hi = t ? first : second;
    const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, u[4] = {hi.x, hi.y, hi.z, hi.w};
    uint8_t* dst = stage + (8 * k) * (2 * C) + 2 * stage_pos<CB>(2 * cp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint32_t*>(dst + (2 * j) * (2 * C)) = __byte_perm(l[j], u[j], 0x5410);
      *reinterpret_cast<uint32_t*>(dst + (2 * j + 1) * (2 * C)) = __byte_perm(l[j], u[j], 0x7632);
    }
  }
}

// where a sampler's taps come from: the staged box (slots of 2C bytes, box
// origin y0/x0, nc columns) or, for a tile without one, device memory
struct Source {
  const uint8_t* stage;  // null: device memory
  const bf16* plane0;    // this sample's channel 0 in device memory
  int y0, x0, nc;
};

// the bilinear sample of one HR pixel at (fy, fx), as the f32 sums of lane
// q's channels, v[kb] = {16 kb + 2q, +1, 16 kb + 8 + 2q, +1}; taps outside
// the image are skipped (their weight is never multiplied in)
template <int CB>
__device__ __forceinline__ void sample(float (&v)[CB][4], const Source& s, float fy, float fx,
                                       int h, int w, int q, int g) {
#pragma unroll
  for (int kb = 0; kb < CB; ++kb)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[kb][j] = 0.f;
  const float yf = floorf(fy), xf = floorf(fx);
  const float wy1 = fy - yf, wx1 = fx - xf;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  // compare in float before converting: coordinates may lie far outside
  const bool ya = yf >= 0.f && yf <= h - 1, yb = yf + 1.f >= 0.f && yf + 1.f <= h - 1;
  const bool xa = xf >= 0.f && xf <= w - 1, xb = xf + 1.f >= 0.f && xf + 1.f <= w - 1;
  const int y = (int)fmaxf(fminf(yf, (float)h), -1.f);
  const int x = (int)fmaxf(fminf(xf, (float)w), -1.f);
  const bool ok[4] = {ya && xa, ya && xb, yb && xa, yb && xb};
  const float wt[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
  const long long hw = (long long)h * w;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!ok[t]) continue;
    const int ty = y + t / 2, tx = x + t % 2;
    uint32_t d[2 * CB];  // lane q's channels as bf16 pairs, in v's order
    if (s.stage) {
      const uint8_t* p = s.stage + ((ty - s.y0) * s.nc + (tx - s.x0)) * (32 * CB) + q * (8 * CB);
      if constexpr (CB == 4) {
        // two 16-byte pieces; odd quads read their second piece first, so
        // the 8 lanes of a quarter warp (two pixels) hit 8 distinct bank
        // groups
        const int o = g & 1;
        const uint4 a = *reinterpret_cast<const uint4*>(p + 16 * o);
        const uint4 b = *reinterpret_cast<const uint4*>(p + 16 * (o ^ 1));
        const uint4 u0 = o ? b : a, u1 = o ? a : b;
        const uint32_t e[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = e[j];
      } else if constexpr (CB == 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        d[0] = u.x;
        d[1] = u.y;
        d[2] = u.z;
        d[3] = u.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        d[0] = u.x;
        d[1] = u.y;
      }
    } else {
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(s.plane0) + (long long)ty * w + tx;
#pragma unroll
      for (int kb = 0; kb < CB; ++kb) {
        const int c = 16 * kb + 2 * q;
        d[2 * kb] = p[c * hw] | ((uint32_t)p[(c + 1) * hw] << 16);
        d[2 * kb + 1] = p[(c + 8) * hw] | ((uint32_t)p[(c + 9) * hw] << 16);
      }
    }
#pragma unroll
    for (int kb = 0; kb < CB; ++kb) {
      v[kb][0] += wt[t] * bf16_lo(d[2 * kb]);
      v[kb][1] += wt[t] * bf16_hi(d[2 * kb]);
      v[kb][2] += wt[t] * bf16_lo(d[2 * kb + 1]);
      v[kb][3] += wt[t] * bf16_hi(d[2 * kb + 1]);
    }
  }
}

// the A fragment registers (bf16, rounded) of one sampler for the warp's
// m16 tile: a[kb][hf], rows g / g + 8 = pixels g / 8 + g of the pass
template <int CB>
__device__ __forceinline__ void sample_frags(uint32_t (&a)[CB][4], const Source& s,
                                             const float* fy, const float* fx, const bool* live,
                                             int h, int w, int q, int g) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v[CB][4];
    if (live[hf]) {
      sample<CB>(v, s, fy[hf], fx[hf], h, w, q, g);
    } else {
#pragma unroll
      for (int kb = 0; kb < CB; ++kb)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[kb][j] = 0.f;
    }
#pragma unroll
    for (int kb = 0; kb < CB; ++kb) {
      a[kb][hf] = pack_bf16x2(v[kb][0], v[kb][1]);
      a[kb][2 + hf] = pack_bf16x2(v[kb][2], v[kb][3]);
    }
  }
}

__device__ __forceinline__ uint2 bfrag(const uint8_t* smem, int block, int lane) {
  return *reinterpret_cast<const uint2*>(smem + block * 256 + lane * 8);
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// one warp pass: 16 HR pixels X0 .. X0 + 15 of row Y, all products, output
// through the warp's shared-memory tile to device memory. The four warps
// of a warpgroup pass together: the fusion product is one wgmma m64nCk16
// per k-block over their 64 pixels (A, sa or fea, from each warp's
// registers; B, Wfus, from shared memory), issued by all four, so every
// warp runs every pass (pixels off the image are dead lanes).
template <int CB>
__device__ __forceinline__ void stau_pass(uint8_t* smem, const Source& sf, const Source& ss,
                                          const float* __restrict__ pix, bf16* __restrict__ outb,
                                          int NE, int h, int w, int H, int W, int Y, int X0,
                                          bool vec_out) {
  using Cfg = StauCfg<CB>;
  constexpr int C = Cfg::C, NT = Cfg::NT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, q = lane % 4;
  const long long HW = (long long)H * W, pbase = (long long)Y * W;
  // the lane's two pixels (the fragment rows g and g + 8)
  const int px[2] = {X0 + g, X0 + 8 + g};
  const bool live[2] = {Y < H && px[0] < W, Y < H && px[1] < W};
  const uint32_t wf = smem_u32(smem + Cfg::WF_OFF * 256);
  float fy[2], fx[2];
  float out[4 * NT];  // the wgmma accumulators: n-tile nt at 4 nt
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) out[i] = 0.f;
  // 1. sa, and out = sa * Wfus[:, :C]^T (asynchronous)
  uint32_t sa[CB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fy[i] = live[i] ? pix[2 * HW + pbase + px[i]] : 0.f;
    fx[i] = live[i] ? pix[3 * HW + pbase + px[i]] : 0.f;
  }
  sample_frags<CB>(sa, ss, fy, fx, live, h, w, q, g);
  __syncwarp();  // wgmma is warp-aligned
  fence_regs(out);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < CB; ++kb)
    wgmma_m64nNk16_bf16_rs<C>(out, sa[kb],
                              make_desc(wf + kb * Cfg::WF_KBLOCK, 128, 256, kInterleave));
  wgmma_commit();
  // 2. f0 and the compress Z = F0 Wc^T: n-tile e is expert e
  uint32_t f0[CB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fy[i] = live[i] ? pix[pbase + px[i]] : 0.f;
    fx[i] = live[i] ? pix[HW + pbase + px[i]] : 0.f;
  }
  sample_frags<CB>(f0, sf, fy, fx, live, h, w, q, g);
  uint32_t stk[2][4];
  {
    float z[NE_PAD][4];
#pragma unroll
    for (int e = 0; e < NE_PAD; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[e][j] = 0.f;
#pragma unroll
    for (int kb = 0; kb < CB; ++kb)
#pragma unroll
      for (int e = 0; e < NE_PAD; ++e) {
        const uint2 b = bfrag(smem, Cfg::WC_OFF + kb * NE_PAD + e, lane);
        mma_m16n8k16_bf16(z[e], f0[kb], b.x, b.y);
      }
    // 3. routing on the fragments: fc = sum_e r_e z_e; stk_e = bf16(r_e fc),
    //    A fragments of the expand (k-block k: experts 2k, 2k + 1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float r[NE_PAD];
#pragma unroll
      for (int e = 0; e < NE_PAD; ++e)
        r[e] = live[hf] && e < NE ? pix[(4 + e) * HW + pbase + px[hf]] : 0.f;
      float fc0 = 0.f, fc1 = 0.f;
#pragma unroll
      for (int e = 0; e < NE_PAD; ++e) {
        fc0 = fmaf(r[e], z[e][2 * hf], fc0);
        fc1 = fmaf(r[e], z[e][2 * hf + 1], fc1);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        stk[k][hf] = pack_bf16x2(r[2 * k] * fc0, r[2 * k] * fc1);
        stk[k][2 + hf] = pack_bf16x2(r[2 * k + 1] * fc0, r[2 * k + 1] * fc1);
      }
    }
  }
  wgmma_wait<0>();  // the sa products: their A registers may go now
  fence_u32(sa);
  // 4. fea = bf16(f0 + STK We^T), per 16 channels kb the expand n-tiles
  //    2kb, 2kb + 1, as the A fragment of fusion k-block CB + kb
  uint32_t fea[CB][4];
#pragma unroll
  for (int kb = 0; kb < CB; ++kb) {
    float e[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint2 b = bfrag(smem, Cfg::WE_OFF + k * NT + 2 * kb + j, lane);
        mma_m16n8k16_bf16(e[j], stk[k], b.x, b.y);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t f = f0[kb][2 * j + hf];
        fea[kb][2 * j + hf] =
            pack_bf16x2(e[j][2 * hf] + bf16_lo(f), e[j][2 * hf + 1] + bf16_hi(f));
      }
  }
  __syncwarp();
  fence_regs(out);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < CB; ++kb)
    wgmma_m64nNk16_bf16_rs<C>(out, fea[kb],
                              make_desc(wf + (CB + kb) * Cfg::WF_KBLOCK, 128, 256, kInterleave));
  wgmma_commit();
  wgmma_wait<0>();
  fence_u32(fea);
  fence_regs(out);
  // 5. + bias, bf16, through the warp's [C][OUT_PITCH] tile, 16-byte stores
  const float* bias = reinterpret_cast<const float*>(smem + Cfg::OFF_BIAS);
  bf16* tile = reinterpret_cast<bf16*>(smem + Cfg::OFF_OUT) + warp * C * OUT_PITCH;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = 8 * nt + 2 * q + (j & 1), p = 8 * (j >> 1) + g;
      tile[co * OUT_PITCH + p] = __float2bfloat16_rn(out[4 * nt + j] + bias[co]);
    }
  __syncwarp();
  if (Y < H) {
    for (int i = lane; i < C * (TC_PASS / 8); i += 32) {
      const int co = i / (TC_PASS / 8), k = i % (TC_PASS / 8);
      const int x = X0 + 8 * k;
      const bf16* src = tile + co * OUT_PITCH + 8 * k;
      bf16* dst = outb + co * HW + pbase + x;
      if (vec_out && x + 8 <= W) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8 && x + j < W; ++j) dst[j] = src[j];
      }
    }
  }
  __syncwarp();
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile t is spatial
// tile t / B (row group, column segment) of sample t % B; warp w takes
// row w / 2, columns 32 (w % 2) .. + 31 of the tile
template <int CB>
__global__ void __launch_bounds__(TC_THREADS, 1)
stau_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sta,
                const float* __restrict__ pix, const int4* __restrict__ plan,
                const bf16* __restrict__ wpk, const float* __restrict__ bias,
                bf16* __restrict__ out, int B, int NE, int h, int w, int H, int W, int ncs,
                int ntiles, int vec_in, int vec_out) {
  using Cfg = StauCfg<CB>;
  constexpr int C = Cfg::C;
  extern __shared__ __align__(128) uint8_t stau_smem[];
  uint8_t* smem = stau_smem;
  uint8_t* stage = smem + Cfg::OFF_STAGE;
  bf16* raw = reinterpret_cast<bf16*>(smem + Cfg::OFF_RAW);
  for (int i = threadIdx.x; i < Cfg::W_BLOCKS * 16; i += TC_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(wpk)[i];
  for (int i = threadIdx.x; i < C; i += TC_THREADS)
    reinterpret_cast<float*>(smem + Cfg::OFF_BIAS)[i] = bias[i];
  const long long chw = (long long)C * h * w;
  const int warp = threadIdx.x / 32;

  // the boxes of tile t into the landing buffer (sampler f, then s)
  auto issue = [&](int t, const Plan& p) {
    if (p.nrf == 0) return;
    const long long off = (t % B) * chw;
    stage_issue<CB>(raw, x + off, h, w, p.yf, p.xf, p.nrf, p.ncf, vec_in);
    stage_issue<CB>(raw + C * raw_stride(p.nrf * p.ncf), sta + off, h, w, p.ys, p.xs, p.nrs,
                    p.ncs, vec_in);
  };
  auto transpose = [&](const Plan& p) {
    if (p.nrf == 0) return;
    stage_transpose<CB>(stage, raw, p.nrf * p.ncf);
    stage_transpose<CB>(stage + p.nrf * p.ncf * Cfg::SLOT, raw + C * raw_stride(p.nrf * p.ncf),
                        p.nrs * p.ncs);
  };

  int t = blockIdx.x;
  Plan p = load_plan(plan, t / B);
  issue(t, p);
  cp_async_wait_all();
  __syncthreads();
  transpose(p);
  __syncthreads();
  while (t < ntiles) {
    const int tn = t + gridDim.x;
    Plan pn{};
    if (tn < ntiles) {
      pn = load_plan(plan, tn / B);
      issue(tn, pn);  // lands while this tile computes
    }
    const int b = t % B, st = t / B;
    const int Y = (st / ncs) * TC_ROWS + warp / 2;
    const int X0 = (st % ncs) * TC_COLS + (warp % 2) * (TC_COLS / 2);
    const long long off = b * chw;
    const bool staged = p.nrf != 0;
    const Source sf{staged ? stage : nullptr, x + off, p.yf, p.xf, p.ncf};
    const Source ss{staged ? stage + p.nrf * p.ncf * Cfg::SLOT : nullptr, sta + off, p.ys, p.xs,
                    p.ncs};
    for (int X = X0; X < X0 + TC_COLS / 2; X += TC_PASS)
      stau_pass<CB>(smem, sf, ss, pix, out + (long long)b * C * H * W, NE, h, w, H, W, Y, X,
                    vec_out);
    cp_async_wait_all();
    __syncthreads();
    if (tn < ntiles) {
      transpose(pn);
      __syncthreads();
    }
    t = tn;
    p = pn;
  }
}

template <int CB>
int launch_mma(const void* x, const void* sta, const float* pix, const int* plan,
               const void* wpk, const float* bias, void* out, int B, int NE, int h, int w, int H,
               int W, int vec_in, int vec_out, cudaStream_t stream) {
  using Cfg = StauCfg<CB>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stau_mma_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int ncs = (W + TC_COLS - 1) / TC_COLS;
  const int ntiles = B * ncs * ((H + TC_ROWS - 1) / TC_ROWS);
  const int grid = ntiles < sms ? ntiles : sms;
  stau_mma_kernel<CB><<<grid, TC_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sta), pix,
      reinterpret_cast<const int4*>(plan), static_cast<const bf16*>(wpk), bias,
      static_cast<bf16*>(out), B, NE, h, w, H, W, ncs, ntiles, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// f32: x, sta: [B, C, h, w]; pix: [4 + NE, H, W] f32; wc: [NE*C/8, C];
// we: [C, NE*C/8]; wfus: [Cout, 2C]; bias: [Cout] f32; out: [B, Cout, H, W].
extern "C" int savsr_stau_fused(const void* x, const void* sta, const float* pix,
                                const void* wc, const void* we, const void* wfus,
                                const float* bias, void* out, int B, int C, int NE, int Cout,
                                int h, int w, int H, int W, void* stream) {
  if (C < 8 || C > CMAX || C % 8 != 0 || NE < 1 || NE * (C / 8) > KMAX || NE + 4 > NPLANE ||
      Cout < 4 || Cout > OMAX || Cout % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(x, sta, pix, wc, we, wfus, bias, out, B, C, NE, Cout,
                                        h, w, H, W, static_cast<cudaStream_t>(stream)));
}

// bf16: x, sta: [B, C, h, w] (C in 16, 32, 64); pix as above; plan:
// [ceil(H/8) * ceil(W/64), 8] int32 (stau_window_plan, sizes within
// STAGE_CAP); wpk: the packed B fragments (pack_stau_weights); bias: [C]
// f32; out: [B, C, H, W]. vec_in: w % 8 == 0 and x, sta 16-byte aligned;
// vec_out: W % 8 == 0 and out 16-byte aligned.
extern "C" int savsr_stau_mma(const void* x, const void* sta, const float* pix, const int* plan,
                              const void* wpk, const float* bias, void* out, int B, int C,
                              int NE, int h, int w, int H, int W, int vec_in, int vec_out,
                              void* stream) {
  if ((C != 16 && C != 32 && C != 64) || NE < 1 || NE > NE_PAD || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_mma<1>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    case 32: return launch_mma<2>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    default: return launch_mma<4>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
  }
}
