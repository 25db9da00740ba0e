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
// with the TPU kernel's rounding points: the hat x-weights of both samples,
// f0, sa, r_n*fc and fea are rounded to the I/O type before the next product
// (no-ops in f32); the y-weights stay f32.
//
// The TPU kernel samples with "hat" matrices on the MXU over a band of LR
// rows per group of HR rows (band starts j0/g0 precomputed on the host).
// Here each HR pixel gathers its 4 taps.
//
// Bound on the H100: ~12.9K multiply-adds per HR pixel at C=64 against
// ~(Cout + 8) values moved per HR pixel (the LR inputs are small): ~190
// FLOP per byte in f32, bound by operations at the 67 TFLOP/s CUDA-core
// rate; in bf16, against the 989 TFLOP/s tensor-core rate, bound by bytes
// (the output write). Two kernels, one per type: f32 at any C % 8 == 0 up
// to 64 (Cout % 4 == 0 up to 64) runs stau_f32_kernel, bf16 at C 16, 32 or
// 64 with Cout = C stau_mma_kernel (ops/stau.py; other shapes raise):
//
// * f32 (stau_f32_kernel, CUDA cores, true f32): the work is ~12.9K FMAs per
//   HR pixel at C = 64 (gathers 512, compress 2048, expand 2048, fusion
//   8192), 2.83 ms at 8 x 720x1280 at 67 TFLOP/s, against 0.56 ms for the
//   1.89 GB output: bound by operations. Persistent blocks, one per SM (256
//   threads, up to 255 registers), walk tiles of 2 HR rows x 64 HR columns
//   (tile t: spatial tile t / B of sample t % B). The wrapper plans, once
//   per (shape, scale), the LR box each tile reads (stau_window_plan at the
//   f32 tile, exact boxes, a capacity of 320 slots per channel). While a
//   tile's products run, cp.async brings the next tile's two boxes into the
//   staging buffer with channel quads innermost (4-byte copies: a warp reads
//   4 channel rows of 8 pixels and writes 128 contiguous bytes) and its
//   sampler and routing planes into the other half of a double buffer, so
//   the gathers read shared memory only and a tap of 4 channels is one
//   16-byte load. Per tile: (1) the gathers (a thread per pixel and sampler,
//   all channels) write sa and f0 ([2C][128 px]); (2) the compress Z = Wc F0
//   (a thread's 4 experts x 8 pixels of one output in registers), the
//   routing on them (fc = sum_n r_n z_n, stk_n = r_n fc), stk to shared
//   memory; (3) the fusion out = Wfus_sa sa + Wfus_fea f0 + (Wfus_fea We)
//   stk + bias: the expand folded into the fusion on the host (ops/stau.py
//   pack_stau_weights_f32; f32 has no rounding point between them), so it
//   is one GEMM of 2C + 4 C/8 input rows. Threads 0-127 and 128-255 split
//   its rows: the second half sums the sa rows while the first runs the
//   compress, then the stk rows while the first sums the f0 rows; each
//   half then stores half the outputs from its registers as 16-byte stores
//   along W, adding the other half's sums from shared memory. Each GEMM gives a thread
//   an 8 x 8 register tile (8 rows x pixels 4 pg + j and 64 + 4 pg + j) and
//   per input row loads two 16-byte pieces of weights (one address per
//   quarter warp) and two of pixels (8 pieces, the same in every quarter
//   warp), the next row's before this row's FMAs, unrolled by 8 rows (a
//   full unroll thrashes the instruction cache). What sets the pace: the FMA
//   pipe in the products and the rate of shared-memory load instructions
//   (scripts/smem_probe.py: ~1.4 SM cycles per warp load however the lanes
//   share addresses, 4 when 32 lanes read 32 distinct 16-byte pieces), which
//   is why a tap is one 16-byte load of a channel quad rather than four
//   4-byte loads. The variants (scripts/torch_kernel_variants.py --kernels
//   stau_f32; H100, 8 x 180x320 -> 720x1280, C = 64; ms saved with the part
//   off, of 5.48): the fusion 2.1 (86% of the FMA rate), the compress and
//   folded expand rows 1.3, the box copies 0.35, the tap loads 0.24, the
//   stores 0.08; 4-byte taps from channel rows cost 0.84, products unrolled
//   by 4 rows instead of 8 took ~5% longer, and one half storing all the
//   outputs ~3% longer.
//   Tiles without a box (large offsets, non-finite coordinates) gather from
//   device memory with the same arithmetic. C is padded to 16, 32 or 64, the
//   experts to 4 and the outputs to 64 (zero weights).
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
//
// * fast (stau_mma_kernel<CB, true>, the fast serving tier: f32 weights and
//   carries at matmul_precision default): the TPU kernel's f32 mode at
//   DEFAULT precision, where every product takes its operands rounded to
//   bf16 and sums in f32. The wrapper hands the kernel x and sta rounded to
//   bf16 and the weights packed from their bf16 values, so the samples, the
//   compress, the routing, the expand and the fusion are the bf16 kernel's.
//   Two things differ, as the TPU's f32 mode has them: f0 enters the
//   residual fea = f0 + STK We^T in f32 (it is rounded only where it meets
//   the compress), and the output is f32. The f32 f0 would hold 32 more
//   registers a thread from the sampling to the expand, past the block's
//   128-register budget, so the sampling also writes it, a lane's 2 pixels x
//   16 channels as float4s, into a 4 KB region of its warp (64 KB for 16
//   warps: the bf16 output tile's 48 KB and 16 KB of the staging, whose
//   capacity drops to FAST_STAGE_CAP = 536 slots; a warp's 16-byte writes
//   and reads are 512 contiguous bytes), and the expand reads it back per
//   k-block. The fusion's sa half is issued with the fea half at the end, so
//   that its accumulators are not live through the pass, and the staging
//   transposes read the thread index opaquely (ptxas had kept two of their
//   indices live through the passes): 128 registers, no spills, 2.05-2.08
//   ms at 8 x 180x320 -> 720x1280, C = 64 (2.88 before). What the variants of the earlier design, which sampled f0 a
//   second time per k-block instead, measured (scripts/torch_kernel_variants.py
//   --kernels stau_fast; H100, 8 x 180x320 -> 720x1280, C = 64, ms saved of
//   2.88 with the part off): the second sampling 0.64, the unstaged f32
//   output stores at most 0.26 (a warp's store fills four 32-byte sectors),
//   the wrapper's two rounding passes 0.13 (kept: an f32 landing buffer
//   does not fit beside the staging); ptxas spilled 96 B a thread there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// bilinear sample of one [h, w] plane, zeros outside the image
__device__ __forceinline__ float bilinear(const float* plane, int h, int w, float fy, float fx) {
  const float yf = floorf(fy), xf = floorf(fx);
  const float wy1 = fy - yf, wx1 = fx - xf;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  float v = 0.f;
  // compare in float before converting: coordinates may lie far outside
  const bool ya = yf >= 0.f && yf <= h - 1, yb = yf + 1.f >= 0.f && yf + 1.f <= h - 1;
  const bool xa = xf >= 0.f && xf <= w - 1, xb = xf + 1.f >= 0.f && xf + 1.f <= w - 1;
  const int y = (int)fmaxf(fminf(yf, (float)h), -1.f);
  const int x = (int)fmaxf(fminf(xf, (float)w), -1.f);
  if (ya && xa) v += (wy0 * wx0) * plane[(long long)y * w + x];
  if (ya && xb) v += (wy0 * wx1) * plane[(long long)y * w + x + 1];
  if (yb && xa) v += (wy1 * wx0) * plane[(long long)(y + 1) * w + x];
  if (yb && xb) v += (wy1 * wx1) * plane[(long long)(y + 1) * w + x + 1];
  return v;
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
constexpr int FAST_STAGE_CAP = 536; // the same in the fast mode (ops/stau.py FAST_STAGE_CAP)
constexpr int NE_PAD = 4;           // experts (fewer: zero weights, zero routing); each
                                    // expert's C/8 compress outputs padded to 8
constexpr int OUT_PITCH = TC_PASS + 8;  // bf16 per channel row of a warp's output tile

template <int CB, bool FAST>  // C = 16 * CB channels (CB 1, 2 or 4), Cout = C
struct StauCfg {
  static constexpr int C = 16 * CB;
  static constexpr int CAP = FAST ? FAST_STAGE_CAP : STAGE_CAP;
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
  static constexpr int OFF_RAW = OFF_STAGE + CAP * SLOT;
  static constexpr int OFF_OUT = OFF_RAW + (CAP + 16) * SLOT;  // raw_stride pads
  // bf16: each warp's [C][OUT_PITCH] output tile; FAST: each warp's f32 f0
  // of one pass, [2 pixels][CB k-blocks][32 lanes] float4
  static constexpr int WARP_F0 = 2 * CB * 32 * 16;
  static constexpr int SMEM =
      OFF_OUT + TC_WARPS * (FAST ? WARP_F0 : C * OUT_PITCH * 2);
  static_assert(SMEM <= 232448, "shared memory");
};

// one spatial tile's plan (ops/stau.py stau_window_plan): per sampler the LR
// box's first row and column and its rows and columns; zero sizes: gather
// from device memory
struct Plan {
  int yf, xf, ys, xs, nrf, ncf, nrs, ncs;
};

// (``cap``: the kernel's staging slots; a tile whose boxes exceed it, from a
// plan made for a larger capacity, gathers from device memory)
__device__ __forceinline__ Plan load_plan(const int4* plan, int st, int cap = 1 << 30) {
  const int4 a = plan[2 * st], b = plan[2 * st + 1];
  const bool fits = b.x * b.y + b.z * b.w <= cap;
  return Plan{a.x, a.y, a.z, a.w, fits ? b.x : 0, b.y, b.z, b.w};
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
__device__ __forceinline__ void stage_transpose(uint8_t* stage, const bf16* raw, int npx,
                                                int tid) {
  constexpr int C = 16 * CB, PAIRS = C / 2;
  const int n = PAIRS * (npx / 8), S = raw_stride(npx);
  for (int i = tid; i < n; i += TC_THREADS) {
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

// threadIdx.x through an opaque read: what is computed from it is not hoisted
// out of the loop around the call
__device__ __forceinline__ int volatile_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// where a sampler's taps come from: the staged box (slots of 2C bytes, box
// origin y0/x0, nc columns) or, for a tile without one, device memory
struct Source {
  const uint8_t* stage;  // null: device memory
  const bf16* plane0;    // this sample's channel 0 in device memory
  int y0, x0, nc;
};

// the 4 taps of a bilinear sample at (fy, fx): top-left tap (y, x), which
// taps lie in the image (taps outside are skipped: their weight is never
// multiplied in) and their weights wy * wx, the x-weights rounded to bf16 as
// the TPU kernel rounds its hat matrix (the y-weights stay f32)
struct Taps {
  int y, x;
  bool ok[4];
  float wt[4];
};

__device__ __forceinline__ Taps taps_of(float fy, float fx, int h, int w) {
  const float yf = floorf(fy), xf = floorf(fx);
  const float wy1 = fy - yf, wx1 = fx - xf;
  const float wy0 = 1.f - wy1;
  const float wx0r = __bfloat162float(__float2bfloat16_rn(1.f - wx1));
  const float wx1r = __bfloat162float(__float2bfloat16_rn(wx1));
  // compare in float before converting: coordinates may lie far outside
  const bool ya = yf >= 0.f && yf <= h - 1, yb = yf + 1.f >= 0.f && yf + 1.f <= h - 1;
  const bool xa = xf >= 0.f && xf <= w - 1, xb = xf + 1.f >= 0.f && xf + 1.f <= w - 1;
  return Taps{(int)fmaxf(fminf(yf, (float)h), -1.f),
              (int)fmaxf(fminf(xf, (float)w), -1.f),
              {ya && xa, ya && xb, yb && xa, yb && xb},
              {wy0 * wx0r, wy0 * wx1r, wy1 * wx0r, wy1 * wx1r}};
}

// the bilinear sample of one HR pixel at (fy, fx), as the f32 sums of lane
// q's channels, v[kb] = {16 kb + 2q, +1, 16 kb + 8 + 2q, +1}
template <int CB>
__device__ __forceinline__ void sample(float (&v)[CB][4], const Source& s, float fy, float fx,
                                       int h, int w, int q, int g) {
#pragma unroll
  for (int kb = 0; kb < CB; ++kb)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[kb][j] = 0.f;
  const Taps tp = taps_of(fy, fx, h, w);
  const int y = tp.y, x = tp.x;
  const long long hw = (long long)h * w;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!tp.ok[t]) continue;
    const float wt = tp.wt[t];
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
      v[kb][0] += wt * bf16_lo(d[2 * kb]);
      v[kb][1] += wt * bf16_hi(d[2 * kb]);
      v[kb][2] += wt * bf16_lo(d[2 * kb + 1]);
      v[kb][3] += wt * bf16_hi(d[2 * kb + 1]);
    }
  }
}

// the A fragment registers (bf16, rounded) of one sampler for the warp's
// m16 tile: a[kb][hf], rows g / g + 8 = pixels g / 8 + g of the pass; with
// ``keep``, the f32 sums too, as keep[(hf CB + kb) 32 + lane] (FAST's f0)
template <int CB>
__device__ __forceinline__ void sample_frags(uint32_t (&a)[CB][4], const Source& s,
                                             const float* fy, const float* fx, const bool* live,
                                             int h, int w, int q, int g,
                                             float4* keep = nullptr) {
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
      if (keep)
        keep[(hf * CB + kb) * 32 + (threadIdx.x % 32)] =
            make_float4(v[kb][0], v[kb][1], v[kb][2], v[kb][3]);
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
// warp runs every pass (pixels off the image are dead lanes). FAST: f0 in
// f32 in the residual and an f32 output (``outp`` float; else bf16).
template <int CB, bool FAST>
__device__ __forceinline__ void stau_pass(uint8_t* smem, const Source& sf, const Source& ss,
                                          const float* __restrict__ pix, void* __restrict__ outp,
                                          int NE, int h, int w, int H, int W, int Y, int X0,
                                          bool vec_out) {
  using Cfg = StauCfg<CB, FAST>;
  constexpr int C = Cfg::C, NT = Cfg::NT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, q = lane % 4;
  // FAST: this warp's f32 f0 of the pass, kept for the residual
  float4* f0_keep = reinterpret_cast<float4*>(smem + Cfg::OFF_OUT + warp * Cfg::WARP_F0);
  const long long HW = (long long)H * W, pbase = (long long)Y * W;
  // the lane's two pixels (the fragment rows g and g + 8)
  const int px[2] = {X0 + g, X0 + 8 + g};
  const bool live[2] = {Y < H && px[0] < W, Y < H && px[1] < W};
  const uint32_t wf = smem_u32(smem + Cfg::WF_OFF * 256);
  float fy[2], fx[2];
  float out[4 * NT];  // the wgmma accumulators: n-tile nt at 4 nt
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) out[i] = 0.f;
  // 1. sa, and out = sa * Wfus[:, :C]^T (asynchronous; FAST: with the fea
  //    half at the end, so that the accumulators are not live from here:
  //    ptxas then keeps the pass in the 128-register budget, no spills)
  uint32_t sa[CB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fy[i] = live[i] ? pix[2 * HW + pbase + px[i]] : 0.f;
    fx[i] = live[i] ? pix[3 * HW + pbase + px[i]] : 0.f;
  }
  sample_frags<CB>(sa, ss, fy, fx, live, h, w, q, g);
  if constexpr (!FAST) {
    __syncwarp();  // wgmma is warp-aligned
    fence_regs(out);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < CB; ++kb)
      wgmma_m64nNk16_bf16_rs<C>(out, sa[kb],
                                make_desc(wf + kb * Cfg::WF_KBLOCK, 128, 256, kInterleave));
    wgmma_commit();
  }
  // 2. f0 and the compress Z = F0 Wc^T: n-tile e is expert e
  uint32_t f0[CB][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fy[i] = live[i] ? pix[pbase + px[i]] : 0.f;
    fx[i] = live[i] ? pix[HW + pbase + px[i]] : 0.f;
  }
  sample_frags<CB>(f0, sf, fy, fx, live, h, w, q, g, FAST ? f0_keep : nullptr);
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
  if constexpr (!FAST) {
    wgmma_wait<0>();  // the sa products: their A registers may go now
    fence_u32(sa);
  }
  // 4. fea = bf16(f0 + STK We^T), per 16 channels kb the expand n-tiles
  //    2kb, 2kb + 1, as the A fragment of fusion k-block CB + kb; FAST: f0
  //    in f32, as the sampling kept it
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
    if constexpr (FAST) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float4 k4 = f0_keep[(hf * CB + kb) * 32 + lane];
        const float f[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int j = 0; j < 2; ++j)
          fea[kb][2 * j + hf] =
              pack_bf16x2(e[j][2 * hf] + f[2 * j], e[j][2 * hf + 1] + f[2 * j + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t f = f0[kb][2 * j + hf];
          fea[kb][2 * j + hf] =
              pack_bf16x2(e[j][2 * hf] + bf16_lo(f), e[j][2 * hf + 1] + bf16_hi(f));
        }
    }
  }
  __syncwarp();
  fence_regs(out);
  wgmma_fence();
  if constexpr (FAST) {
#pragma unroll
    for (int kb = 0; kb < CB; ++kb)
      wgmma_m64nNk16_bf16_rs<C>(out, sa[kb],
                                make_desc(wf + kb * Cfg::WF_KBLOCK, 128, 256, kInterleave));
  }
#pragma unroll
  for (int kb = 0; kb < CB; ++kb)
    wgmma_m64nNk16_bf16_rs<C>(out, fea[kb],
                              make_desc(wf + (CB + kb) * Cfg::WF_KBLOCK, 128, 256, kInterleave));
  wgmma_commit();
  wgmma_wait<0>();
  fence_u32(fea);
  if constexpr (FAST) fence_u32(sa);
  fence_regs(out);
  // 5. + bias; FAST: f32, straight from the accumulators (a store
  //    instruction writes 8 pixels of 4 channels, four whole 32-byte
  //    sectors; staging them in the warp's f0 region for 16-byte stores ran
  //    0.15 ms slower); bf16 through the warp's [C][OUT_PITCH] tile, 16-byte
  //    stores
  const float* bias = reinterpret_cast<const float*>(smem + Cfg::OFF_BIAS);
  if constexpr (FAST) {
    float* outf = static_cast<float*>(outp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = 8 * nt + 2 * q + (j & 1), x = X0 + 8 * (j >> 1) + g;
        if (Y < H && x < W) outf[co * HW + pbase + x] = out[4 * nt + j] + bias[co];
      }
    return;
  }
  bf16* outb = static_cast<bf16*>(outp);
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
template <int CB, bool FAST>
__global__ void __launch_bounds__(TC_THREADS, 1)
stau_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sta,
                const float* __restrict__ pix, const int4* __restrict__ plan,
                const bf16* __restrict__ wpk, const float* __restrict__ bias,
                void* __restrict__ out, int B, int NE, int h, int w, int H, int W, int ncs,
                int ntiles, int vec_in, int vec_out) {
  using Cfg = StauCfg<CB, FAST>;
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
    // FAST: the thread index read here, so that ptxas cannot keep the
    // thread's transpose rows (invariant over the tiles) live through the
    // passes, where they were the two values it spilled
    int tid = threadIdx.x;
    if constexpr (FAST) tid = volatile_tid();
    stage_transpose<CB>(stage, raw, p.nrf * p.ncf, tid);
    stage_transpose<CB>(stage + p.nrf * p.ncf * Cfg::SLOT, raw + C * raw_stride(p.nrf * p.ncf),
                        p.nrs * p.ncs, tid);
  };

  int t = blockIdx.x;
  Plan p = load_plan(plan, t / B, Cfg::CAP);
  issue(t, p);
  cp_async_wait_all();
  __syncthreads();
  transpose(p);
  __syncthreads();
  while (t < ntiles) {
    const int tn = t + gridDim.x;
    Plan pn{};
    if (tn < ntiles) {
      pn = load_plan(plan, tn / B, Cfg::CAP);
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
    const long long ob = (long long)b * C * H * W;
    void* outs = FAST ? static_cast<void*>(static_cast<float*>(out) + ob)
                      : static_cast<void*>(static_cast<bf16*>(out) + ob);
    for (int X = X0; X < X0 + TC_COLS / 2; X += TC_PASS)
      stau_pass<CB, FAST>(smem, sf, ss, pix, outs, NE, h, w, H, W, Y, X, vec_out);
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

template <int CB, bool FAST>
int launch_mma(const void* x, const void* sta, const float* pix, const int* plan,
               const void* wpk, const float* bias, void* out, int B, int NE, int h, int w, int H,
               int W, int vec_in, int vec_out, cudaStream_t stream) {
  using Cfg = StauCfg<CB, FAST>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stau_mma_kernel<CB, FAST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int ncs = (W + TC_COLS - 1) / TC_COLS;
  const int ntiles = B * ncs * ((H + TC_ROWS - 1) / TC_ROWS);
  const int grid = ntiles < sms ? ntiles : sms;
  stau_mma_kernel<CB, FAST><<<grid, TC_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sta), pix,
      reinterpret_cast<const int4*>(plan), static_cast<const bf16*>(wpk), bias, out, B, NE, h, w,
      H, W, ncs, ntiles, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: staged LR windows, register-tiled products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FS_ROWS = 2;                   // HR rows per tile (ops/stau.py F32_PLAN_ROWS)
constexpr int FS_COLS = 64;                  // HR columns per tile (F32_PLAN_COLS)
constexpr int FS_NP = FS_ROWS * FS_COLS;     // 128 pixels
constexpr int FS_CAP = 320;                  // staged LR slots per channel, both boxes
                                             // together (F32_STAGE_CAP)
constexpr int FS_THREADS = 256;              // two halves of 4 warps
constexpr int FS_OMAX = 64;                  // output channels (weights padded to 64)
constexpr int FS_PLANES = 4 + NE_PAD;        // fy_f, fx_f, fy_s, fx_s, r_0..r_3
static_assert(FS_NP == 128 && FS_COLS == 64, "thread layouts: 128 pixels, 64 a row");

template <int CP>  // feature channels padded to 16, 32 or 64
struct StauF32Cfg {
  static constexpr int E = CP / 8;                 // compress outputs per expert
  static constexpr int K = NE_PAD * E;             // stacked expert rows n E + o
  // packed weights: compress [CP k][E o][4 n]; fusion [2CP + K][64]: the sa
  // rows, the f0 rows, then the expand folded into the fea rows (Wfus_fea We)
  static constexpr int WF_OFF = CP * E * NE_PAD;
  static constexpr int W_FLOATS = WF_OFF + (2 * CP + K) * FS_OMAX;
  static constexpr int OFF_BIAS = W_FLOATS;
  static constexpr int OFF_ACT = OFF_BIAS + FS_OMAX;         // [2CP][128]: sa, then f0 -> fea
  static constexpr int OFF_STK = OFF_ACT + 2 * CP * FS_NP;   // [K][128]
  static constexpr int OFF_PIX = OFF_STK + K * FS_NP;        // [2][8 planes][128], by tile parity
  static constexpr int OFF_STAGE = OFF_PIX + 2 * FS_PLANES * FS_NP;  // [CP][FS_CAP]
  // the sums the halves exchange [64][128]: the sa rows of act when they
  // are 64, else a region of their own
  static constexpr int OFF_PART = CP >= FS_OMAX ? OFF_ACT : OFF_STAGE + CP * FS_CAP;
  static constexpr int SMEM = (CP >= FS_OMAX ? OFF_STAGE + CP * FS_CAP
                                             : OFF_PART + FS_OMAX * FS_NP) * 4;
  static_assert(W_FLOATS % 4 == 0 && OFF_STAGE % 4 == 0 && SMEM <= 232448, "shared memory");
};

// one box of `src` (one sample, [C, h, w]) into the staging buffer, slot
// `base` on: channel c of box pixel pos at ((c / 4) FS_CAP + base + pos) 4
// + c % 4, so a bilinear tap of 4 channels is one 16-byte load. 4-byte
// cp.async, columns past w zero-filled; warp v takes chunks of 8 box pixels
// (chunks v, v + 8, ...), lane l pixel l / 4 of the chunk and channel l % 4
// of each quad, so a warp's copies read 4 channel rows of 8 pixels and
// write 128 contiguous bytes
__device__ __forceinline__ void stau_f32_stage(float* stage, int base, const float* src, int h,
                                               int w, int y0, int x0, int nr, int nc, int C) {
  const long long hw = (long long)h * w;
  const int lane = threadIdx.x % 32, npos = nr * nc;
  for (int pos = 8 * (threadIdx.x / 32) + lane / 4; pos - lane / 4 < npos; pos += FS_THREADS / 4) {
    if (pos >= npos) continue;
    const int xs = x0 + pos % nc;
    const bool ok = xs < w;
    const float* g = src + (lane % 4) * hw + (long long)(y0 + pos / nc) * w + (ok ? xs : 0);
    float* d = stage + (base + pos) * 4 + lane % 4;
    for (int c = 0; c < C; c += 4, g += 4 * hw, d += 4 * FS_CAP) cp_async4_zfill(d, g, ok);
  }
}

// a tile's sampler planes (and routing planes, zero past NE) into
// [8][128] by 4-byte cp.async; pixels off the image are zero-filled
__device__ __forceinline__ void stau_f32_stage_pix(float* dst, const float* pix, int NE, int H,
                                                   int W, int Y0, int X0) {
  const long long HW = (long long)H * W;
  for (int e = threadIdx.x; e < FS_PLANES * FS_NP; e += FS_THREADS) {
    const int q = e / FS_NP, r = (e / FS_COLS) % FS_ROWS, x = X0 + e % FS_COLS;
    const bool ok = q < 4 + NE && Y0 + r < H && x < W;
    cp_async4_zfill(dst + e, pix + (ok ? q * HW + (long long)(Y0 + r) * W + x : 0), ok);
  }
}

// the bilinear taps of one HR pixel as (weight, offset into the staged box):
// taps outside the image, and every tap of a pixel off the image, get
// weight 0 at offset 0 (a slot of the box), so the channel loop has no
// branch; in-image taps lie in the box by the plan's construction
__device__ __forceinline__ void stau_f32_taps(float fy, float fx, int h, int w, bool live,
                                              int y0, int x0, int nc, float (&wt)[4],
                                              int (&off)[4]) {
  const float yf = floorf(fy), xf = floorf(fx);
  const float wy1 = fy - yf, wx1 = fx - xf;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  const bool ya = yf >= 0.f && yf <= h - 1, yb = yf + 1.f >= 0.f && yf + 1.f <= h - 1;
  const bool xa = xf >= 0.f && xf <= w - 1, xb = xf + 1.f >= 0.f && xf + 1.f <= w - 1;
  const int y = (int)fmaxf(fminf(yf, (float)h), -1.f) - y0;
  const int x = (int)fmaxf(fminf(xf, (float)w), -1.f) - x0;
  const bool ok[4] = {live && ya && xa, live && ya && xb, live && yb && xa, live && yb && xb};
  const float ww[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wt[t] = ok[t] ? ww[t] : 0.f;
    off[t] = ok[t] ? (y + t / 2) * nc + x + t % 2 : 0;
  }
}

// acc[M][8] += w (x) a over rows k = 0 .. N - 1: w, M weights at wp + k ws
// (M / 4 16-byte loads), a, 8 pixels as two 16-byte loads at ap + k as and
// ap + k as + 64; the next row's operands are loaded before this row's FMAs.
// Unrolled by 8 rows (4 is 5% slower; a full unroll thrashes the
// instruction cache: 2.6x slower)
template <int N, int M>
__device__ __forceinline__ void gemm_rows(float (&acc)[M][8], const float* wp, int ws,
                                          const float* ap, int as) {
  float4 w[M / 4], a[2];
#pragma unroll
  for (int u = 0; u < M / 4; ++u) w[u] = *reinterpret_cast<const float4*>(wp + 4 * u);
  a[0] = *reinterpret_cast<const float4*>(ap);
  a[1] = *reinterpret_cast<const float4*>(ap + 64);
#pragma unroll 8
  for (int k = 0; k < N; ++k) {
    float4 wn[M / 4], an[2];
#pragma unroll
    for (int u = 0; u < M / 4; ++u) wn[u] = w[u];
    an[0] = a[0], an[1] = a[1];
    if (k + 1 < N) {
#pragma unroll
      for (int u = 0; u < M / 4; ++u)
        wn[u] = *reinterpret_cast<const float4*>(wp + (k + 1) * ws + 4 * u);
      an[0] = *reinterpret_cast<const float4*>(ap + (k + 1) * as);
      an[1] = *reinterpret_cast<const float4*>(ap + (k + 1) * as + 64);
    }
    float wv[M];
#pragma unroll
    for (int u = 0; u < M / 4; ++u)
      wv[4 * u] = w[u].x, wv[4 * u + 1] = w[u].y, wv[4 * u + 2] = w[u].z, wv[4 * u + 3] = w[u].w;
    const float av[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
#pragma unroll
    for (int u = 0; u < M / 4; ++u) w[u] = wn[u];
    a[0] = an[0], a[1] = an[1];
  }
}

template <int M>
__device__ __forceinline__ void zero(float (&acc)[M][8]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// rows R .. R + 3 of a thread's 8 x 8 fusion tile into part (rows 8 og +
// R + i, pixels 4 pg + j and 64 + 4 pg + j), for the other half to add
template <int R>
__device__ __forceinline__ void put_rows(float* part, const float (&acc)[8][8], int og, int pg) {
#pragma unroll
  for (int i = R; i < R + 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(part + (8 * og + i) * FS_NP + 64 * hh + 4 * pg) =
          make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
}

// where a half stores its rows of the fusion output
struct FusionOut {
  float* out;           // this sample's [Cout, H, W]
  const float* part;    // the other half's sums
  const float* bias;
  int Cout, H, W, Y0, X, og, pg, vec_out;
};

// out rows R .. R + 3 of the thread's tile: the other half's sums (part) +
// this half's (acc) + bias, as 16-byte stores along W where W % 4 == 0
template <int R>
__device__ __forceinline__ void store_rows(const FusionOut& f, const float (&acc)[8][8]) {
  const long long HW = (long long)f.H * f.W;
#pragma unroll
  for (int i = R; i < R + 4; ++i) {
    const int o = 8 * f.og + i;
    if (o >= f.Cout) continue;
    const float bv = f.bias[o];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int Y = f.Y0 + hh;
      if (Y >= f.H || f.X >= f.W) continue;
      const float4 th = *reinterpret_cast<const float4*>(f.part + o * FS_NP + 64 * hh + 4 * f.pg);
      float* dst = f.out + o * HW + (long long)Y * f.W + f.X;
      const float v[4] = {th.x + acc[i][4 * hh] + bv, th.y + acc[i][4 * hh + 1] + bv,
                          th.z + acc[i][4 * hh + 2] + bv, th.w + acc[i][4 * hh + 3] + bv};
      if (f.vec_out && f.X + 4 <= f.W) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && f.X + j < f.W; ++j) dst[j] = v[j];
      }
    }
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile t is spatial
// tile t / B (HR rows 2 (t / B / ncs) and + 1, 64-column segment
// t / B % ncs) of sample t % B. Threads 0-127 (half 0) and 128-255 (half 1)
// split the fusion's input rows: half 1 sums the sa rows while half 0 runs
// the compress, then the folded expand rows on stk while half 0 sums the f0
// rows; each half stores half the outputs, adding the other's sums from
// shared memory.
template <int CP>
__global__ void __launch_bounds__(FS_THREADS, 1)
stau_f32_kernel(const float* __restrict__ x, const float* __restrict__ sta,
                const float* __restrict__ pix, const int4* __restrict__ plan,
                const float* __restrict__ wpk, const float* __restrict__ bias,
                float* __restrict__ out, int B, int C, int NE, int Cout, int h, int w, int H,
                int W, int ncs, int ntiles, int vec_out) {
  using Cfg = StauF32Cfg<CP>;
  constexpr int E = Cfg::E, K = Cfg::K, NP = FS_NP;
  extern __shared__ __align__(16) float fsm[];
  float* s_bias = fsm + Cfg::OFF_BIAS;
  float* act = fsm + Cfg::OFF_ACT;
  float* stk = fsm + Cfg::OFF_STK;
  float* stage = fsm + Cfg::OFF_STAGE;
  float* part = fsm + Cfg::OFF_PART;
  const int tid = threadIdx.x, lane = tid % 32;
  // the half through a shuffle, so that ptxas sees it uniform
  const int half = __shfl_sync(0xffffffffu, tid / 128, 0), lt = tid % 128, warp = lt / 32;
  for (int i = tid; i < Cfg::W_FLOATS / 4; i += FS_THREADS) cp_async16(fsm + 4 * i, wpk + 4 * i);
  for (int i = tid; i < FS_OMAX; i += FS_THREADS) s_bias[i] = i < Cout ? bias[i] : 0.f;
  // staged channels past C: no box copy writes them, so zero them once
  for (int i = tid; i < (CP - C) * FS_CAP; i += FS_THREADS) stage[C * FS_CAP + i] = 0.f;
  const long long chw = (long long)C * h * w, hw = (long long)h * w;

  // the boxes and sampler planes of tile t (sampler planes by tile parity)
  auto issue = [&](int t, const Plan& p, int parity) {
    const int sp = t / B;
    stau_f32_stage_pix(fsm + Cfg::OFF_PIX + parity * FS_PLANES * NP, pix, NE, H, W,
                       (sp / ncs) * FS_ROWS, (sp % ncs) * FS_COLS);
    if (p.nrf == 0) return;
    const long long off = (t % B) * chw;
    stau_f32_stage(stage, 0, x + off, h, w, p.yf, p.xf, p.nrf, p.ncf, C);
    stau_f32_stage(stage, p.nrf * p.ncf, sta + off, h, w, p.ys, p.xs, p.nrs, p.ncs, C);
  };

  int t = blockIdx.x, parity = 0;
  Plan p = load_plan(plan, t / B);
  issue(t, p, 0);
  cp_async_wait_all();
  __syncthreads();
  // the 8 x 8 products' layout in a half: warp (2 row groups x 2 pixel
  // groups), lane (4 row groups x 8 pixel groups): rows 8 og .. + 7, pixels
  // 4 pg + j and 64 + 4 pg + j (j < 4); the 8 lanes of a quarter warp read
  // one weight piece and 8 consecutive pixel pieces
  const int og = 4 * (warp % 2) + lane / 8, pg = 8 * (warp / 2) + lane % 8;
  float acc[8][8];
  while (t < ntiles) {
    const int b = t % B, sp = t / B;
    const int Y0 = (sp / ncs) * FS_ROWS, X0 = (sp % ncs) * FS_COLS;
    const float* tp = fsm + Cfg::OFF_PIX + parity * FS_PLANES * NP;  // this tile's planes
    // 1. gathers: half 0 f0 (rows CP.. of act), half 1 sa (rows 0..CP-1);
    //    one pixel a thread
    {
      const int s = half, px = lt;
      const bool live = Y0 + px / FS_COLS < H && X0 + px % FS_COLS < W;
      const float fy = tp[(2 * s) * NP + px], fx = tp[(2 * s + 1) * NP + px];
      float* arow = act + (s == 0 ? CP : 0) * NP + px;
      if (p.nrf != 0) {
        float wt[4];
        int off[4];
        stau_f32_taps(fy, fx, h, w, live, s ? p.ys : p.yf, s ? p.xs : p.xf, s ? p.ncs : p.ncf,
                      wt, off);
        const float* src = stage + 4 * (s ? p.nrf * p.ncf : 0);
        const float* s0 = src + 4 * off[0];
        const float* s1 = src + 4 * off[1];
        const float* s2 = src + 4 * off[2];
        const float* s3 = src + 4 * off[3];
#pragma unroll 4
        for (int c = 0; c < CP; c += 4) {
          const float4 v0 = *reinterpret_cast<const float4*>(s0 + c * FS_CAP);
          const float4 v1 = *reinterpret_cast<const float4*>(s1 + c * FS_CAP);
          const float4 v2 = *reinterpret_cast<const float4*>(s2 + c * FS_CAP);
          const float4 v3 = *reinterpret_cast<const float4*>(s3 + c * FS_CAP);
          const float a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
          const float a2[4] = {v2.x, v2.y, v2.z, v2.w}, a3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = 0.f;
            v = fmaf(wt[0], a0[i], v);
            v = fmaf(wt[1], a1[i], v);
            v = fmaf(wt[2], a2[i], v);
            v = fmaf(wt[3], a3[i], v);
            arow[(c + i) * NP] = v;
          }
        }
      } else {
        const float* plane = (s ? sta : x) + b * chw;
        for (int c = 0; c < CP; ++c)
          arow[c * NP] = live && c < C ? bilinear(plane + c * hw, h, w, fy, fx) : 0.f;
      }
    }
    __syncthreads();
    // the next tile's boxes and planes land under this tile's products
    const int tn = t + gridDim.x;
    Plan pn{};
    if (tn < ntiles) {
      pn = load_plan(plan, tn / B);
      issue(tn, pn, parity ^ 1);
    }
    if (half == 0) {
      // 2. compress and routing: thread (output o, pixels 4 q + j and
      //    64 + 4 q + j) keeps z of the 4 experts, then fc = sum_n r_n z_n
      //    and stk_n = r_n fc
      if (lt < E * 16) {
        const int o = lt % E, q = lt / E;
        float z[NE_PAD][8];
        zero(z);
        gemm_rows<CP>(z, fsm + 4 * o, 4 * E, act + CP * NP + 4 * q, NP);
        float r[NE_PAD][8];
#pragma unroll
        for (int n = 0; n < NE_PAD; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float4 rv = *reinterpret_cast<const float4*>(tp + (4 + n) * NP + 64 * hh + 4 * q);
            r[n][4 * hh] = rv.x, r[n][4 * hh + 1] = rv.y, r[n][4 * hh + 2] = rv.z,
                      r[n][4 * hh + 3] = rv.w;
          }
        float fc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          fc[j] = r[0][j] * z[0][j];
#pragma unroll
          for (int n = 1; n < NE_PAD; ++n) fc[j] = fmaf(r[n][j], z[n][j], fc[j]);
        }
#pragma unroll
        for (int n = 0; n < NE_PAD; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float4*>(stk + (n * E + o) * NP + 64 * hh + 4 * q) =
                make_float4(r[n][4 * hh] * fc[4 * hh], r[n][4 * hh + 1] * fc[4 * hh + 1],
                            r[n][4 * hh + 2] * fc[4 * hh + 2], r[n][4 * hh + 3] * fc[4 * hh + 3]);
      }
    } else {
      // the fusion's sa rows
      zero(acc);
      gemm_rows<CP>(acc, fsm + Cfg::WF_OFF + 8 * og, FS_OMAX, act + 4 * pg, NP);
    }
    __syncthreads();
    // 3. the fusion's f0 rows (half 0), and its folded expand rows on stk
    //    (half 1). Each half then leaves the sums of the outputs the other
    //    stores in part (the sa rows of act at C = 64), at its tile's places:
    //    half 1 those of rows 8 og .. + 3, half 0 those of + 4 .. + 7
    if (half == 0) {
      zero(acc);
      gemm_rows<CP>(acc, fsm + Cfg::WF_OFF + CP * FS_OMAX + 8 * og, FS_OMAX,
                    act + CP * NP + 4 * pg, NP);
    } else {
      gemm_rows<K>(acc, fsm + Cfg::WF_OFF + 2 * CP * FS_OMAX + 8 * og, FS_OMAX, stk + 4 * pg,
                   NP);
    }
    // (row offsets stay compile-time: a runtime index would put acc in
    // local memory)
    if (half == 0)
      put_rows<4>(part, acc, og, pg);
    else
      put_rows<0>(part, acc, og, pg);
    __syncthreads();
    // 4. out = the two halves' sums + bias: half 0 rows 8 og .. + 3, half 1
    //    rows + 4 .. + 7
    const FusionOut fo{out + (long long)b * Cout * H * W, part, s_bias, Cout, H, W, Y0,
                       X0 + 4 * pg, og, pg, vec_out};
    if (half == 0)
      store_rows<0>(fo, acc);
    else
      store_rows<4>(fo, acc);
    cp_async_wait_all();
    __syncthreads();  // the next boxes and planes landed; everyone is done with act
    t = tn;
    p = pn;
    parity ^= 1;
  }
}

template <int CP>
int launch_f32(const void* x, const void* sta, const float* pix, const int* plan,
               const void* wpk, const float* bias, void* out, int B, int C, int NE, int Cout,
               int h, int w, int H, int W, int vec_out, cudaStream_t stream) {
  using Cfg = StauF32Cfg<CP>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stau_f32_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int ncs = (W + FS_COLS - 1) / FS_COLS;
  const int ntiles = B * ncs * ((H + FS_ROWS - 1) / FS_ROWS);
  const int grid = ntiles < sms ? ntiles : sms;
  stau_f32_kernel<CP><<<grid, FS_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(sta), pix,
      reinterpret_cast<const int4*>(plan), static_cast<const float*>(wpk), bias,
      static_cast<float*>(out), B, C, NE, Cout, h, w, H, W, ncs, ntiles, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// f32: x, sta: [B, C, h, w] (C % 8 == 0, C <= 64); pix: [4 + NE, H, W] f32
// (NE <= 4); plan: [ceil(H/2) * ceil(W/64), 8] int32 (stau_window_plan at
// the f32 tile, sizes within FS_CAP); wpk: the packed weights
// (pack_stau_weights_f32); bias: [Cout] f32 (Cout % 4 == 0, <= 64); out:
// [B, Cout, H, W]. vec_out: W % 4 == 0 and out 16-byte aligned.
extern "C" int savsr_stau_f32(const void* x, const void* sta, const float* pix, const int* plan,
                              const void* wpk, const float* bias, void* out, int B, int C,
                              int NE, int Cout, int h, int w, int H, int W, int vec_out,
                              void* stream) {
  if (C < 8 || C > 64 || C % 8 != 0 || NE < 1 || NE > NE_PAD || Cout < 4 || Cout > FS_OMAX ||
      Cout % 4 != 0 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 16)
    return launch_f32<16>(x, sta, pix, plan, wpk, bias, out, B, C, NE, Cout, h, w, H, W, vec_out, s);
  if (C <= 32)
    return launch_f32<32>(x, sta, pix, plan, wpk, bias, out, B, C, NE, Cout, h, w, H, W, vec_out, s);
  return launch_f32<64>(x, sta, pix, plan, wpk, bias, out, B, C, NE, Cout, h, w, H, W, vec_out, s);
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
    case 16: return launch_mma<1, false>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    case 32: return launch_mma<2, false>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    default: return launch_mma<4, false>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
  }
}

// fast (the fast tier): as savsr_stau_mma, with x and sta the f32 inputs
// rounded to bf16, wpk packed from the weights' bf16 values, and out f32
// [B, C, H, W] (vec_out unused).
extern "C" int savsr_stau_fast(const void* x, const void* sta, const float* pix, const int* plan,
                               const void* wpk, const float* bias, void* out, int B, int C,
                               int NE, int h, int w, int H, int W, int vec_in, int vec_out,
                               void* stream) {
  if ((C != 16 && C != 32 && C != 64) || NE < 1 || NE > NE_PAD || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_mma<1, true>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    case 32: return launch_mma<2, true>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
    default: return launch_mma<4, true>(x, sta, pix, plan, wpk, bias, out, B, NE, h, w, H, W, vec_in, vec_out, s);
  }
}
