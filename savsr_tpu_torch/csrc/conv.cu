// Fused KxK convolution (K = 1 or 3, zero padding) with epilogue — kernels 1
// and 2 of the serving path, and in f32 also kernel 6 of the training path.
//
// Replaces savsr_tpu/ops/pallas/chw_conv.py::conv3x3_chw (and the Cin
// chunking of conv3x3_chw_parts) and ::conv1x1_chw. Semantics per output
// (b, co, y, x), accumulated in f32 over the concatenated input channels:
//     v = sum_{ci,dy,dx} W[co, ci, dy, dx] * X[ci, y+dy-P, x+dx-P]
//     v += bias[co]; v += pre_add; v *= out_scale[co]; v = a*v + b*|v|;
//     v += residual;  out = v (rounded to the I/O type)
// with P = K/2. The f32 kernel also takes any padding 0..K-1 (output
// (H+2P-K+1) x (W+2P-K+1)) and a weight read through strides, so the f32
// OSConv forward and its dx call (savsr_tpu/ops/pallas/osconv_kernel.py::
// osconv_pallas_agg: a per-sample weight agg[b, dy, dx, ci, co]; for dx agg
// with its taps flipped and its channel axes swapped) run on it too
// (ops/osconv.py).
//
// Bound on the H100: at the main-path shapes (180x320, Cin 64..320, Cout
// 64/128) a 3x3 conv does 2*9*Cin*Cout FLOPs per pixel against (Cin + Cout)
// values moved per pixel. In f32, held to the 67 TFLOP/s CUDA-core rate
// (the strict tier must not use TF32), every shape is bound by operations:
// 3x3 64->64 at 8x180x320 0.507 ms of FMAs against 0.035 ms of bytes, 1x1
// 192->64 0.169 against 0.141, the OSConv 192->64 at 8x60x60 0.095 against
// 0.007. In bf16, held to the 989 TFLOP/s tensor-core rate, 64->64 sits at
// the ridge (~290 FLOP per byte) and the wider convs are bound by
// operations.
//
// Three kernels: one per type, and one for the fast tier's f32 at one bf16
// pass:
//
// * f32 (conv_f32_kernel, CUDA cores): an implicit GEMM whose aim is to keep
//   the FMA pipe issuing. A block computes 64 output channels x 4 rows x 64
//   columns; a warp 32 of the channels x 4 rows x 16 columns, a lane 8
//   channels x 2 rows x 4 columns of them: per input channel and tap an
//   8 x 8 outer product into 64 f32 accumulators. Per input channel a lane
//   loads its input rows once (a float4, plus a float2 for the 3x3's two
//   extra columns, each shared by the warp's 4 channel groups), then each
//   tap's 8 weights as two float4 (shared by the 8 lanes of a channel
//   group): a 3x3 input channel is 576 FMAs for 26 shared loads, a 1x1 one
//   64 for 4, and rows 72 floats apart keep the loads off each other's
//   banks.
//   Input channels are staged CI at a time (8 for 3x3, 16 for 1x1) through
//   a ring of 3 (4) shared-memory stages filled by cp.async, so the next
//   stages' loads are in flight under this stage's FMAs; one barrier a
//   stage. Rows are copied as they lie in device memory, with zero fill
//   (src-size 0) for the image border, the halo and channels past a part's
//   end, so no padded copy of any input is made: by 16-byte copies where the
//   part's rows are 16-byte aligned (W % 4 == 0: every main-path shape), so
//   a staged row starts at the 16-byte boundary at or left of the tile's
//   first input column (x0 - 4 for padding 1 and 2; the padding is a
//   template parameter, so each lane's loads of its 6 input columns are
//   fixed at compile time), otherwise by 4-byte copies into the same
//   layout, a warp per channel and a lane per column, from offsets and
//   bounds computed once a block.
//   Weights are [tap][Cin][Cout] (ops/conv.py pack_weight_f32 repacks the
//   conv weight; the OSConv's agg is laid out so, and its dx call reads agg
//   flipped and channel-swapped through the strides), staged contiguous in
//   Cout at a 68-float row pitch, so that neither the copies nor the reads
//   conflict. Two blocks run on each SM (<= 128 registers, 98 / 89 KiB of
//   shared memory). Where the output has too few tiles to fill the card
//   (the OSConv at 8 x 60x60: 120 tiles for 264 block slots), the wrapper
//   splits the Cin reduction into chunks (ops/conv.py f32_chunks): each
//   chunk writes f32 partials and conv_f32_reduce_kernel adds them in chunk
//   order and applies the epilogue, so the result is the same from run to
//   run (no atomics).
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
// * split: the split serving tier's conv (conv_precision: split), the
//   pair-carry mode of the TPU kernels (chw_conv.py _body3 / _body1 with
//   in_pair, out_pair, res_pair). A feature travels between convs as a pair
//   of bf16 planes, hi = bf16(y) and lo = bf16(y - hi), whose f32 sum is its
//   value; the weight splits alike into Whi = bf16(W) and Wlo = bf16(W -
//   Whi). The conv contracts [Xhi; Xlo; Xhi] against [Whi, Whi, Wlo] (the
//   lo*lo term, ~2^-16 relative, is dropped): a bf16 contraction over 3 Cin
//   channels, each product exact in the f32 accumulators. It runs
//   conv_split_kernel<K>: the bf16 kernel's tiles with a stage that holds
//   one 16-channel chunk of one pair (both planes' slabs, each shifted
//   once, and the chunk's [Whi | Wlo] weights, ops/conv.py
//   pack_weight_pair) and 3 x K*K wgmmas on it, where the TPU kernel's
//   im2col duplicates hi in VMEM; two consumer warpgroups take whole tiles
//   in turn, so that one's epilogue runs under the other's MMAs. The
//   epilogue: f32 bias, pre_add and out_scale, a residual in f32 or as a
//   pair (hi + lo), and the result written as a pair (hi = bf16(v), lo =
//   bf16(v - hi)) or in f32. Bound: three times the bf16 conv's operations
//   against the pair bytes (2 bf16 in, 2 bf16 out per channel and pixel):
//   the wider main-path convs are bound by operations, 64->64 sits at the
//   ridge (3x3 64->64 at 8x180x320: 0.103 ms of operations, 0.070 ms of
//   bytes, 0.106 with a pair residual).
//
// * fast (conv_fast_kernel): the fast serving tier's conv (f32 weights and
//   carries at matmul_precision: default), the TPU kernels' f32 mode at
//   DEFAULT precision: the parts and the weight rounded to bf16 (round to
//   nearest even), exact products summed in f32, the epilogue and the
//   output in f32. The bf16 kernel's tiles and wgmmas, fed from f32: the
//   producer brings each chunk's f32 slab and halo boxes by TMA into an f32
//   ring, three converter warps round them into the bf16 stage's three
//   shifted B buffers, and the consumers read the f32 residual into
//   registers as a tile starts. Bound: the bf16 conv's operations against
//   the f32 bytes; at 64->64 that is bytes (3x3 at 8x180x320 with an f32
//   residual: 0.106 ms of bytes, 0.034 of operations), so the design keeps
//   device memory streaming: input chunks in flight ahead of the MMAs,
//   residual loads under them, no bf16 copy of any input, an epilogue that
//   is one short run of code.
//
// Layout: NCHW. Input channel parts are read through separate pointers (f32)
// or tensor maps (bf16, split, fast), each with its own batch stride, so a
// channel concat is never copied. Weights come packed by the wrapper
// (ops/conv.py pack_weight_f32 / pack_weight / pack_weight_pair /
// pack_weight_fast), shared or per sample.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAXP = 8;  // channel parts per launch

// ---------------------------------------------------------------------------
// f32: CUDA-core implicit GEMM fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;  // 8 warps: 2 x 32 output channels by 4 x 16 columns
constexpr int F_CO = 64;        // output channels per tile
constexpr int F_ROWS = 4;       // output rows per tile (2 per lane)
constexpr int F_COLS = 64;      // output columns per tile (4 per lane)
constexpr int F_WP = F_CO + 4;  // staged weight row pitch (floats)

template <int KS, int PAD = KS / 2>
struct FCfg {
  static constexpr int KK = KS * KS;
  static constexpr int CI = KS == 3 ? 8 : 16;     // input channels per stage
  static constexpr int STAGES = KS == 3 ? 3 : 4;  // ring depth
  static constexpr int UNROLL = KS == 3 ? 1 : 2;  // input channels per unrolled step
  static constexpr int IR = F_ROWS + KS - 1;      // staged input rows
  // staged columns: from the 16-byte boundary at or left of the tile's
  // first input column x0 - PAD, through its last input column
  static constexpr int LEFT = PAD ? 4 : 0;
  static constexpr int IC = LEFT + F_COLS + KS - 1 - PAD;
  static constexpr int NV = (IC + 3) / 4;         // 16-byte columns of a staged row
  static constexpr int IP = 72;  // staged row pitch: rows 2 apart 16 banks apart
  static constexpr int IN = CI * IR * IP;         // floats of a stage's input
  static constexpr int STAGE = IN + CI * KK * F_WP;
  static constexpr int SMEM = STAGES * STAGE * 4;
  static_assert(CI % (F_THREADS / 32) == 0, "input channels are shared out evenly to the warps");
  static_assert(IP >= 4 * NV, "a staged row holds its 16-byte columns");
};

// One launch: the channel parts, the output geometry, the weight's strides,
// the Cin split and the epilogue. Weight element (b, tap, ci, co) is at
// wt[b * w_b + w_off + tap * w_tap + ci * w_ci + co * w_co].
struct F32Conv {
  const float* part[MAXP];
  long long bstride[MAXP];
  int c[MAXP];
  int vec[MAXP];  // 1: the part's rows may be staged by 16-byte copies
  int n, stages;  // parts; stages in all (each part starts a new one)
  int B, H, W, Ho, Wo, Cout;
  const float* wt;
  long long w_b, w_off, w_tap, w_ci, w_co;
  int w_vec;  // 1: w_co == 1, Cout % 4 == 0 and 16-byte aligned weight rows
  int nchunks, chunk_stages;
  const float* bias;
  const float* pre;
  const float* scale;
  long long s_bstride;
  int lrelu;
  float la, lb;
  const float* res;
  float* out;      // [B, Cout, Ho, Wo]
  float* partial;  // [nchunks][B][Cout][Ho][Wo] when nchunks > 1
  int out_vec;     // 1: Wo % 4 == 0 and out, pre, res 16-byte aligned
};

// Where a stage's channels come from: part p at sample b (x), its channels
// c0.. of c, and the part's first channel in the concatenation (cb).
struct FSrc {
  const float* x;
  int p, c, c0, cb, vec;
};

// Part p from its first channel. Static indices only: a runtime index into
// the kernel's parameter struct would copy the struct to local memory.
__device__ __forceinline__ void f32_part(const F32Conv& a, int p, int b, FSrc& s) {
  int cb = 0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i == p) {
      s.x = a.part[i] + b * a.bstride[i];
      s.c = a.c[i];
      s.vec = a.vec[i];
      s.cb = cb;
    }
    if (i < p) cb += a.c[i];
  }
  s.p = p;
  s.c0 = 0;
}

template <int KS>
__device__ __forceinline__ void f32_next(const F32Conv& a, int b, FSrc& s) {
  s.c0 += FCfg<KS>::CI;
  if (s.c0 >= s.c) f32_part(a, s.p + 1, b, s);
}

// Issue the cp.async copies of one stage (this thread's share) into `st`:
// the input rows [CI][IR][IP] (staged column s holds image column x0 - LEFT
// + s) and the weights [CI][tap][F_WP] of output channels co0..co0+63. Bit r
// of rows_ok: row y0 - PAD + r is in the image; bit m of cols_ok: column
// x0 - LEFT + lane + 32 m is.
template <int KS, int PAD>
__device__ __forceinline__ void f32_stage(const F32Conv& a, const FSrc& s, int b, int co0,
                                          int x0, int y0, unsigned rows_ok, unsigned cols_ok,
                                          float* st) {
  using C = FCfg<KS, PAD>;
  using namespace hopper;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cn = min(C::CI, s.c - s.c0);  // channels of the stage that exist
  const long long HW = (long long)a.H * a.W;
  const float* xs = s.x + s.c0 * HW;
  if (s.vec) {  // W % 4 == 0, aligned part: a float4 is all in or all out
    constexpr int NV = C::NV, N = C::CI * C::IR * NV;
#pragma unroll
    for (int k = 0; k < (N + F_THREADS - 1) / F_THREADS; ++k) {
      const int e = tid + k * F_THREADS;
      if (N % F_THREADS == 0 || e < N) {
        const int q = e % NV, row = e / NV, ci = row / C::IR, gy = y0 - PAD + row % C::IR;
        const int gx = x0 - C::LEFT + 4 * q;
        const bool ok = ci < cn && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        cp_async16_zfill(st + row * C::IP + 4 * q,
                         ok ? xs + ci * HW + (long long)gy * a.W + gx : s.x, ok);
      }
    }
  } else {  // a warp per channel, a lane per column, row by row
    const float* x = xs + warp * HW + (long long)(y0 - PAD) * a.W + x0 - C::LEFT + lane;
    float* d = st + warp * (C::IR * C::IP) + lane;
#pragma unroll 1
    for (int ci = warp; ci < C::CI; ci += F_THREADS / 32) {
      const unsigned rok = ci < cn ? rows_ok : 0u;
#pragma unroll
      for (int r = 0; r < C::IR; ++r) {
#pragma unroll
        for (int m = 0; m < (C::IC + 31) / 32; ++m) {
          if (lane + 32 * m < C::IC) {
            const bool ok = (rok >> r) & (cols_ok >> m) & 1u;
            cp_async4_zfill(d + r * C::IP + 32 * m, ok ? x + r * a.W + 32 * m : s.x, ok);
          }
        }
      }
      x += (F_THREADS / 32) * HW;
      d += (F_THREADS / 32) * (C::IR * C::IP);
    }
  }
  float* sw = st + C::IN;
  const float* wb = a.wt + b * a.w_b + a.w_off + (long long)(s.cb + s.c0) * a.w_ci;
  if (a.w_vec) {  // 16-byte copies along Cout
    constexpr int N = C::CI * C::KK * (F_CO / 4);
#pragma unroll 1
    for (int k = 0; k < (N + F_THREADS - 1) / F_THREADS; ++k) {
      const int e = tid + k * F_THREADS;
      if (N % F_THREADS == 0 || e < N) {
        const int q = e % (F_CO / 4), row = e / (F_CO / 4), ci = row / C::KK, tap = row % C::KK;
        const int co = co0 + 4 * q;
        const bool ok = ci < cn && co < a.Cout;
        cp_async16_zfill(sw + row * F_WP + 4 * q,
                         ok ? wb + tap * a.w_tap + ci * a.w_ci + co : a.wt, ok);
      }
    }
  } else {  // 4-byte copies, input channel fastest (the dx call's agg is contiguous in it)
    constexpr int N = C::CI * C::KK * F_CO;
#pragma unroll 1
    for (int k = 0; k < N / F_THREADS; ++k) {
      const int e = tid + k * F_THREADS;
      const int ci = e % C::CI, co = (e / C::CI) % F_CO, tap = e / (C::CI * F_CO);
      const bool ok = ci < cn && co0 + co < a.Cout;
      cp_async4_zfill(sw + (ci * C::KK + tap) * F_WP + co,
                      ok ? wb + tap * a.w_tap + ci * a.w_ci + (co0 + co) * a.w_co : a.wt, ok);
    }
  }
}

// The FMAs of one stage: `si` is the stage's input at this lane's first row
// and column, `sw` its weights at this warp's first output channel.
template <int KS, int PAD>
__device__ __forceinline__ void f32_fma(float (&acc)[8][2][4], const float* si,
                                        const float* sw) {
  using C = FCfg<KS, PAD>;
#pragma unroll 1
  for (int c = 0; c < C::CI; c += C::UNROLL) {
#pragma unroll
    for (int u = 0; u < C::UNROLL; ++u) {
      const float* x = si + (c + u) * (C::IR * C::IP);
      const float* w = sw + (c + u) * (C::KK * F_WP);
      float v[1 + KS][4 + KS - 1];
#pragma unroll
      for (int ir = 0; ir < 1 + KS; ++ir) {
        const float* row = x + ir * C::IP + C::LEFT - PAD;  // this lane's first input column
        if constexpr ((C::LEFT - PAD) % 4 == 0) {
          const float4 p = *reinterpret_cast<const float4*>(row);
          v[ir][0] = p.x, v[ir][1] = p.y, v[ir][2] = p.z, v[ir][3] = p.w;
          if constexpr (KS == 3) {
            const float2 q = *reinterpret_cast<const float2*>(row + 4);
            v[ir][4] = q.x, v[ir][5] = q.y;
          }
        } else if constexpr (C::LEFT - PAD == 3) {
          const float4 p = *reinterpret_cast<const float4*>(row + 1);
          v[ir][0] = row[0], v[ir][1] = p.x, v[ir][2] = p.y, v[ir][3] = p.z, v[ir][4] = p.w;
          v[ir][5] = row[5];
        } else {
          const float2 q = *reinterpret_cast<const float2*>(row);
          const float4 p = *reinterpret_cast<const float4*>(row + 2);
          v[ir][0] = q.x, v[ir][1] = q.y, v[ir][2] = p.x, v[ir][3] = p.y, v[ir][4] = p.z;
          v[ir][5] = p.w;
        }
      }
#pragma unroll
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
        const float4 lo = *reinterpret_cast<const float4*>(w + tap * F_WP);
        const float4 hi = *reinterpret_cast<const float4*>(w + tap * F_WP + 4);
        const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][r][j] = fmaf(wv[i], v[r + dy][j + dx], acc[i][r][j]);
      }
    }
  }
}

// The epilogue in the TPU order; neutral terms where a pointer is null.
__device__ __forceinline__ float f32_epilogue(const F32Conv& a, float v, float bv, float sc,
                                              float pv, float rv) {
  v = v + bv;
  v = v + pv;
  v = v * sc;
  if (a.lrelu) v = a.la * v + a.lb * fabsf(v);
  return v + rv;
}

// blockIdx: (column tile, row tile, (sample, channel tile, chunk)).
template <int KS, int PAD>
__global__ void __launch_bounds__(F_THREADS, 2) conv_f32_kernel(const __grid_constant__ F32Conv a) {
  using C = FCfg<KS, PAD>;
  extern __shared__ __align__(16) float f_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * F_COLS, y0 = blockIdx.y * F_ROWS;
  const int nct = (a.Cout + F_CO - 1) / F_CO;
  const int chunk = blockIdx.z % a.nchunks, bc = blockIdx.z / a.nchunks;
  const int co0 = (bc % nct) * F_CO, b = bc / nct;
  const int t0 = chunk * a.chunk_stages, nst = min(a.chunk_stages, a.stages - t0);

  unsigned rows_ok = 0, cols_ok = 0;
#pragma unroll
  for (int r = 0; r < C::IR; ++r)
    rows_ok |= unsigned(y0 - PAD + r >= 0 && y0 - PAD + r < a.H) << r;
#pragma unroll
  for (int m = 0; m < (C::IC + 31) / 32; ++m) {
    const int gx = x0 - C::LEFT + lane + 32 * m;
    cols_ok |= unsigned(gx >= 0 && gx < a.W) << m;
  }
  FSrc load;
  f32_part(a, 0, b, load);
  for (int t = 0; t < t0; ++t) f32_next<KS>(a, b, load);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nst) {
      f32_stage<KS, PAD>(a, load, b, co0, x0, y0, rows_ok, cols_ok, f_smem + s * C::STAGE);
      f32_next<KS>(a, b, load);
    }
    hopper::cp_async_commit();
  }

  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][r][j] = 0.f;
  // lane: output channels cw..cw+7, rows 2 rp, 2 rp + 1, columns px..px+3
  // of the tile; a warp covers 32 channels x 4 rows x 16 columns, so that a
  // shared load serves 8 lanes (pixels) or 4 (weights) with one address
  const int g = lane & 3, rp = (lane >> 2) & 1, cg = lane >> 3;
  const int px = 16 * (warp >> 1) + 4 * g, cw = 32 * (warp & 1) + 8 * cg;
  for (int t = 0; t < nst; ++t) {
    hopper::cp_async_wait<C::STAGES - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and every warp is done with stage t - 1's buffer
    const int ahead = t + C::STAGES - 1;
    if (ahead < nst) {
      f32_stage<KS, PAD>(a, load, b, co0, x0, y0, rows_ok, cols_ok,
                    f_smem + (ahead % C::STAGES) * C::STAGE);
      f32_next<KS>(a, b, load);
    }
    hopper::cp_async_commit();
    const float* st = f_smem + (t % C::STAGES) * C::STAGE;
    f32_fma<KS, PAD>(acc, st + 2 * rp * C::IP + px, st + C::IN + cw);
  }

  const int gx = x0 + px;
  if (gx >= a.Wo) return;
  const bool split = a.nchunks > 1;
  float* dst = split ? a.partial + (long long)chunk * a.B * a.Cout * a.Ho * a.Wo : a.out;
  const bool v4 = a.out_vec && gx + 3 < a.Wo;  // Wo % 4 == 0: all four columns or none
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + cw + i;
    if (co >= a.Cout) break;
    const float bv = a.bias && !split ? a.bias[co] : 0.f;
    const float sc = a.scale && !split ? a.scale[b * a.s_bstride + co] : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gy = y0 + 2 * rp + r;
      if (gy >= a.Ho) break;
      const long long idx = (((long long)b * a.Cout + co) * a.Ho + gy) * a.Wo + gx;
      float v[4] = {acc[i][r][0], acc[i][r][1], acc[i][r][2], acc[i][r][3]};
      if (v4) {
        if (!split) {
          const float4 p = a.pre ? *reinterpret_cast<const float4*>(a.pre + idx) : float4{};
          const float4 q = a.res ? *reinterpret_cast<const float4*>(a.res + idx) : float4{};
          v[0] = f32_epilogue(a, v[0], bv, sc, p.x, q.x);
          v[1] = f32_epilogue(a, v[1], bv, sc, p.y, q.y);
          v[2] = f32_epilogue(a, v[2], bv, sc, p.z, q.z);
          v[3] = f32_epilogue(a, v[3], bv, sc, p.w, q.w);
        }
        *reinterpret_cast<float4*>(dst + idx) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gx + j >= a.Wo) break;
          if (!split)
            v[j] = f32_epilogue(a, v[j], bv, sc, a.pre ? a.pre[idx + j] : 0.f,
                                a.res ? a.res[idx + j] : 0.f);
          dst[idx + j] = v[j];
        }
      }
    }
  }
}

// The split's second pass: output (b, co) plane blockIdx.y, the chunks'
// partials added in chunk order, then the epilogue.
__global__ void __launch_bounds__(256) conv_f32_reduce_kernel(const __grid_constant__ F32Conv a) {
  const int plane = a.Ho * a.Wo, co = blockIdx.y % a.Cout, b = blockIdx.y / a.Cout;
  const long long n = (long long)a.B * a.Cout * plane;
  const float bv = a.bias ? a.bias[co] : 0.f;
  const float sc = a.scale ? a.scale[b * a.s_bstride + co] : 1.f;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < plane; p += gridDim.x * blockDim.x) {
    const long long idx = (long long)blockIdx.y * plane + p;
    float v = a.partial[idx];
    for (int k = 1; k < a.nchunks; ++k) v += a.partial[k * n + idx];
    a.out[idx] = f32_epilogue(a, v, bv, sc, a.pre ? a.pre[idx] : 0.f, a.res ? a.res[idx] : 0.f);
  }
}

template <int KS, int PAD>
cudaError_t launch_f32(const F32Conv& a, cudaStream_t stream) {
  using C = FCfg<KS, PAD>;
  static bool ready = false;
  if (!ready) {  // two blocks' shared memory on one SM
    cudaError_t e = cudaFuncSetAttribute(conv_f32_kernel<KS, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_f32_kernel<KS, PAD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int nct = (a.Cout + F_CO - 1) / F_CO;
  dim3 grid((a.Wo + F_COLS - 1) / F_COLS, (a.Ho + F_ROWS - 1) / F_ROWS, a.B * nct * a.nchunks);
  conv_f32_kernel<KS, PAD><<<grid, F_THREADS, C::SMEM, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nchunks == 1) return e;
  const int plane = a.Ho * a.Wo, px = (plane + 255) / 256;
  conv_f32_reduce_kernel<<<dim3(px < 16 ? px : 16, a.B * a.Cout), 256, 0, stream>>>(a);
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

// The split conv's epilogue operands: f32 bias, pre_add and out_scale; a
// residual as a pair (res_hi + res_lo) or in f32 (res_f); the result as a
// pair (out_hi, out_lo) or in f32 (out_f). Null pointers switch a term off.
struct SplitEpi {
  const float* bias;
  const float* pre;
  const float* scale;
  long long s_bstride;
  int lrelu;
  float la, lb;
  const __nv_bfloat16* res_hi;
  const __nv_bfloat16* res_lo;
  const float* res_f;
  __nv_bfloat16* out_hi;
  __nv_bfloat16* out_lo;
  float* out_f;
};

// Pixel pair i (0..31) of a consumer thread's fragment of a whole tile (the
// m64n256k16 layout: acc[4i + 2j + c] is output channel 16*(warp%4) + lane/4
// + 8j of the tile, row y0 + i / 8, column x0 + 8*(i%8) + c): at offset o
// from the thread's (row y0, column x0) of a channel plane, inside the
// output (ok), both columns inside (two; always where W is even, VEC).
#define SPLIT_PIXEL(i)                                                 \
  const int x = x0 + 8 * ((i) % 8);                                    \
  const bool ok = y0 + (i) / 8 < H && x < W, two = VEC || x + 1 < W;   \
  const int o = ((i) / 8) * W + 8 * ((i) % 8)

// The split conv's epilogue on a consumer thread's fragment of a tile, in
// f32, in the TPU order: + bias, + pre_add, x out_scale, abs-form
// LeakyReLU, + residual (RES 2: a pair's hi + lo, 1: f32, 0: none); written
// as a pair (PAIR_OUT: hi = bf16(v), lo = bf16(v - hi)) or as f32; VEC: W
// even, so each pixel pair is one 4-byte bf16 or 8-byte f32 access. One
// short straight run of code per (RES, PAIR_OUT, VEC), picked by uniform
// branches as the consumers start (every runtime path in one body, 9.3k
// SASS instructions, cost the fast route ~0.1 ms a call in instruction
// fetch). Per output channel and pair of rows (16 pixel pairs), every
// residual load is issued before the first store: a load behind a store
// that may alias it waits for it, so loads and stores taken pixel pair by
// pixel pair wait a round trip to memory each (0.245 of 0.418 ms for the
// 3x3 64->64 with a pair residual at 8 x 180x320, H100 at 700 W). Addresses
// are 32-bit offsets from one base a channel. pre_add, which no main-path
// conv takes, is folded in ahead.
template <int RES, bool PAIR_OUT, bool VEC>
__device__ __forceinline__ void split_epilogue(float (&acc)[128], const SplitEpi& e,
                                               const Tile& tl, int warp, int lane, int H, int W,
                                               int Cout) {
  const int y0 = tl.y0, x0 = tl.x0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int co = tl.ct * TC_CO + 16 * (warp % 4) + lane / 4 + 8 * j;
    if (co >= Cout) continue;
    float bv = e.bias ? e.bias[co] : 0.f;
    const float sv = e.scale ? e.scale[tl.b * e.s_bstride + co] : 1.f;
    const long long base = ((long long)tl.b * Cout + co) * H * W + (long long)y0 * W + x0;
    if (e.pre) {  // v = (acc + bias) + pre_add (off the main path)
      const float* p = e.pre + base;
#pragma unroll 1
      for (int i = 0; i < 32; ++i) {
        SPLIT_PIXEL(i);
        const float p0 = ok ? p[o] : 0.f, p1 = ok && two ? p[o + 1] : 0.f;
        // a runtime index into acc would move it to local memory: select
#pragma unroll
        for (int m = 0; m < 32; ++m) {
          if (m == i) {
            acc[4 * m + 2 * j] = (acc[4 * m + 2 * j] + bv) + p0;
            acc[4 * m + 2 * j + 1] = (acc[4 * m + 2 * j + 1] + bv) + p1;
          }
        }
      }
      bv = 0.f;
    }
    __nv_bfloat16* oh = e.out_hi + base;
    __nv_bfloat16* ol = e.out_lo + base;
    float* of = e.out_f + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 2h, 2h + 1 of the tile
      float2 r[16];
      if (RES) {  // the loads, all in flight at once
        const __nv_bfloat16* rh = e.res_hi + base;
        const __nv_bfloat16* rl = e.res_lo + base;
        const float* rf = e.res_f + base;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          SPLIT_PIXEL(16 * h + n);
          r[n] = make_float2(0.f, 0.f);
          if (!ok) continue;
          if (VEC && RES == 2) {
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rh + o));
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rl + o));
            r[n] = make_float2(hi.x + lo.x, hi.y + lo.y);
          } else if (VEC) {
            r[n] = *reinterpret_cast<const float2*>(rf + o);
          } else {
            r[n].x = RES == 2 ? __bfloat162float(rh[o]) + __bfloat162float(rl[o]) : rf[o];
            if (two)
              r[n].y = RES == 2 ? __bfloat162float(rh[o + 1]) + __bfloat162float(rl[o + 1])
                                : rf[o + 1];
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int i = 16 * h + n;
        SPLIT_PIXEL(i);
        if (!ok) continue;
        float v[2] = {acc[4 * i + 2 * j] + bv, acc[4 * i + 2 * j + 1] + bv};
        const float rv[2] = {r[n].x, r[n].y};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          v[c] *= sv;
          if (e.lrelu) v[c] = e.la * v[c] + e.lb * fabsf(v[c]);
          if (RES) v[c] += rv[c];
        }
        if (PAIR_OUT) {
          if (VEC) {
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
            const float2 hf = __bfloat1622float2(hi);
            *reinterpret_cast<__nv_bfloat162*>(oh + o) = hi;
            *reinterpret_cast<__nv_bfloat162*>(ol + o) =
                __floats2bfloat162_rn(v[0] - hf.x, v[1] - hf.y);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if (c == 1 && !two) break;
              const __nv_bfloat16 hi = __float2bfloat16_rn(v[c]);
              oh[o + c] = hi;
              ol[o + c] = __float2bfloat16_rn(v[c] - __bfloat162float(hi));
            }
          }
        } else if (VEC) {
          *reinterpret_cast<float2*>(of + o) = make_float2(v[0], v[1]);
        } else {
          of[o] = v[0];
          if (two) of[o + 1] = v[1];
        }
      }
    }
  }
}
#undef SPLIT_PIXEL

// Persistent: block i takes tiles i, i + gridDim.x, ... (64 output channels
// x 4 rows x 64 columns each); every role walks the same (tile, chunk)
// sequence through the ring, so the producer loads the next tile's stages
// while the consumers run this tile's epilogue. bias, pre, res and out are
// bf16.
template <int KS>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ TmaParts parts, int nchunk, int ntiles, int nx, int ny,
                  int nct, int H, int W, int Cout, const __nv_bfloat16* __restrict__ wpk,
                  long long w_bstride, const void* __restrict__ bias_,
                  const void* __restrict__ pre_, const float* __restrict__ scale,
                  long long s_bstride, int lrelu, float la, float lb,
                  const void* __restrict__ res_, void* __restrict__ out_) {
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
            tma_load_4d(st + C::HALO_OFF + C::SLAB * HALO_BYTES, &parts.halo[p],
                        &tma_full[stage], tl.x0 + TC_COLS, c0, y, tl.b);
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
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(bias_);
    const __nv_bfloat16* pre = static_cast<const __nv_bfloat16*>(pre_);
    const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(res_);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(out_);
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

// ---------------------------------------------------------------------------
// split: a pair's hi and lo planes on the tensor cores (conv_split_kernel)
// ---------------------------------------------------------------------------

// The bf16 kernel's tiles and wgmmas, with a pipeline stage that holds one
// 16-channel chunk of one pair: the hi and lo slabs by TMA (each read once),
// their 8-pixel halo boxes (3x3), and the chunk's [Whi | Wlo] weights in one
// bulk copy (ops/conv.py pack_weight_pair); three shift warps build each
// plane's dx = 0 and dx = 2 buffers once; the consumers issue 3 x KK wgmmas
// into the same accumulators: hi x Whi, hi x Wlo, lo x Whi. Walked as the
// segments hi, lo, hi (the bf16 kernel against [Whi, Whi, Wlo]), a chunk read
// three slabs, shifted three and waited on three barriers for 9 MMAs each.
// Warps 0-7: two consumer warpgroups (2 rows each); warp 8: the producer
// (TMA); warps 9-11: the shift warps; `setmaxnreg` 224 / 56, so that a
// consumer holds its tile's residual (loaded as the tile starts, under its
// MMAs) beside the accumulators. Shared memory, 3x3: two stages of 108 KB
// (each plane's three 12 KB B buffers, 36 KB of weights) and one 6 KB slot
// for the four halo boxes, 223 KB of the 227 a block may use; the producer
// refills the halo slot once the shift warps have read it, which they do
// before the consumers see that chunk. 1x1: ten stages of 20 KB.
constexpr int PAIR_MAX = 5;  // pairs a launch: the WindowUnit_l2 merge and OSConv over 5
constexpr int SP_PRODUCER_WARP = TC_CONSUMERS * 4;  // warp 8
constexpr int SP_SHIFTERS = 3;                      // warps 9-11
constexpr int SP_THREADS = (SP_PRODUCER_WARP + 1 + SP_SHIFTERS) * 32;
constexpr int SP_CONSUMER_REGS = 224, SP_OTHER_REGS = 56;  // setmaxnreg split of 65,536
static_assert(TC_CONSUMERS * 128 * SP_CONSUMER_REGS + 128 * SP_OTHER_REGS <= 65536,
              "the register split fits the SM");

// Pair p's hi plane is map 2p, its lo plane map 2p + 1 (TmaParts' two boxes
// each); the kernel's parameters stay under 4 KB.
struct PairParts {
  CUtensorMap center[2 * PAIR_MAX];
  CUtensorMap halo[2 * PAIR_MAX];
  int c[PAIR_MAX];
  int n;
};

template <int KS>
struct PairCfg {
  static constexpr int HALO = KS / 2;
  static constexpr int SLAB = TC_ROWS + 2 * HALO;
  static constexpr int KK = KS * KS;
  static constexpr int BUF = SLAB * ROW_BYTES;            // one plane's B buffer of one dx
  static constexpr int PLANE = (KS == 3 ? 3 : 1) * BUF;   // dx = 1 (TMA), then 0 and 2
  static constexpr int SHIFT0 = BUF, SHIFT2 = 2 * BUF;    // in a plane's buffers, KS = 3
  static constexpr int LO = PLANE;                        // the lo plane's buffers
  static constexpr int W_OFF = 2 * PLANE;                 // [Whi taps][Wlo taps]
  static constexpr int W_BYTES = 2 * KK * TAP_BYTES;
  static constexpr int STAGE_BYTES = W_OFF + W_BYTES;
  static constexpr int STAGES = KS == 3 ? 2 : 10;
  static constexpr int LINES = SLAB * TC_CI;              // a plane's 128-byte lines
  static constexpr int HALO_SIDE = SLAB * HALO_BYTES;     // one box: [row][16 ch][8 px]
  static constexpr int HALO_OFF = STAGES * STAGE_BYTES;   // [hi left][hi right][lo left][lo right]
  static constexpr int SMEM = HALO_OFF + (KS == 3 ? 4 * HALO_SIDE : 0) + 1024;  // + alignment slack
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");
  static_assert(SMEM + 512 <= 232448, "fits the 227 KB a block may use, with the barriers");
  static_assert(KS == 1 || 2 * 2 * LINES == 4 * SP_SHIFTERS * 32, "four half lines a thread");
};

// The consumer warpgroups of conv_split_kernel at one epilogue kind, ping
// pong: warpgroup wg takes the block's tiles wg, wg + 2, ... (the block's
// n-th tile is i + n * gridDim.x), each whole (m64n256k16: 64 output
// channels x 4 rows x 64 columns), so that one warpgroup's epilogue runs
// while the other's MMAs keep the tensor cores busy. Their chunks come
// through the ring in the block's tile order: tile n's chunk k is the
// ring's (n * nchunk + k)-th stage. A barrier tells its phases apart only
// by parity, so a warpgroup waits on the ring for tile n only once the
// other has seen tile n - 1's last chunk land (turn[wg]): then no slot is
// two phases behind the one it waits for. Every warp of the other arrives
// on turn[wg], so the turn cannot come round again before all of this
// warpgroup's warps have seen it (given by one warp, it can come round
// twice under warps still waiting on it when a tile is one chunk).
template <int KS, int RES, bool PAIR_OUT, bool VEC>
__device__ __forceinline__ void split_consume(uint8_t* smem, uint64_t* ready, uint64_t* empty,
                                              uint64_t* turn, int nchunk, int ntiles, int nx,
                                              int ny, int nct, int H, int W, int Cout,
                                              const SplitEpi& e, int warp, int lane, int wg) {
  using C = PairCfg<KS>;
  using namespace hopper;
  for (int n = wg, t = blockIdx.x + wg * gridDim.x; t < ntiles; n += 2, t += 2 * gridDim.x) {
    const Tile tl = tile_of(t, nx, ny, nct);
    if (n > 0) mbar_wait(&turn[wg], ((n - 1) / 2) & 1);  // the other's (n - 1) / 2-th turn
    float acc[128];
    int held = -1;  // the stage whose MMAs may still be running
    for (int k = 0; k < nchunk; ++k) {
      const int pos = n * nchunk + k, stage = pos % C::STAGES;
      mbar_wait(&ready[stage], (pos / C::STAGES) & 1);
      if (k == nchunk - 1 && lane == 0) mbar_arrive(&turn[wg ^ 1]);
      const uint32_t st = smem_u32(smem + stage * C::STAGE_BYTES);
      const uint32_t a_hi = st + C::W_OFF, a_lo = a_hi + C::KK * TAP_BYTES;
      fence_regs(acc);
      wgmma_fence();
      // hi x Whi, hi x Wlo, lo x Whi (the lo x lo term, ~2^-16 relative,
      // is dropped): A the tap's [64 co][16 ci] block as 8x8 core matrices
      // (K halves 128 B apart, 8-row groups 256 B apart), B the dx buffer of
      // the plane from slab row dy, 64 px a row, the tile's 4 rows 2 KB apart,
      // channels 0-7 / 8-15 1 KB apart
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const uint32_t a0 = m == 1 ? a_lo : a_hi, b0 = m == 2 ? st + C::LO : st;
#pragma unroll
        for (int tap = 0; tap < C::KK; ++tap) {
          const int dy = tap / KS, dx = tap % KS;
          const uint32_t buf = KS == 1 ? 0 : dx == 0 ? C::SHIFT0 : dx == 1 ? 0 : C::SHIFT2;
          const uint64_t da = make_desc(a0 + tap * TAP_BYTES, 128, 256, kInterleave);
          const uint64_t db = make_desc(b0 + buf + dy * ROW_BYTES, ROW_BYTES, 1024, kSwizzle128);
          // the tile's first product overwrites the accumulators
          wgmma_m64n256k16_bf16(acc, da, db, (k | m | tap) != 0);
        }
      }
      wgmma_commit();
      // keep this stage's MMAs in flight; release the one before it
      wgmma_wait<1>();
      fence_regs(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);
    split_epilogue<RES, PAIR_OUT, VEC>(acc, e, tl, warp, lane, H, W, Cout);
  }
}

// A uniform dispatch on the launch's epilogue kind: CALL(RES, PAIR_OUT, VEC)
// for res_lo (a pair residual) or res (an f32 one) or neither, out_lo (a
// pair output) or not, and W even or odd.
#define SPLIT_DISPATCH(CALL, res, res_lo, out_lo, W)  \
  do {                                                \
    if ((out_lo) && ((W) & 1) == 0) {                 \
      if (res_lo) CALL(2, true, true);                \
      else if (res) CALL(1, true, true);              \
      else CALL(0, true, true);                       \
    } else if (out_lo) {                              \
      if (res_lo) CALL(2, true, false);               \
      else if (res) CALL(1, true, false);             \
      else CALL(0, true, false);                      \
    } else if (((W) & 1) == 0) {                      \
      if (res_lo) CALL(2, false, true);               \
      else if (res) CALL(1, false, true);             \
      else CALL(0, false, true);                      \
    } else {                                          \
      if (res_lo) CALL(2, false, false);              \
      else if (res) CALL(1, false, false);            \
      else CALL(0, false, false);                     \
    }                                                 \
  } while (0)

// Persistent, one block per SM walking tiles i, i + gridDim.x, ... (64
// output channels x 4 rows x 64 columns); every role walks the same (tile,
// chunk) sequence through the ring. bias and pre are f32; res is the
// residual's hi plane with res_lo its lo plane, or, with res_lo null, an f32
// residual; out is the result's hi plane with out_lo its lo plane, or, with
// out_lo null, the f32 result.
template <int KS>
__global__ void __launch_bounds__(SP_THREADS, 1)
conv_split_kernel(const __grid_constant__ PairParts parts, int nchunk, int ntiles, int nx, int ny,
                  int nct, int H, int W, int Cout, const __nv_bfloat16* __restrict__ wpk,
                  long long w_bstride, const float* __restrict__ bias,
                  const float* __restrict__ pre, const float* __restrict__ scale,
                  long long s_bstride, int lrelu, float la, float lb,
                  const void* __restrict__ res_, const __nv_bfloat16* __restrict__ res_lo,
                  void* __restrict__ out_, __nv_bfloat16* __restrict__ out_lo) {
  using C = PairCfg<KS>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // tma_full: the stage's copies landed; full: (3x3) its shifted buffers
  // are built too; empty: the consumers are done with it; halo_empty: the
  // shift warps have read the halo slot
  __shared__ __align__(8) uint64_t tma_full[C::STAGES], full[C::STAGES], empty[C::STAGES];
  // turn[wg]: the other consumer warpgroup has seen its tile's last chunk land
  __shared__ __align__(8) uint64_t halo_empty, turn[TC_CONSUMERS];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);  // warp-uniform

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&tma_full[s], 1);
      mbar_init(&full[s], SP_SHIFTERS);         // one arrival per shift warp
      mbar_init(&empty[s], 4);  // one per warp of the consumer warpgroup that took it
    }
    mbar_init(&halo_empty, SP_SHIFTERS);
    for (int w = 0; w < TC_CONSUMERS; ++w) mbar_init(&turn[w], 4);  // one per warp
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == TC_CONSUMERS) {
    setmaxnreg_dec<SP_OTHER_REGS>();
    if (warp == SP_PRODUCER_WARP) {
      // one thread issues each chunk's copies: both slabs, the weights, and
      // the halo boxes that are inside the image
      if (lane != 0) return;
      int stage = 0;
      uint32_t phase = 0, hphase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of(t, nx, ny, nct);
        const bool left = KS == 3 && tl.x0 > 0, right = KS == 3 && tl.x0 + TC_COLS < W;
        const uint32_t bytes =
            2 * C::BUF + C::W_BYTES + 2 * (int(left) + int(right)) * C::HALO_SIDE;
        const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wpk + tl.b * w_bstride) +
                              (long long)tl.ct * nchunk * C::W_BYTES;
        const int y = tl.y0 - C::HALO;
        int chunk = 0;
        for (int p = 0; p < parts.n; ++p) {
          for (int c0 = 0; c0 < parts.c[p]; c0 += TC_CI, ++chunk) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&tma_full[stage], bytes);
            uint8_t* st = smem + stage * C::STAGE_BYTES;
            tma_load_4d(st, &parts.center[2 * p], &tma_full[stage], tl.x0, c0, y, tl.b);
            tma_load_4d(st + C::LO, &parts.center[2 * p + 1], &tma_full[stage], tl.x0, c0, y,
                        tl.b);
            bulk_load(st + C::W_OFF, wsrc + (long long)chunk * C::W_BYTES, C::W_BYTES,
                      &tma_full[stage]);
            if (KS == 3) {
              if (left || right) {
                // the shift warps arrive once a chunk, so the slot's previous
                // chunk is the last phase of halo_empty
                mbar_wait(&halo_empty, hphase ^ 1);
                uint8_t* hs = smem + C::HALO_OFF;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  if (left)
                    tma_load_4d(hs + 2 * q * C::HALO_SIDE, &parts.halo[2 * p + q],
                                &tma_full[stage], tl.x0 - HALO_PX, c0, y, tl.b);
                  if (right)
                    tma_load_4d(hs + (2 * q + 1) * C::HALO_SIDE, &parts.halo[2 * p + q],
                                &tma_full[stage], tl.x0 + TC_COLS, c0, y, tl.b);
                }
              }
              hphase ^= 1;
            }
            if (++stage == C::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      return;
    }
    // shift warps (3x3): the 2 x SLAB x 16 lines of a chunk (plane, slab
    // row, channel) as 384 half lines, four a thread: a half line's 4
    // swizzled 16-byte chunks shifted one pixel each way (dx = 0 reads
    // x - 1, dx = 2 reads x + 1), its outer end from the halo pixel (or the
    // zero padding), its inner end from the other half's neighbouring word
    if (KS == 1) return;
    const int sid = threadIdx.x - (SP_PRODUCER_WARP + 1) * 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(t, nx, ny, nct);
      const bool left = tl.x0 > 0, right = tl.x0 + TC_COLS < W;
      for (int k = 0; k < nchunk; ++k) {
        mbar_wait(&tma_full[stage], phase);
        uint8_t* st = smem + stage * C::STAGE_BYTES;
        const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(smem + C::HALO_OFF);
        uint32_t edge[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = sid + SP_SHIFTERS * 32 * i, q = u / (2 * C::LINES);
          const int l = (u / 2) % C::LINES, hh = u & 1;
          // half 0 ends at the left halo box's last pixel, half 1 at the
          // right box's first
          const __nv_bfloat16* h = hs + ((2 * q + hh) * C::LINES + l) * HALO_PX;
          edge[i] = hh ? (right ? __bfloat16_as_ushort(h[0]) : 0u)
                       : (left ? uint32_t(__bfloat16_as_ushort(h[HALO_PX - 1])) << 16 : 0u);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&halo_empty);
#pragma unroll 1
        for (int i = 0; i < 4; ++i) {
          const int u = sid + SP_SHIFTERS * 32 * i, q = u / (2 * C::LINES);
          const int l = (u / 2) % C::LINES, hh = u & 1;
          const int line = q * C::PLANE + l * 128;  // slab row l / 16, channel l % 16
          const int sw = l % 8;  // the 128-byte swizzle: 16-byte chunk j sits at j ^ (c % 8)
          uint4 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = *reinterpret_cast<const uint4*>(st + line + (((4 * hh + j) ^ sw) << 4));
          // half 0: the next word is chunk 4's first; half 1: the previous
          // word is chunk 3's last
          const uint32_t inner = *reinterpret_cast<const uint32_t*>(
              st + line + (((hh ? 3 : 4) ^ sw) << 4) + (hh ? 12 : 0));
          uint32_t ed = edge[0];  // edge[i] by selects: a runtime index would go to local memory
#pragma unroll
          for (int m = 1; m < 4; ++m) ed = i == m ? edge[m] : ed;
          const uint32_t first = hh ? inner : ed, last = hh ? ed : inner;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t prev = j > 0 ? v[j - 1].w : first;
            const uint32_t next = j < 3 ? v[j + 1].x : last;
            const uint4 d0 = make_uint4(straddle(prev, v[j].x), straddle(v[j].x, v[j].y),
                                        straddle(v[j].y, v[j].z), straddle(v[j].z, v[j].w));
            const uint4 d2 = make_uint4(straddle(v[j].x, v[j].y), straddle(v[j].y, v[j].z),
                                        straddle(v[j].z, v[j].w), straddle(v[j].w, next));
            const int off = line + (((4 * hh + j) ^ sw) << 4);
            *reinterpret_cast<uint4*>(st + C::SHIFT0 + off) = d0;
            *reinterpret_cast<uint4*>(st + C::SHIFT2 + off) = d2;
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

  setmaxnreg_inc<SP_CONSUMER_REGS>();
  const SplitEpi e{bias, pre, scale, s_bstride, lrelu, la, lb,
                   static_cast<const __nv_bfloat16*>(res_), res_lo,
                   static_cast<const float*>(res_), static_cast<__nv_bfloat16*>(out_), out_lo,
                   static_cast<float*>(out_)};
#define SPLIT_CONSUME(R, P, V)                                                                 \
  split_consume<KS, R, P, V>(smem, KS == 3 ? full : tma_full, empty, turn, nchunk, ntiles, nx, ny, \
                             nct, H, W, Cout, e, warp, lane, wgi)
  SPLIT_DISPATCH(SPLIT_CONSUME, res_, res_lo, out_lo, W);
#undef SPLIT_CONSUME
}

// ---------------------------------------------------------------------------
// fast: f32 in and out, one bf16 pass (conv_fast_kernel)
// ---------------------------------------------------------------------------

// The tiles, the K walk and the consumers' wgmmas are the bf16 kernel's;
// the parts arrive in f32 and are rounded to bf16 in shared memory. Per
// 16-channel chunk the producer warp brings the f32 slab [SLAB rows][16
// ch][64 px] (and, 3x3, a 4-pixel f32 halo box on each side) by TMA into an
// f32 ring; three converter warps round it to nearest even into the bf16
// stage's three B-operand buffers (dx = 0, 1, 2: the lines shifted by one
// pixel each way, neighbours by warp shuffles, the ends from the halos),
// each line written in the 128-byte swizzle TMA would have given it, and
// bring the chunk's weights into the stage by a bulk copy. The f32 ring runs
// ahead of the bf16 ring, so device memory stays busy through the
// consumers' epilogue; the residual tile is loaded into registers when a
// tile starts, under its MMAs.
constexpr int FAST_MAPS = 10;                            // parts a launch
constexpr int FX_PRODUCER_WARP = TC_CONSUMERS * 4;       // warp 8
constexpr int FX_CONVERTERS = 3;                         // warps 9-11
constexpr int FX_THREADS = (FX_PRODUCER_WARP + 1 + FX_CONVERTERS) * 32;
constexpr int FX_HALO_PX = 4;                            // TMA's 16-byte granule in f32
constexpr int F32_ROW = TC_CI * TC_COLS * 4;             // 4 KB: one f32 slab row
constexpr int FX_CONSUMER_REGS = 224, FX_OTHER_REGS = 56;  // setmaxnreg split of 65,536
static_assert(TC_CONSUMERS * 128 * FX_CONSUMER_REGS + 128 * FX_OTHER_REGS <= 65536,
              "the register split fits the SM");

// Per part, the f32 maps (W, C, H, B): the slab (box 64 x 16 x SLAB) and,
// 3x3, the halo (box 4 x 16 x SLAB); no swizzle.
struct FastParts {
  CUtensorMap center[FAST_MAPS];
  CUtensorMap halo[FAST_MAPS];
  int c[FAST_MAPS];
  int n;
};

template <int KS>
struct FxCfg {
  static constexpr int HALO = KS / 2;
  static constexpr int SLAB = TC_ROWS + 2 * HALO;
  static constexpr int KK = KS * KS;
  static constexpr int LINES = SLAB * TC_CI;  // f32 lines of 64 px in a chunk
  // bf16 stage: the B buffers (dx = 1, 0, 2) and the weights, as TcCfg
  static constexpr int BUF = SLAB * ROW_BYTES;
  static constexpr int SHIFT0 = BUF, SHIFT2 = 2 * BUF;
  static constexpr int W_OFF = KS == 3 ? 3 * BUF : BUF;
  static constexpr int W_BYTES = KK * TAP_BYTES;
  static constexpr int BF_BYTES = W_OFF + W_BYTES;
  // f32 stage: the slab, then (3x3) the left and right halo boxes
  static constexpr int HALO_OFF = SLAB * F32_ROW;
  static constexpr int HALO_SIDE = LINES * FX_HALO_PX * 4;
  static constexpr int F32_BYTES = HALO_OFF + (KS == 3 ? 2 * HALO_SIDE : 0);
  // 3x3: 2 x 54 KB + 2 x 27 KB; 1x1: 4 x 10 KB + 4 x 16 KB (more f32 stages
  // leave L1 less room for the residual loads in flight and ran slower)
  static constexpr int BF_STAGES = KS == 3 ? 2 : 4;
  static constexpr int F32_STAGES = KS == 3 ? 2 : 4;
  static constexpr int F32_BASE = BF_STAGES * BF_BYTES;
  static constexpr int SMEM = F32_BASE + F32_STAGES * F32_BYTES + 1024;  // + alignment slack
  static_assert(BF_BYTES % 1024 == 0, "bf16 stages keep the 1024-byte swizzle alignment");
  static_assert(F32_BYTES % 128 == 0, "f32 stages are 128-byte aligned TMA destinations");
  static_assert(SMEM <= 232448, "fits the 227 KB a block may use");
};

// Round one chunk: f32 stage ``f`` -> the bf16 stage's B buffers at ``b``.
// A warp takes two lines (channel c of slab row r) a step, a half-warp a
// line, a lane 4 pixels: one 16-byte load, one 8-byte store a buffer.
template <int KS>
__device__ __forceinline__ void fast_round(const float* __restrict__ f, uint8_t* b, int cw,
                                           int lane, bool left, bool right) {
  using C = FxCfg<KS>;
  const int l = lane % 16;
#pragma unroll 2
  for (int pi = cw; pi < C::LINES / 2; pi += FX_CONVERTERS) {
    const int line = 2 * pi + lane / 16, c = line % TC_CI;
    const float4 v = *reinterpret_cast<const float4*>(f + line * TC_COLS + 4 * l);
    // 8-pixel chunk l / 2 of the 128-byte line sits at (l / 2) ^ (c % 8)
    const int off =
        (line / TC_CI) * ROW_BYTES + c * 128 + (((l >> 1) ^ (c & 7)) << 4) + ((l & 1) << 3);
    *reinterpret_cast<uint2*>(b + off) =
        make_uint2(hopper::pack_bf16x2(v.x, v.y), hopper::pack_bf16x2(v.z, v.w));
    if constexpr (KS == 3) {
      float prev = __shfl_up_sync(~0u, v.w, 1, 16), next = __shfl_down_sync(~0u, v.x, 1, 16);
      const float* h = f + C::HALO_OFF / 4 + line * FX_HALO_PX;
      if (l == 0) prev = left ? h[FX_HALO_PX - 1] : 0.f;
      if (l == 15) next = right ? h[C::HALO_SIDE / 4] : 0.f;
      *reinterpret_cast<uint2*>(b + C::SHIFT0 + off) =
          make_uint2(hopper::pack_bf16x2(prev, v.x), hopper::pack_bf16x2(v.y, v.z));
      *reinterpret_cast<uint2*>(b + C::SHIFT2 + off) =
          make_uint2(hopper::pack_bf16x2(v.y, v.z), hopper::pack_bf16x2(v.w, next));
    }
  }
}

// The fragment's output (the bf16 kernel's epilogue layout): acc[4i + 2j +
// c] is channel ct*64 + 16*(warp%4) + lane/4 + 8j, row y0 + 2wg + i/8,
// column x0 + 8*(i%8) + 2*(lane%4) + c.
struct FxFrag {
  int co0, y0, x0;  // this thread's first channel, row and column
  __device__ FxFrag(const Tile& tl, int warp, int lane, int wg)
      : co0(tl.ct * TC_CO + 16 * (warp % 4) + lane / 4),
        y0(tl.y0 + wg * (TC_ROWS / TC_CONSUMERS)),
        x0(tl.x0 + 2 * (lane % 4)) {}
};

// The f32 residual of this thread's fragment, into registers (0 outside the
// output). VEC: W even, so each pixel pair is one 8-byte load.
template <bool VEC>
__device__ __forceinline__ void fast_residual(float (&r)[64], const float* __restrict__ res,
                                              const FxFrag& fr, int b, int H, int W, int Cout) {
  const long long HW = (long long)H * W;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int co = fr.co0 + 8 * j;
    const float* rp = res + ((long long)b * Cout + (co < Cout ? co : 0)) * HW;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int y = fr.y0 + i / 8, x = fr.x0 + 8 * (i % 8);
      const bool ok = co < Cout && y < H && x < W;
      const float* q = rp + (ok ? y * W + x : 0);
      float2 v = make_float2(0.f, 0.f);
      if (VEC) {
        if (ok) v = __ldg(reinterpret_cast<const float2*>(q));
      } else {
        if (ok) v.x = __ldg(q);
        if (ok && x + 1 < W) v.y = __ldg(q + 1);
      }
      r[4 * i + 2 * j] = v.x;
      r[4 * i + 2 * j + 1] = v.y;
    }
  }
}

// The epilogue of this thread's fragment in the TPU order: + bias, +
// pre_add, x out_scale, abs-form LeakyReLU (LRELU), + residual (RES). One
// short straight run of code per (VEC, LRELU, RES): the kernel picks it by
// a uniform branch, so the instructions a tile executes stay few and
// contiguous (the split epilogue's every path in one unrolled body is 9.3k
// SASS instructions, and fetching them costs the fast conv ~0.1 ms a call).
template <bool VEC, bool LRELU, bool RES>
__device__ __forceinline__ void fast_epilogue(float (&acc)[64], const float (&r)[RES ? 64 : 1],
                                              const FxFrag& fr, int b, int H, int W, int Cout,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ pre,
                                              const float* __restrict__ scale, long long s_bstride,
                                              float la, float lb, float* __restrict__ out) {
  const long long HW = (long long)H * W;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int co = fr.co0 + 8 * j;
    const bool cok = co < Cout;
    const int cc = cok ? co : 0;
    const long long plane = ((long long)b * Cout + cc) * HW;
    float bv = bias ? bias[cc] : 0.f;
    const float sv = scale ? scale[b * s_bstride + cc] : 1.f;
    if (pre) {  // v = (acc + bias) + pre_add, ahead of the main run (off the main path)
#pragma unroll 1
      for (int i = 0; i < 16; ++i) {
        const int y = fr.y0 + i / 8, x = fr.x0 + 8 * (i % 8);
        const long long o = plane + (long long)y * W + x;
        const bool ok = cok && y < H && x < W;
        const float p0 = ok ? pre[o] : 0.f, p1 = ok && x + 1 < W ? pre[o + 1] : 0.f;
        // a runtime index into acc would move it to local memory: select
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m == i) {
            acc[4 * m + 2 * j] = (acc[4 * m + 2 * j] + bv) + p0;
            acc[4 * m + 2 * j + 1] = (acc[4 * m + 2 * j + 1] + bv) + p1;
          }
        }
      }
      bv = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int y = fr.y0 + i / 8, x = fr.x0 + 8 * (i % 8);
      const bool ok = cok && y < H && x < W;
      float* o = out + plane + (ok ? y * W + x : 0);
      float v[2] = {acc[4 * i + 2 * j] + bv, acc[4 * i + 2 * j + 1] + bv};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        v[c] *= sv;
        if (LRELU) v[c] = la * v[c] + lb * fabsf(v[c]);
        if (RES) v[c] += r[4 * i + 2 * j + c];
      }
      if (VEC) {
        if (ok) *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      } else {
        if (ok) o[0] = v[0];
        if (ok && x + 1 < W) o[1] = v[1];
      }
    }
  }
}

// Persistent, one block per SM walking tiles i, i + gridDim.x, ... (64
// output channels x 4 rows x 64 columns). Warps 0-7: two consumer
// warpgroups (2 rows each, as the bf16 kernel's); warp 8: the producer
// (TMA of the f32 chunks); warps 9-11: the converters. The epilogue in f32,
// in the TPU order: + bias, + pre_add, x out_scale, abs-form LeakyReLU, +
// residual (RES); null pointers switch a term off.
template <int KS, bool RES>
__global__ void __launch_bounds__(FX_THREADS, 1)
conv_fast_kernel(const __grid_constant__ FastParts parts, int nchunk, int ntiles, int nx, int ny,
                 int nct, int H, int W, int Cout, const __nv_bfloat16* __restrict__ wpk,
                 long long w_bstride, const float* __restrict__ bias,
                 const float* __restrict__ pre, const float* __restrict__ scale,
                 long long s_bstride, int lrelu, float la, float lb,
                 const float* __restrict__ res, float* __restrict__ out) {
  using C = FxCfg<KS>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // f_full: a chunk's f32 copies landed; f_empty: the converters are done
  // with it; full: a bf16 stage is built and its weights landed; empty: the
  // consumers are done with it
  __shared__ __align__(8) uint64_t f_full[C::F32_STAGES], f_empty[C::F32_STAGES];
  __shared__ __align__(8) uint64_t full[C::BF_STAGES], empty[C::BF_STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* f32s = smem + C::F32_BASE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = __shfl_sync(~0u, static_cast<int>(threadIdx.x) / 128, 0);  // warp-uniform

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::F32_STAGES; ++s) {
      mbar_init(&f_full[s], 1);              // the producer's expect_tx
      mbar_init(&f_empty[s], FX_CONVERTERS);  // one per converter warp
    }
    for (int s = 0; s < C::BF_STAGES; ++s) {
      mbar_init(&full[s], FX_CONVERTERS + 1);  // the converter warps and the weights' expect_tx
      mbar_init(&empty[s], TC_CONSUMERS * 4);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == TC_CONSUMERS) {
    setmaxnreg_dec<FX_OTHER_REGS>();
    int fs = 0;
    uint32_t fph = 0;
    if (warp == FX_PRODUCER_WARP) {
      // one thread issues each chunk's copies (TMA takes warp-uniform
      // operands): the slab and the halo boxes that are inside the image
      if (lane != 0) return;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of(t, nx, ny, nct);
        const bool left = KS == 3 && tl.x0 > 0, right = KS == 3 && tl.x0 + TC_COLS < W;
        const uint32_t bytes = C::HALO_OFF + (int(left) + int(right)) * C::HALO_SIDE;
        const int y = tl.y0 - C::HALO;
        for (int p = 0; p < parts.n; ++p) {
          for (int c0 = 0; c0 < parts.c[p]; c0 += TC_CI) {
            mbar_wait(&f_empty[fs], fph ^ 1);
            mbar_arrive_expect_tx(&f_full[fs], bytes);
            uint8_t* st = f32s + fs * C::F32_BYTES;
            tma_load_4d(st, &parts.center[p], &f_full[fs], tl.x0, c0, y, tl.b);
            if (left)
              tma_load_4d(st + C::HALO_OFF, &parts.halo[p], &f_full[fs], tl.x0 - FX_HALO_PX, c0,
                          y, tl.b);
            if (right)
              tma_load_4d(st + C::HALO_OFF + C::HALO_SIDE, &parts.halo[p], &f_full[fs],
                          tl.x0 + TC_COLS, c0, y, tl.b);
            if (++fs == C::F32_STAGES) {
              fs = 0;
              fph ^= 1;
            }
          }
        }
      }
      return;
    }
    // converters: per chunk, a free bf16 stage (its weights by one bulk
    // copy), then the landed f32 chunk rounded into it
    const int cw = warp - FX_PRODUCER_WARP - 1;
    int bs = 0;
    uint32_t bph = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(t, nx, ny, nct);
      const bool left = KS == 3 && tl.x0 > 0, right = KS == 3 && tl.x0 + TC_COLS < W;
      const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(
          wpk + tl.b * w_bstride + (long long)tl.ct * nchunk * C::KK * TC_CO * TC_CI);
      for (int k = 0; k < nchunk; ++k) {
        mbar_wait(&empty[bs], bph ^ 1);
        uint8_t* bst = smem + bs * C::BF_BYTES;
        if (cw == 0 && lane == 0) {
          mbar_arrive_expect_tx(&full[bs], C::W_BYTES);
          bulk_load(bst + C::W_OFF, wsrc + (long long)k * C::W_BYTES, C::W_BYTES, &full[bs]);
        }
        mbar_wait(&f_full[fs], fph);
        fast_round<KS>(reinterpret_cast<const float*>(f32s + fs * C::F32_BYTES), bst, cw, lane,
                       left, right);
        // the generic-proxy writes must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&f_empty[fs]);
          mbar_arrive(&full[bs]);
        }
        if (++fs == C::F32_STAGES) {
          fs = 0;
          fph ^= 1;
        }
        if (++bs == C::BF_STAGES) {
          bs = 0;
          bph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroups: wg takes output rows y0 + 2*wg, y0 + 2*wg + 1 of
  // each tile
  setmaxnreg_inc<FX_CONSUMER_REGS>();
  const int wg = wgi;
  int bs = 0;
  uint32_t bph = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(t, nx, ny, nct);
    const FxFrag fr(tl, warp, lane, wg);
    float r[RES ? 64 : 1];
    if constexpr (RES) {  // in flight under the tile's MMAs
      if (W & 1)
        fast_residual<false>(r, res, fr, tl.b, H, W, Cout);
      else
        fast_residual<true>(r, res, fr, tl.b, H, W, Cout);
    }
    float acc[64];
    int held = -1;  // the stage whose MMAs may still be running
    for (int k = 0; k < nchunk; ++k) {
      mbar_wait(&full[bs], bph);
      const uint32_t st = smem_u32(smem + bs * C::BF_BYTES);
      const uint32_t a0 = st + C::W_OFF;
      const uint32_t b0 = st + wg * (TC_ROWS / TC_CONSUMERS) * ROW_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const uint32_t buf = KS == 1 ? 0 : dx == 0 ? C::SHIFT0 : dx == 1 ? 0 : C::SHIFT2;
          const uint64_t da = make_desc(a0 + (dy * KS + dx) * TAP_BYTES, 128, 256, kInterleave);
          const uint64_t db = make_desc(b0 + buf + dy * ROW_BYTES, ROW_BYTES, 1024, kSwizzle128);
          // the tile's first product overwrites the accumulators
          wgmma_m64n128k16_bf16(acc, da, db, (k | (dy * KS + dx)) != 0);
        }
      }
      wgmma_commit();
      // keep this stage's MMAs in flight; release the one before it
      wgmma_wait<1>();
      fence_regs(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = bs;
      if (++bs == C::BF_STAGES) {
        bs = 0;
        bph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);

    if (W & 1) {
      if (lrelu)
        fast_epilogue<false, true, RES>(acc, r, fr, tl.b, H, W, Cout, bias, pre, scale,
                                        s_bstride, la, lb, out);
      else
        fast_epilogue<false, false, RES>(acc, r, fr, tl.b, H, W, Cout, bias, pre, scale,
                                         s_bstride, la, lb, out);
    } else if (lrelu) {
      fast_epilogue<true, true, RES>(acc, r, fr, tl.b, H, W, Cout, bias, pre, scale, s_bstride,
                                     la, lb, out);
    } else {
      fast_epilogue<true, false, RES>(acc, r, fr, tl.b, H, W, Cout, bias, pre, scale, s_bstride,
                                      la, lb, out);
    }
  }
}

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // a part's tensor map was refused

template <int KS>
int launch_wgmma(const TmaParts& parts, int nchunk, int B, int H, int W, int Cout, const void* wt,
                 long long w_bstride, const void* bias, const void* pre, const float* scale,
                 long long s_bstride, int lrelu, float la, float lb, const void* res, void* out,
                 cudaStream_t stream) {
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
      w_bstride, bias, pre, scale, s_bstride, lrelu, la, lb, res, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_split(const PairParts& parts, int nchunk, int B, int H, int W, int Cout, const void* wt,
                 long long w_bstride, const float* bias, const float* pre, const float* scale,
                 long long s_bstride, int lrelu, float la, float lb, const void* res,
                 const void* res_lo, void* out, void* out_lo, cudaStream_t stream) {
  using C = PairCfg<KS>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_split_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  conv_split_kernel<KS><<<grid, SP_THREADS, C::SMEM, stream>>>(
      parts, nchunk, ntiles, nx, ny, nct, H, W, Cout, static_cast<const __nv_bfloat16*>(wt),
      w_bstride, bias, pre, scale, s_bstride, lrelu, la, lb, res,
      static_cast<const __nv_bfloat16*>(res_lo), out, static_cast<__nv_bfloat16*>(out_lo));
  return static_cast<int>(cudaGetLastError());
}

// The two TMA maps of one bf16 tensor of channel planes (row pitch `pitch`
// elements, a multiple of 8; 16-byte aligned base and batch stride): the
// slab box and the halo box (TmaParts).
int encode_maps(hopper::EncodeTiledFn encode, CUtensorMap* center, CUtensorMap* halo,
                int ksize, const void* ptr, int ch, long long bstride, long long pitch, int B,
                int H, int W) {
  // (W, C, H, B): the strides need not grow with the dimension
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)ch, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pitch * H * 2, (cuuint64_t)pitch * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const cuuint32_t slab = TC_ROWS + ksize - 1;
  const cuuint32_t box_center[4] = {TC_COLS, TC_CI, slab, 1};
  const cuuint32_t box_halo[4] = {HALO_PX, TC_CI, slab, 1};
  void* base = const_cast<void*>(ptr);
  if (encode(center, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box_center, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(halo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box_halo, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  return 0;
}

// The f32 maps of one part (FastParts): rows at pitch ``pitch`` elements (a
// multiple of 4), 16-byte aligned base and batch stride.
int encode_f32_maps(hopper::EncodeTiledFn encode, CUtensorMap* center, CUtensorMap* halo,
                    int ksize, const void* ptr, int ch, long long bstride, long long pitch, int B,
                    int H, int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)ch, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pitch * H * 4, (cuuint64_t)pitch * 4,
                                 (cuuint64_t)bstride * 4};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const cuuint32_t slab = TC_ROWS + ksize - 1;
  const cuuint32_t box_center[4] = {TC_COLS, TC_CI, slab, 1};
  const cuuint32_t box_halo[4] = {FX_HALO_PX, TC_CI, slab, 1};
  void* base = const_cast<void*>(ptr);
  if (encode(center, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box_center, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  if (ksize == 3 &&
      encode(halo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box_halo, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  return 0;
}

template <int KS, bool RES>
int launch_fast(const FastParts& parts, int nchunk, int B, int H, int W, int Cout, const void* wt,
                long long w_bstride, const float* bias, const float* pre, const float* scale,
                long long s_bstride, int lrelu, float la, float lb, const float* res, float* out,
                cudaStream_t stream) {
  using C = FxCfg<KS>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_fast_kernel<KS, RES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int nct = (Cout + TC_CO - 1) / TC_CO;
  const int nx = (W + TC_COLS - 1) / TC_COLS, ny = (H + TC_ROWS - 1) / TC_ROWS;
  const int ntiles = nx * ny * nct * B;
  const int grid = ntiles < sms ? ntiles : sms;
  conv_fast_kernel<KS, RES><<<grid, FX_THREADS, C::SMEM, stream>>>(
      parts, nchunk, ntiles, nx, ny, nct, H, W, Cout, static_cast<const __nv_bfloat16*>(wt),
      w_bstride, bias, pre, scale, s_bstride, lrelu, la, lb, res, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  if (e == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (e == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a channel part's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// f32 on the CUDA cores (conv_f32_kernel). Null pointers switch an epilogue
// term off. Each part's channel planes are contiguous (row pitch W), with
// its own batch stride. The output is [B, Cout, Ho, Wo], Ho = H + 2 pad - K
// + 1 (likewise Wo), 0 <= pad <= K - 1. Weight element (b, tap, ci, co), tap
// = dy * K + dx, is at wt[b * w_b + w_off + tap * w_tap + ci * w_ci + co *
// w_co] (strides may be negative). The Cin reduction is cut into `nchunks`
// chunks of `chunk_stages` stages (ops/conv.py f32_chunks: a stage is CI
// channels of one part); with nchunks > 1, `partial` holds nchunks f32
// copies of the output.
extern "C" int savsr_conv_f32(int ksize, int nparts, const void* const* part_ptrs,
                              const int* part_ch, const long long* part_bstride, int B, int H,
                              int W, int pad, int Cout, const void* wt, long long w_b,
                              long long w_off, long long w_tap, long long w_ci, long long w_co,
                              const void* bias, const void* pre, const void* scale,
                              long long s_bstride, int lrelu, float la, float lb,
                              const void* res, void* out, void* partial, int nchunks,
                              int chunk_stages, void* stream) {
  if (nparts < 1 || nparts > MAXP || (ksize != 1 && ksize != 3) || pad < 0 || pad >= ksize ||
      B < 1 || Cout < 1 || (long long)B * Cout > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ci = ksize == 3 ? FCfg<3>::CI : FCfg<1>::CI;
  F32Conv a{};
  for (int i = 0; i < nparts; ++i) {
    if (part_ch[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.part[i] = static_cast<const float*>(part_ptrs[i]);
    a.c[i] = part_ch[i];
    a.bstride[i] = part_bstride[i];
    a.vec[i] = W % 4 == 0 && part_bstride[i] % 4 == 0 && aligned16(part_ptrs[i]);
    a.stages += (part_ch[i] + ci - 1) / ci;
  }
  a.n = nparts;
  a.B = B, a.H = H, a.W = W, a.Cout = Cout;
  a.Ho = H + 2 * pad - ksize + 1, a.Wo = W + 2 * pad - ksize + 1;
  if (nchunks < 1 || chunk_stages < 1 || (long long)(nchunks - 1) * chunk_stages >= a.stages ||
      (long long)nchunks * chunk_stages < a.stages || (nchunks > 1 && partial == nullptr) ||
      a.Ho < 1 || a.Wo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.wt = static_cast<const float*>(wt);
  a.w_b = w_b, a.w_off = w_off, a.w_tap = w_tap, a.w_ci = w_ci, a.w_co = w_co;
  a.w_vec = w_co == 1 && Cout % 4 == 0 && w_b % 4 == 0 && w_off % 4 == 0 && w_tap % 4 == 0 &&
            w_ci % 4 == 0 && aligned16(wt);
  a.nchunks = nchunks, a.chunk_stages = chunk_stages;
  a.bias = static_cast<const float*>(bias);
  a.pre = static_cast<const float*>(pre);
  a.scale = static_cast<const float*>(scale);
  a.s_bstride = s_bstride;
  a.lrelu = lrelu, a.la = la, a.lb = lb;
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.out_vec = a.Wo % 4 == 0 && aligned16(out) && aligned16(pre) && aligned16(res) &&
              (nchunks == 1 || aligned16(partial));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksize == 1) return static_cast<int>(launch_f32<1, 0>(a, s));
  return static_cast<int>(pad == 1 ? launch_f32<3, 1>(a, s)
                                   : pad == 0 ? launch_f32<3, 0>(a, s) : launch_f32<3, 2>(a, s));
}

// bf16 on the tensor cores (conv_wgmma_kernel). Null pointers switch an
// epilogue term off. part_pitch: each part's row pitch in elements, a
// multiple of 8, with 16-byte aligned base and batch stride, for TMA.
// Weights are packed as ops/conv.py pack_weight lays them out, w_bstride
// elements per sample.
extern "C" int savsr_conv_fused(int ksize, int nparts, const void* const* part_ptrs,
                                const int* part_ch, const long long* part_bstride,
                                const long long* part_pitch, int B, int H, int W, int Cout,
                                const void* wt, long long w_bstride, const void* bias,
                                const void* pre, const void* scale, long long s_bstride,
                                int lrelu, float la, float lb, const void* res, void* out,
                                void* stream) {
  if (nparts < 1 || nparts > MAXP || (ksize != 1 && ksize != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  TmaParts parts{};
  int nchunk = 0;
  for (int i = 0; i < nparts; ++i) {
    const int e = encode_maps(encode, &parts.center[i], &parts.halo[i], ksize, part_ptrs[i],
                              part_ch[i], part_bstride[i], part_pitch[i], B, H, W);
    if (e) return e;
    parts.c[i] = part_ch[i];
    nchunk += (part_ch[i] + TC_CI - 1) / TC_CI;
  }
  parts.n = nparts;
  return ksize == 3 ? launch_wgmma<3>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bias, pre, sc,
                                      s_bstride, lrelu, la, lb, res, out, s)
                    : launch_wgmma<1>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bias, pre, sc,
                                      s_bstride, lrelu, la, lb, res, out, s);
}

// The split conv on the tensor cores (conv_split_kernel<K>): npairs pairs,
// each two bf16 tensors of channel planes, hi at map_ptrs[2i] and lo at
// map_ptrs[2i + 1] (as for savsr_conv_fused: row pitch a multiple of 8,
// 16-byte aligned base and batch stride; the two of a pair of one channel
// count). Weights are packed as ops/conv.py pack_weight_pair lays them out
// (per chunk of 16 channels of a pair, the Whi then the Wlo taps),
// w_bstride elements per sample. bias, pre and scale are f32; res is the
// residual's hi plane and res_lo its lo plane, or, with res_lo null, an f32
// residual; out and out_lo the result's hi and lo planes, or, with out_lo
// null, out is the f32 result. Null pointers switch an epilogue term off.
extern "C" int savsr_conv_pair(int ksize, int npairs, const void* const* map_ptrs,
                               const int* map_ch, const long long* map_bstride,
                               const long long* map_pitch, int B, int H, int W, int Cout,
                               const void* wt, long long w_bstride, const void* bias,
                               const void* pre, const void* scale, long long s_bstride, int lrelu,
                               float la, float lb, const void* res, const void* res_lo, void* out,
                               void* out_lo, void* stream) {
  if (npairs < 1 || npairs > PAIR_MAX || (ksize != 1 && ksize != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  PairParts parts{};
  int nchunk = 0;
  for (int i = 0; i < npairs; ++i) {
    if (map_ch[2 * i] < 1 || map_ch[2 * i + 1] != map_ch[2 * i])
      return static_cast<int>(cudaErrorInvalidValue);
    for (int m = 2 * i; m < 2 * i + 2; ++m) {
      const int e = encode_maps(encode, &parts.center[m], &parts.halo[m], ksize, map_ptrs[m],
                                map_ch[m], map_bstride[m], map_pitch[m], B, H, W);
      if (e) return e;
    }
    parts.c[i] = map_ch[2 * i];
    nchunk += (parts.c[i] + TC_CI - 1) / TC_CI;
  }
  parts.n = npairs;
  const float* bi = static_cast<const float*>(bias);
  const float* pr = static_cast<const float*>(pre);
  const float* sc = static_cast<const float*>(scale);
  return ksize == 3 ? launch_split<3>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                      s_bstride, lrelu, la, lb, res, res_lo, out, out_lo, s)
                    : launch_split<1>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                      s_bstride, lrelu, la, lb, res, res_lo, out, out_lo, s);
}

// The fast conv on the tensor cores (conv_fast_kernel): f32 parts (row pitch
// a multiple of 4 elements, 16-byte aligned base and batch stride, for TMA),
// rounded to bf16 in the kernel, against the bf16 weight packed as
// ops/conv.py pack_weight_fast lays it out (w_bstride elements per sample);
// f32 bias, pre, scale, res and out [B, Cout, H, W]. Null pointers switch an
// epilogue term off.
extern "C" int savsr_conv_fast(int ksize, int nparts, const void* const* part_ptrs,
                               const int* part_ch, const long long* part_bstride,
                               const long long* part_pitch, int B, int H, int W, int Cout,
                               const void* wt, long long w_bstride, const void* bias,
                               const void* pre, const void* scale, long long s_bstride,
                               int lrelu, float la, float lb, const void* res, void* out,
                               void* stream) {
  if (nparts < 1 || nparts > FAST_MAPS || (ksize != 1 && ksize != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  FastParts parts{};
  int nchunk = 0;
  for (int i = 0; i < nparts; ++i) {
    const int e = encode_f32_maps(encode, &parts.center[i], &parts.halo[i], ksize, part_ptrs[i],
                                  part_ch[i], part_bstride[i], part_pitch[i], B, H, W);
    if (e) return e;
    parts.c[i] = part_ch[i];
    nchunk += (part_ch[i] + TC_CI - 1) / TC_CI;
  }
  parts.n = nparts;
  const float* bi = static_cast<const float*>(bias);
  const float* pr = static_cast<const float*>(pre);
  const float* sc = static_cast<const float*>(scale);
  const float* rs = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  if (ksize == 3)
    return rs ? launch_fast<3, true>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                     s_bstride, lrelu, la, lb, rs, o, s)
              : launch_fast<3, false>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                      s_bstride, lrelu, la, lb, rs, o, s);
  return rs ? launch_fast<1, true>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                   s_bstride, lrelu, la, lb, rs, o, s)
            : launch_fast<1, false>(parts, nchunk, B, H, W, Cout, wt, w_bstride, bi, pr, sc,
                                    s_bstride, lrelu, la, lb, rs, o, s);
}
