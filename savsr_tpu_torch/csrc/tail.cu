// Fused tail — kernel 5 of the serving path.
//
// Replaces savsr_tpu/ops/pallas/tail_kernel.py::tail_fused. Per HR pixel
// (Y, X) and output channel k (3 of them):
//     conv = bias[k] + sum_{c,dy,dx} Wt[k, c, dy, dx] * sr[c, Y+dy-1, X+dx-1]   (zeros outside)
//     lr_j = wy[Y] * xc[k, j0[Y], j] + (1 - wy[Y]) * xc[k, j0[Y]+1, j]          (rounded to T)
//     up   = cw0[X] * lr_{c0[X]} + cw1[X] * lr_{c0[X]+1}                        (weights in T)
//     out  = conv + up
// i.e. the 3x3 C->3 tail conv plus the bilinear (align_corners=False)
// upsampled centre frame, from the <=2 nonzeros per row and per column of
// the resize matrices (row starts clipped to h0-2, column starts to w0-2).
//
// Bound on the H100: 2*27*C FLOPs per HR pixel against C values read and 3
// written: ~13 FLOP per byte in f32 — near the ridge, so the time floor is
// the read of sr; in bf16 (27 FLOP per byte, 989 TFLOP/s) bound by that
// read. Two kernels:
//
// * f32 (tail_f32_kernel<ROUND>, CUDA cores, true f32; also bf16 at channel
//   counts the tensor-core kernel does not take, widened to f32 by the
//   wrapper, with ROUND: sr as it is loaded, the row-mixed centre frame and
//   the column weights rounded to bf16, the output rounded once by the
//   wrapper; and the fast tier, f32 sr with ROUND and the weights packed
//   from their bf16 values: the TPU kernel's one bf16 pass, f32 output). At C = 64 and 8
//   x 720x1280 the read of sr (1.89 GB, 0.56 ms) and the 27 C FMAs a pixel
//   (12.7 G, 0.38 ms at the FP32 rate) are close, so the design keeps both
//   going at once. On the CUDA cores the rate of shared-memory load
//   instructions paces a kernel (the kernel this one replaced made 36
//   scalar loads for 27 FMAs), so each thread computes a register tile of 4
//   rows x 8 columns x 3 outputs (96 sums): per staged channel it loads the
//   channel's 27 weights as 7 16-byte broadcasts and, per one of its 6 input
//   rows, two 16-byte pieces and one edge value, and shuffles for its
//   neighbours' columns, for 864 FMAs (25 shared loads). Persistent blocks,
//   one per SM (8 warps, a warp per 4 rows of a 32 x 256 tile), walk their
//   tiles channel by channel; each stage (the channel's 34 x 264 window of
//   the tile as two TMA boxes, zero filled outside the image, and its packed
//   weights, ops/tail.py pack_tail_weights_f32, by one bulk copy) lands 2
//   stages ahead of its use in a ring of 3, across tile boundaries, issued
//   by one thread: per-thread cp.async copies of the same stages streamed
//   sr at half the card's read rate. Tiles go row band first, so the blocks
//   at work at one time hold neighbouring tiles and read a halo row from
//   device memory once between them. C has no cap (the weights stream with
//   the channels). At a tile's end the bias and the skip (from the centre
//   frame, through L1/L2) are added to the sums, as the reference adds them
//   (summed from zero, the taps keep the rounding of their own magnitude),
//   and the outputs stored 16 bytes at a time.
//
// * bf16 (tail_mma_kernel, tensor cores): pixels as the MMA's M, on
//   mma.sync m16n8k16 with f32 accumulators. Per tap row dy the kernel
//   multiplies each row of sr by B_dy[C, 16] (column 3 dx + k: the three dx
//   taps of the three outputs, 7 zero columns; ops/tail.py
//   pack_tail_weights) into P, and shifts afterwards: out[k, y, x] = sum over
//   dx of P[y, x + dx - 1][3 dx + k] + bias + skip. So every A fragment is
//   16 staged pixels that start on a 16-byte boundary: a one-pixel tap shift
//   on the operand would break the alignment that ldmatrix (like a TMA box or
//   a wgmma descriptor) needs. A block owns a 64-pixel column strip of one
//   sample over a run of rows and walks down it two output rows at a time;
//   TMA brings each row of the strip (x0 - 8 .. x0 + 71, all channels, the
//   zero fill outside the image being the conv's padding) as one NCHW box
//   into a ring of 6 rows guarded by mbarriers, 4 rows ahead of the rows in
//   use, so each row of sr is read from device memory once (plus the run's
//   two halo rows) with no thread spending registers on the copy; ldmatrix
//   .trans turns the [channel][pixel] rows into A fragments. Five warps take
//   the 80 staged pixels; P goes through shared memory to the per-pixel
//   epilogue, whose skip terms (the centre frame's rows and columns) are
//   computed an iteration ahead.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // the tensor map was refused

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TF_WARPS = 8, TF_THREADS = 32 * TF_WARPS;
constexpr int TF_R = 4;                 // output rows of a thread (and of a warp)
constexpr int TF_X = 8;                 // output columns of a thread: x0 + 4 lane + 0..3, + 128
constexpr int TF_TH = TF_WARPS * TF_R;  // 32 tile rows
constexpr int TF_TW = 256;              // tile columns
constexpr int TF_SR = TF_TH + 2;        // staged rows: the tile's and two halo rows
constexpr int TF_BW = TF_TW / 2 + 8;    // a box's columns: x0 - 4 .. x0 + 131 (A), x0 + 124 .. (B)
constexpr int TF_BOX = TF_SR * TF_BW;   // floats of a box
constexpr int TF_B_OFF = (TF_BOX + 31) / 32 * 32;  // box B, 128-byte aligned (TMA)
constexpr int TF_W_OFF = TF_B_OFF + TF_BOX;        // the channel's weights
constexpr int TF_WSLOTS = 28;           // a channel's 27 weights, padded to 7 x 16 bytes
constexpr int TF_STAGE = (TF_W_OFF + TF_WSLOTS + 31) / 32 * 32;  // floats of a stage
constexpr int TF_STAGES = 3;          // (4 and 6 were slower: less L1 left for the epilogue)
constexpr int TF_SMEM = TF_STAGES * TF_STAGE * 4;
constexpr uint32_t TF_TX = (2 * TF_BOX + TF_WSLOTS) * 4;  // bytes landing per stage
static_assert(TF_W_OFF % 4 == 0 && (TF_BW * 4) % 16 == 0, "16-byte copies");

// The products of one staged channel: warp w's output rows 4w .. 4w + 3 take
// staged rows 4w .. 4w + 5. Per staged row a lane loads its two 4-column
// pieces (box A column 4 lane + 4 and box B's: consecutive 16-byte pieces
// across the lanes, no bank conflict) and the row's edge value (x0 - 1 for
// lanes 0..15, x0 + 256 for 16..31: two addresses a warp), and takes its
// neighbours' columns by shuffles: its two 6-value windows. They go, times
// the row's taps, into the sums of the up to 3 output rows that read the
// row; per output its sum takes the taps in (dy, dx) order. ROUND: the
// values of sr rounded to bf16 as they are loaded (the conv's operand in the
// TPU kernel's one bf16 pass; a no-op on the widened bf16 route).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool ROUND>
__device__ __forceinline__ void tf_channel(float (&acc)[TF_R][TF_X][3], const float* st, int warp,
                                           int lane) {
  float w[TF_WSLOTS];
  const float4* wq = reinterpret_cast<const float4*>(st + TF_W_OFF);
#pragma unroll
  for (int i = 0; i < TF_WSLOTS / 4; ++i) {
    const float4 v = wq[i];
    w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
  }
  const float* ra = st + TF_R * warp * TF_BW + 4 * lane + 4;
  const float* rb = ra + TF_B_OFF;
  const float* re = st + TF_R * warp * TF_BW + (lane < 16 ? 3 : TF_B_OFF + TF_BW - 4);
  const int up = (lane + 31) & 31, down = (lane + 1) & 31;
#pragma unroll
  for (int r = 0; r < TF_R + 2; ++r) {
    float4 a = *reinterpret_cast<const float4*>(ra + r * TF_BW);
    float4 q = *reinterpret_cast<const float4*>(rb + r * TF_BW);
    float e = re[r * TF_BW];
    if constexpr (ROUND) {
      a = make_float4(round_bf16(a.x), round_bf16(a.y), round_bf16(a.z), round_bf16(a.w));
      q = make_float4(round_bf16(q.x), round_bf16(q.y), round_bf16(q.z), round_bf16(q.w));
      e = round_bf16(e);
    }
    const float al = __shfl_sync(~0u, a.w, up);
    const float ar = __shfl_sync(~0u, lane == 0 ? q.x : a.x, down);
    const float bl = __shfl_sync(~0u, lane == 31 ? a.w : q.w, up);
    const float br = __shfl_sync(~0u, q.x, down);
    const float v[2][6] = {{lane == 0 ? e : al, a.x, a.y, a.z, a.w, ar},
                           {bl, q.x, q.y, q.z, q.w, lane == 31 ? e : br}};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int o = r - dy;
      if (o < 0 || o >= TF_R) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int j = 0; j < TF_X; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc[o][j][k] = fmaf(w[9 * dy + 3 * dx + k], v[j >> 2][(j & 3) + dx], acc[o][j][k]);
    }
  }
}

// 4 outputs of a row at columns x .. x + 3: one 16-byte store where the
// rows are 16-byte aligned (W % 4 == 0) and all 4 are in the image, else
// those in it one by one.
__device__ __forceinline__ void tf_put4(float* dst, const float* v, int x, int W) {
  if ((W & 3) == 0 && x + 4 <= W) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < W) dst[j] = v[j];
  }
}

// At the tile's end: out = (the conv's sums + bias) + skip for the thread's
// pixels in the image (the reference's order: the conv's taps summed from
// zero keep the rounding of their own small magnitude). Column j of the
// thread: xa + 128 (j / 4) + j % 4. ROUND (the bf16 tier on this kernel):
// the row-mixed centre frame and the column weights rounded to bf16, as the
// plain version does.
template <bool ROUND>
__device__ __forceinline__ void tf_epilogue(const float (&acc)[TF_R][TF_X][3],
                                            const float* __restrict__ bias,
                                            const float* __restrict__ xc,
                                            const int* __restrict__ rj0,
                                            const float* __restrict__ rwy,
                                            const int* __restrict__ cj0,
                                            const float* __restrict__ cw, float* __restrict__ out,
                                            int b, int y, int xa, int H, int W, int h0, int w0) {
  int c0[TF_X];
  float cw0[TF_X], cw1[TF_X];
#pragma unroll
  for (int j = 0; j < TF_X; ++j) {
    const int x = xa + 128 * (j >> 2) + (j & 3);
    const bool in = x < W;
    c0[j] = in ? cj0[x] : 0;
    cw0[j] = in ? cw[x] : 0.f;
    cw1[j] = in ? cw[W + x] : 0.f;
    if constexpr (ROUND) cw0[j] = round_bf16(cw0[j]), cw1[j] = round_bf16(cw1[j]);
  }
  const float* xcb = xc + (long long)b * 3 * h0 * w0;
#pragma unroll
  for (int o = 0; o < TF_R; ++o) {
    const int Y = y + o;
    if (Y >= H) break;
    const int j0 = rj0[Y];
    const float wy0 = rwy[Y], wy1 = 1.f - wy0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* p = xcb + ((long long)k * h0 + j0) * w0;
      const float bk = bias[k];
      float v[TF_X];
#pragma unroll
      for (int j = 0; j < TF_X; ++j) {
        float l0 = wy0 * p[c0[j]] + wy1 * p[w0 + c0[j]];
        float l1 = wy0 * p[c0[j] + 1] + wy1 * p[w0 + c0[j] + 1];
        if constexpr (ROUND) l0 = round_bf16(l0), l1 = round_bf16(l1);
        v[j] = (acc[o][j][k] + bk) + (cw0[j] * l0 + cw1[j] * l1);
      }
      float* dst = out + (((long long)b * 3 + k) * H + Y) * W + xa;
      tf_put4(dst, v, xa, W);
      tf_put4(dst + 128, v + 4, xa + 128, W);
    }
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (tile: row band
// fastest, then column band, then sample, so the blocks at work at one time
// hold neighbouring tiles and share their halo rows through L2). Its stages,
// one per (tile, channel), run through a ring of TF_STAGES buffers, which
// thread 0 fills TF_STAGES - 1 stages ahead, across tile boundaries: per
// stage two TMA boxes of the channel (34 rows x 136 columns each, zero fill
// outside the image: the conv's padding) and a bulk copy of its packed
// weights, all completing on the slot's mbarrier. One barrier a stage.
// Thread (warp w, lane i): output rows y0 + 4w .. + 3, columns x0 + 4i .. +
// 3 and x0 + 128 + 4i .. + 3.
template <bool ROUND>
__global__ void __launch_bounds__(TF_THREADS, 1)
tail_f32_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ xc,
                const float* __restrict__ wpk, const int* __restrict__ rj0,
                const float* __restrict__ rwy, const int* __restrict__ cj0,
                const float* __restrict__ cw, float* __restrict__ out, int B, int C, int H,
                int W, int h0, int w0) {
  extern __shared__ __align__(128) float tsm[];
  __shared__ __align__(8) uint64_t full[TF_STAGES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_y = (H + TF_TH - 1) / TF_TH, tiles_x = (W + TF_TW - 1) / TF_TW;
  const int ntiles = B * tiles_x * tiles_y;
  const int mine = (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // thread 0's next stage to issue: channel q[1] of the block's tile number
  // q[0], which starts at sample q[2], row q[3], column q[4] (in shared
  // memory: no thread keeps registers for it)
  __shared__ int q[5];
  auto issue = [&](int slot) {
    int it_i = q[0], ic = q[1];
    if (it_i >= mine) return;
    if (ic == 0) {
      const int tile = blockIdx.x + it_i * gridDim.x, rest = tile / tiles_y;
      q[2] = rest / tiles_x, q[3] = (tile % tiles_y) * TF_TH, q[4] = (rest % tiles_x) * TF_TW;
    }
    const int pb = q[2], py0 = q[3], px0 = q[4];
    float* st = tsm + slot * TF_STAGE;
    mbar_arrive_expect_tx(&full[slot], TF_TX);
    tma_load_4d(st, &map, &full[slot], px0 - 4, py0 - 1, ic, pb);
    tma_load_4d(st + TF_B_OFF, &map, &full[slot], px0 + TF_TW / 2 - 4, py0 - 1, ic, pb);
    bulk_load(st + TF_W_OFF, wpk + (long long)ic * TF_WSLOTS, TF_WSLOTS * 4, &full[slot]);
    if (++ic == C) ic = 0, ++it_i;
    q[0] = it_i, q[1] = ic;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    q[0] = 0, q[1] = 0;
    for (int s = 0; s < TF_STAGES - 1; ++s) issue(s);
  }

  int slot = 0;
  uint32_t phase = 0;  // stage n: slot n % TF_STAGES, parity (n / TF_STAGES) & 1
  for (int it = 0; it < mine; ++it) {
    const int tile = blockIdx.x + it * gridDim.x, rest = tile / tiles_y;
    const int b = rest / tiles_x;
    const int y = (tile % tiles_y) * TF_TH + TF_R * warp, xa = (rest % tiles_x) * TF_TW + 4 * lane;
    const bool active = y < H;  // the warp has rows in the image
    float acc[TF_R][TF_X][3];
#pragma unroll
    for (int o = 0; o < TF_R; ++o)
#pragma unroll
      for (int j = 0; j < TF_X; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[o][j][k] = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      __syncthreads();  // every warp is done with the previous stage's slot (and, first, the
                        // barriers are initialised)
      if (threadIdx.x == 0) issue(slot == 0 ? TF_STAGES - 1 : slot - 1);
      mbar_wait(&full[slot], phase);
      if (active) tf_channel<ROUND>(acc, tsm + slot * TF_STAGE, warp, lane);
      if (++slot == TF_STAGES) slot = 0, phase ^= 1;
    }
    if (active)
      tf_epilogue<ROUND>(acc, wpk + (long long)C * TF_WSLOTS, xc, rj0, rwy, cj0, cw, out, b, y, xa,
                         H, W, h0, w0);
  }
}

template <bool ROUND>
int launch_f32(const void* sr, long long pitch, const void* xc, const void* wpk, const int* rj0,
               const float* rwy, const int* cj0, const float* cw, void* out, int B, int C, int H,
               int W, int h0, int w0, int sms, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_f32_kernel<ROUND>, cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  // (W, H, C, B), so that a box of 34 rows of one channel lands as [34][TF_BW]
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pitch * 4, (cuuint64_t)pitch * H * 4,
                                 (cuuint64_t)pitch * H * C * 4};
  const cuuint32_t box[4] = {TF_BW, TF_SR, 1, 1}, elem[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(sr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  const long long ntiles =
      (long long)B * ((H + TF_TH - 1) / TF_TH) * ((W + TF_TW - 1) / TF_TW);
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  tail_f32_kernel<ROUND><<<grid, TF_THREADS, TF_SMEM, stream>>>(
      map, static_cast<const float*>(xc), static_cast<const float*>(wpk), rj0, rwy, cj0, cw,
      static_cast<float*>(out), B, C, H, W, h0, w0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on mma.sync over channels-innermost row slabs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TL_STRIP = 64;             // output pixels per strip
constexpr int TL_BOX = TL_STRIP + 16;     // staged pixels: x0 - 8 .. x0 + TL_STRIP + 7
constexpr int TL_MT = TL_BOX / 16;        // m16 tiles over the staged pixels
constexpr int TL_THREADS = TL_MT * 32;    // a warp per m16 tile
constexpr int TL_ITEM_THREADS = 2 * TL_STRIP;  // threads of the per-pixel work (skip, outputs)
constexpr int TL_RING = 6;                // staged rows
constexpr int TL_NP = 9;                  // P columns: 3 dx x 3 outputs

template <int CB>  // C = 16 * CB
struct TailCfg {
  static constexpr int C = 16 * CB;
  static constexpr int ROW = C * TL_BOX * 2;            // a staged row: [C][TL_BOX] bf16
  static constexpr int OFF_W = TL_RING * ROW;           // B fragments, [dy][kb][n-tile][lane] x 8 B
  // P, [2 iterations][2 rows][TL_BOX][TL_NP] f32
  static constexpr int OFF_P = OFF_W + 3 * CB * 2 * 256;
  static constexpr int OFF_UP = OFF_P + 2 * 2 * TL_BOX * TL_NP * 4;  // skip, [2][2][3][TL_STRIP]
  static constexpr int SMEM = OFF_UP + 2 * 2 * 3 * TL_STRIP * 4;
  static_assert(ROW % 128 == 0, "TMA destinations");
};

// The per-pixel work of two output rows: item i (of 2 x 3 x TL_STRIP) is
// pixel i % TL_STRIP, output i / TL_STRIP % 3, row i / (3 TL_STRIP); thread
// t < TL_ITEM_THREADS takes items t, t + TL_ITEM_THREADS, t + 2
// TL_ITEM_THREADS, all of pixel t % TL_STRIP. The skip terms are computed an
// iteration ahead into shared memory, their row data (start row, weight)
// loaded an iteration before the centre-frame values.
constexpr int SKIP_ITEMS = 3;
struct Skip {
  int c0;           // the pixel's first column, and its bf16-rounded weights
  float cw0, cw1;
  bool ok;
  int j0[2];        // the next two rows' first source rows and weights
  float wy[2];
  float v[SKIP_ITEMS][4];  // xc[j0][c0], xc[j0][c0+1], xc[j0+1][c0], xc[j0+1][c0+1]
  float wl[2];      // the weights of the rows v holds
};

__device__ __forceinline__ void skip_rows(Skip& s, int y, int H, const int* __restrict__ rj0,
                                          const float* __restrict__ rwy) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = y + r < H;
    s.j0[r] = in ? rj0[y + r] : 0;
    s.wy[r] = in ? rwy[y + r] : 0.f;
  }
}

__device__ __forceinline__ void skip_load(Skip& s, const bf16* __restrict__ xcb, int h0, int w0) {
  if (!s.ok) return;
  const long long hw0 = (long long)h0 * w0;
  s.wl[0] = s.wy[0];
  s.wl[1] = s.wy[1];
#pragma unroll
  for (int i = 0; i < SKIP_ITEMS; ++i) {
    const int item = threadIdx.x + TL_ITEM_THREADS * i;
    const int k = item / TL_STRIP % 3, r = item / (3 * TL_STRIP);
    const unsigned short* p = reinterpret_cast<const unsigned short*>(xcb) + k * hw0 +
                              (long long)(r ? s.j0[1] : s.j0[0]) * w0 + s.c0;
    s.v[i][0] = __uint_as_float((uint32_t)p[0] << 16);
    s.v[i][1] = __uint_as_float((uint32_t)p[1] << 16);
    s.v[i][2] = __uint_as_float((uint32_t)p[w0] << 16);
    s.v[i][3] = __uint_as_float((uint32_t)p[w0 + 1] << 16);
  }
}

// lr_j = bf16(wy xc[j0][j] + (1 - wy) xc[j0 + 1][j]); up = cw0 lr_c0 + cw1 lr_c0+1
__device__ __forceinline__ void skip_store(float* up, const Skip& s) {
  if (!s.ok) return;
#pragma unroll
  for (int i = 0; i < SKIP_ITEMS; ++i) {
    const int item = threadIdx.x + TL_ITEM_THREADS * i;
    const float wy0 = item / (3 * TL_STRIP) ? s.wl[1] : s.wl[0], wy1 = 1.f - wy0;
    const float l0 = __bfloat162float(__float2bfloat16_rn(wy0 * s.v[i][0] + wy1 * s.v[i][2]));
    const float l1 = __bfloat162float(__float2bfloat16_rn(wy0 * s.v[i][1] + wy1 * s.v[i][3]));
    up[item] = s.cw0 * l0 + s.cw1 * l1;
  }
}

// grid: (strips, row runs, samples); block (s, g, b) computes rows
// [g * rows, (g + 1) * rows) of strip s of sample b, two rows an iteration.
// Staged row i of the block is row ya - 1 + i, in ring slot i % TL_RING,
// one TMA box (x0 - 8 .. x0 + TL_STRIP + 7, all channels) completing on
// full[slot] in phase i / TL_RING.
template <int CB>
__global__ void __launch_bounds__(TL_THREADS, 2)
tail_mma_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ xc,
                const bf16* __restrict__ wpk, const bf16* __restrict__ bias,
                const int* __restrict__ rj0, const float* __restrict__ rwy,
                const int* __restrict__ cj0, const float* __restrict__ cw,
                bf16* __restrict__ out, int H, int W, int h0, int w0, int rows) {
  using Cfg = TailCfg<CB>;
  static_assert(TL_ITEM_THREADS * SKIP_ITEMS == 2 * 3 * TL_STRIP, "skip items");
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[TL_RING];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool items = threadIdx.x < TL_ITEM_THREADS;
  const int x0 = blockIdx.x * TL_STRIP, b = blockIdx.z;
  const int ya = blockIdx.y * rows, yb = min(H, ya + rows);
  const int nst = ((yb - ya + 1) & ~1) + 2;  // staged rows: the output rows (even) and halos
  const bf16* xcb = xc + (long long)b * 3 * h0 * w0;
  float* up = reinterpret_cast<float*>(smem + Cfg::OFF_UP);
  float* Pb = reinterpret_cast<float*>(smem + Cfg::OFF_P);
  const uint2* wfr = reinterpret_cast<const uint2*>(smem + Cfg::OFF_W);

  auto issue = [&](int i) {  // staged row i, by thread 0
    if (i >= nst) return;
    const int s = i % TL_RING;
    mbar_arrive_expect_tx(&full[s], Cfg::ROW);
    tma_load_4d(smem + s * Cfg::ROW, &map, &full[s], x0 - 8, ya - 1 + i, 0, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < TL_RING; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    for (int i = 0; i < TL_RING; ++i) issue(i);
  }
  for (int i = threadIdx.x; i < 3 * CB * 2 * 16; i += TL_THREADS)
    reinterpret_cast<uint4*>(smem + Cfg::OFF_W)[i] = reinterpret_cast<const uint4*>(wpk)[i];
  Skip sk;
  {
    const int x = x0 + threadIdx.x % TL_STRIP;
    sk.ok = items && x < W;
    sk.c0 = sk.ok ? cj0[x] : 0;
    sk.cw0 = sk.ok ? __bfloat162float(__float2bfloat16_rn(cw[x])) : 0.f;
    sk.cw1 = sk.ok ? __bfloat162float(__float2bfloat16_rn(cw[W + x])) : 0.f;
  }
  // the outputs' biases, for this thread's items
  float bk[SKIP_ITEMS];
#pragma unroll
  for (int i = 0; i < SKIP_ITEMS; ++i)
    bk[i] = __bfloat162float(bias[(threadIdx.x + TL_ITEM_THREADS * i) / TL_STRIP % 3]);
  skip_rows(sk, ya, H, rj0, rwy);
  skip_load(sk, xcb, h0, w0);
  skip_store(up, sk);
  skip_rows(sk, ya + 2, H, rj0, rwy);
  __syncthreads();

  // ldmatrix.trans rows: lane l gives matrix l / 8, stored row l % 8 =
  // channel l % 8 (+ 8 for matrices 2 and 3) of staged pixels 16 warp .. + 7
  // (+ 8 for matrices 1 and 3)
  const int mrow = ((lane % 8 + 8 * (lane / 16)) * TL_BOX + 16 * warp + 8 * ((lane / 8) % 2)) * 2;
  const long long HW = (long long)H * W;
  // Iteration: output rows y, y + 1 from staged rows y - 1 .. y + 2.
  // P[r][s][3 dx + k] = sum over dy, c of sr[c, y + r + dy - 1, x0 - 8 + s] W[k, c, dy, dx]
  // for the warp's 16 staged pixels s (N = 16: 3 dx x 3 outputs, padded);
  // then out[k, y + r, x0 + p] = sum over dx of P[r][p + 7 + dx][3 dx + k] +
  // bias + skip. After the products, TMA refills the two slots rows y - 1 and
  // y leave with rows y + 5 and y + 6, and the skip terms of rows y + 2, y + 3
  // are computed.
  for (int y = ya, it = 0; y < yb; y += 2, ++it) {
    const int i0 = y - ya;  // staged row of y - 1
    const bool more = y + 2 < yb;
    if (more) {
      skip_load(sk, xcb, h0, w0);
      skip_rows(sk, y + 4, H, rj0, rwy);
    }
    float acc[2][2][4] = {};  // [output row][n-tile]
#pragma unroll
    for (int sy = 0; sy < 4; ++sy) {  // staged row y + sy - 1: tap sy of row y, sy - 1 of y + 1
      const int i = i0 + sy;
      mbar_wait(&full[i % TL_RING], (i / TL_RING) & 1);
      const uint8_t* base = smem + (i % TL_RING) * Cfg::ROW + mrow;
#pragma unroll
      for (int kb = 0; kb < CB; ++kb) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, base + 16 * kb * TL_BOX * 2);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (sy < 3) {
            const uint2 w = wfr[((sy * CB + kb) * 2 + nt) * 32 + lane];
            mma_m16n8k16_bf16(acc[0][nt], a, w.x, w.y);
          }
          if (sy > 0) {
            const uint2 w = wfr[(((sy - 1) * CB + kb) * 2 + nt) * 32 + lane];
            mma_m16n8k16_bf16(acc[1][nt], a, w.x, w.y);
          }
        }
      }
    }
    // acc[r][nt] = {s = 16 warp + g: columns 8 nt + 2q, +1; s + 8: the same}
    const int g = lane / 4, q = lane % 4;
    float* P = Pb + (it % 2) * 2 * TL_BOX * TL_NP;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 8 * nt + 2 * q + (j & 1), s_ = 16 * warp + g + 8 * (j >> 1);
          if (n < TL_NP) P[(r * TL_BOX + s_) * TL_NP + n] = acc[r][nt][j];
        }
    __syncthreads();  // P complete, the skip slot written; staged rows i0, i0 + 1 are free
    if (threadIdx.x == 0) {
      issue(i0 + TL_RING);
      issue(i0 + 1 + TL_RING);
    }
    if (items) {
      const float* u = up + (it % 2) * 2 * 3 * TL_STRIP;
#pragma unroll
      for (int i = 0; i < SKIP_ITEMS; ++i) {
        const int item = threadIdx.x + TL_ITEM_THREADS * i;
        const int p = item % TL_STRIP, k = item / TL_STRIP % 3, r = item / (3 * TL_STRIP);
        const int x = x0 + p;
        if (x >= W || y + r >= yb) continue;
        const float* pr = P + (r * TL_BOX + p + 7) * TL_NP + k;
        const float v = (pr[0] + pr[TL_NP + 3]) + pr[2 * TL_NP + 6];
        out[((long long)b * 3 + k) * HW + (long long)(y + r) * W + x] =
            __float2bfloat16_rn(v + bk[i] + u[item]);
      }
    }
    // the next iteration writes the other P and reads this skip slot after
    // its barrier; this one's P and the other skip slot are read before it
    if (more) skip_store(up + ((it + 1) % 2) * 2 * 3 * TL_STRIP, sk);
  }
}

template <int CB>
int launch_mma(const void* sr, long long pitch, const void* xc, const void* wpk, const void* bias,
               const int* rj0, const float* rwy, const int* cj0, const float* cw, void* out,
               int B, int H, int W, int h0, int w0, cudaStream_t stream) {
  using Cfg = TailCfg<CB>;
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tail_mma_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg::SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  // (W, H, C, B), so that a box of one row lands as [C][TL_BOX]
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cfg::C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pitch * 2, (cuuint64_t)pitch * H * 2,
                                 (cuuint64_t)pitch * H * Cfg::C * 2};
  const cuuint32_t box[4] = {TL_BOX, 1, Cfg::C, 1}, elem[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(sr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  // row runs for ~8 waves of two blocks per SM, none under 16 rows
  const int strips = (W + TL_STRIP - 1) / TL_STRIP;
  int runs = (16 * sms + B * strips - 1) / (B * strips);
  if (runs > (H + 15) / 16) runs = (H + 15) / 16;
  if (runs < 1) runs = 1;
  const int rows = (H + runs - 1) / runs;
  runs = (H + rows - 1) / rows;
  dim3 grid(strips, runs, B);
  tail_mma_kernel<CB><<<grid, TL_THREADS, Cfg::SMEM, stream>>>(
      map, static_cast<const bf16*>(xc), static_cast<const bf16*>(wpk),
      static_cast<const bf16*>(bias), rj0, rwy, cj0, cw, static_cast<bf16*>(out), H, W, h0, w0,
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* savsr_error_string(int e) {
  if (e == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (e == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the tail's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// f32 (and bf16 at other C, widened to f32 by the caller, with round_bf16):
// sr: [B, C, H, W] with rows ``pitch`` elements apart (a multiple of 4,
// 16-byte aligned base: TMA); xc: [B, 3, h0, w0]; wpk: [C][28] packed
// weights (ops/tail.py pack_tail_weights_f32: slot 9 dy + 3 dx + k holds
// weight[k, c, dy, dx], slot 27 zero) then the bias [3] and a zero;
// rj0/rwy: [H] row starts / weights; cj0: [W]; cw: [2, W] column weights;
// out: [B, 3, H, W] f32; sms: the grid (one block per SM).
extern "C" int savsr_tail_f32(const void* sr, long long pitch, const void* xc, const void* wpk,
                              const int* rj0, const float* rwy, const int* cj0, const float* cw,
                              void* out, int B, int C, int H, int W, int h0, int w0,
                              int round_bf16, int sms, void* stream) {
  const long long ntiles = (long long)B * ((H + TF_TH - 1) / TF_TH) * ((W + TF_TW - 1) / TF_TW);
  if (B < 1 || C < 1 || H < 1 || W < 1 || h0 < 2 || w0 < 2 || sms < 1 || pitch % 4 != 0 ||
      pitch < W || ntiles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = round_bf16 ? launch_f32<true> : launch_f32<false>;
  return launch(sr, pitch, xc, wpk, rj0, rwy, cj0, cw, out, B, C, H, W, h0, w0, sms, s);
}

// bf16, the same operands with C in 16, 32, 48, 64, sr's rows ``pitch``
// elements apart (a multiple of 8, 16-byte aligned base: TMA), and the
// weight packed as B fragments (ops/tail.py pack_tail_weights).
extern "C" int savsr_tail_mma(const void* sr, long long pitch, const void* xc, const void* wpk,
                              const void* bias, const int* rj0, const float* rwy, const int* cj0,
                              const float* cw, void* out, int B, int C, int H, int W, int h0,
                              int w0, void* stream) {
  if (C % 16 != 0 || C < 16 || C > 64 || h0 < 2 || w0 < 2 || pitch % 8 != 0 || pitch < W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / 16) {
    case 1: return launch_mma<1>(sr, pitch, xc, wpk, bias, rj0, rwy, cj0, cw, out, B, H, W, h0, w0, s);
    case 2: return launch_mma<2>(sr, pitch, xc, wpk, bias, rj0, rwy, cj0, cw, out, B, H, W, h0, w0, s);
    case 3: return launch_mma<3>(sr, pitch, xc, wpk, bias, rj0, rwy, cj0, cw, out, B, H, W, h0, w0, s);
    default: return launch_mma<4>(sr, pitch, xc, wpk, bias, rj0, rwy, cj0, cw, out, B, H, W, h0, w0, s);
  }
}
