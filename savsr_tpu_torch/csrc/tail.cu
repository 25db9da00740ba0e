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
// read. Two kernels, one per type:
//
// * f32 (tail_kernel, CUDA cores): a block takes an 8x32 HR tile; 16
//   channels at a time of sr (with its 1-pixel halo) stream through shared
//   memory, all 27*C tail weights sit in shared memory, and each thread
//   keeps its pixel's 3 sums in registers.
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

constexpr int TW = 32, TH = 8, CI = 16, THREADS = TW * TH;
constexpr int CMAX = 64;
constexpr int IR = TH + 2, IC = TW + 2;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ sr, const T* __restrict__ xc, const T* __restrict__ wt,
            const T* __restrict__ bias, const int* __restrict__ rj0,
            const float* __restrict__ rwy, const int* __restrict__ cj0,
            const float* __restrict__ cw, T* __restrict__ out, int C, int H, int W, int h0,
            int w0) {
  __shared__ float s_in[CI][IR][IC];
  __shared__ float s_w[3][CMAX * 9];
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * TW, Y0 = blockIdx.y * TH;
  const int X = X0 + tx, Y = Y0 + ty;
  const long long HW = (long long)H * W;
  const T* srb = sr + (long long)b * C * HW;

  for (int e = tid; e < 3 * C * 9; e += THREADS) s_w[e / (C * 9)][e % (C * 9)] = ld(wt, e);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += CI) {
    __syncthreads();
    for (int e = tid; e < CI * IR * IC; e += THREADS) {
      const int ci = e / (IR * IC), r = (e / IC) % IR, q = e % IC;
      const int gy = Y0 + r - 1, gx = X0 + q - 1;
      float v = 0.f;
      if (c0 + ci < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = ld(srb, (c0 + ci) * HW + (long long)gy * W + gx);
      s_in[ci][r][q] = v;
    }
    __syncthreads();
    const int nc = min(CI, C - c0);
    for (int ci = 0; ci < nc; ++ci) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = s_in[ci][ty + t / 3][tx + t % 3];
        const int wi = (c0 + ci) * 9 + t;
        acc[0] = fmaf(s_w[0][wi], v, acc[0]);
        acc[1] = fmaf(s_w[1][wi], v, acc[1]);
        acc[2] = fmaf(s_w[2][wi], v, acc[2]);
      }
    }
  }
  if (X >= W || Y >= H) return;
  const int j0 = rj0[Y], c0 = cj0[X];
  const float wy0 = rwy[Y], wy1 = 1.f - wy0;
  const float cw0 = round_to(cw[X], sr), cw1 = round_to(cw[W + X], sr);
  const long long hw0 = (long long)h0 * w0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T* p = xc + ((long long)b * 3 + k) * hw0;
    const float l0 = round_to(wy0 * ld(p, (long long)j0 * w0 + c0) +
                                  wy1 * ld(p, (long long)(j0 + 1) * w0 + c0), sr);
    const float l1 = round_to(wy0 * ld(p, (long long)j0 * w0 + c0 + 1) +
                                  wy1 * ld(p, (long long)(j0 + 1) * w0 + c0 + 1), sr);
    const float up = cw0 * l0 + cw1 * l1;
    st(out, ((long long)b * 3 + k) * HW + (long long)Y * W + X, acc[k] + ld(bias, k) + up);
  }
}

template <typename T>
cudaError_t launch(const void* sr, const void* xc, const void* wt, const void* bias,
                   const int* rj0, const float* rwy, const int* cj0, const float* cw, void* out,
                   int B, int C, int H, int W, int h0, int w0, cudaStream_t stream) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tail_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(sr), static_cast<const T*>(xc), static_cast<const T*>(wt),
      static_cast<const T*>(bias), rj0, rwy, cj0, cw, static_cast<T*>(out), C, H, W, h0, w0);
  return cudaGetLastError();
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

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;      // the tensor map was refused

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

// f32: sr: [B, C, H, W]; xc: [B, 3, h0, w0]; wt: [3, C, 3, 3]; bias: [3];
// rj0/rwy: [H] row starts / weights; cj0: [W]; cw: [2, W] column weights;
// out: [B, 3, H, W].
extern "C" int savsr_tail_fused(const void* sr, const void* xc, const void* wt, const void* bias,
                                const int* rj0, const float* rwy, const int* cj0, const float* cw,
                                void* out, int B, int C, int H, int W, int h0, int w0,
                                void* stream) {
  if (C < 1 || C > CMAX || h0 < 2 || w0 < 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(sr, xc, wt, bias, rj0, rwy, cj0, cw, out, B, C, H, W, h0,
                                        w0, static_cast<cudaStream_t>(stream)));
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
