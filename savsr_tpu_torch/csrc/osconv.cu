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
// osconv_dagg_kernel replaces ::osconv_pallas_dagg:
//     dagg[b, dy*K+dx, i, o] = sum_{h,w} xpad[b, i, h+dy, w+dx] * g[b, o, h, w]
// f32 accumulation and f32 output for both input types.
//
// Bound on the H100: at the training shapes (8 samples of 60x60, Cin 64..320,
// Cout 64, or the reverse for dx) each does 2*9*Cin*Cout FLOPs per pixel
// against (Cin + Cout) values moved per pixel plus the 9*Cin*Cout weights of
// each sample, so both are bound by operations: in f32 held to the 67 TFLOP/s
// CUDA-core rate, in bf16 to the 989 TFLOP/s tensor-core rate. These first
// kernels run on the CUDA cores in f32 (bf16 inputs are widened on load) and
// cannot approach the bf16 bound; a tensor-core form is later work.
//
// Design, forward/dx: a block computes a 64-channel x 8-row x 32-column
// output tile; each warp owns 8 output channels, each lane one column of 8
// rows (64 accumulators in registers). Input channels stream through shared
// memory 8 at a time with a bounds-checked halo (no padded copy of x), the
// sample's weights for those channels are broadcast from shared memory. The
// weight layout [tap][Cin][Cout] makes the weight loads contiguous in Cout.
//
// Design, weight gradient: the TPU kernel carries its [P, Cin, Cout]
// accumulator across the sequential row-tile steps of one sample; blocks on
// this card run in no order and carry nothing over. Here a block owns one
// (sample, 32-input-channel tile, 64-output-channel tile, chunk of pixel
// rows) and keeps all K*K taps of its tile in registers (each thread: 2
// input channels x 4 output channels x 9 taps) while it walks its chunk's
// pixels 2 rows x 32 columns at a time through shared memory; the 3x3 window
// of x slides along the row in registers. With more than one chunk the
// blocks write f32 partials [chunk][B][P][Cin][Cout] and a second kernel
// adds them in chunk order, so the sum order is fixed and the result is the
// same from run to run (no atomics).
//
// Layout: x [B, Cin, H, W], g and y [B, Cout, Ho, Wo] (NCHW, contiguous),
// agg [B, K, K, Cin, Cout], dagg [B, K*K, Cin, Cout].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" const char* savsr_error_string(int e) {
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
