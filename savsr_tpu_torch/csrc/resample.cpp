// Separable image resampler of the host data pipeline (the eval datasets'
// and the training collate's arbitrary-scale bicubic degradation).
//
// The port's own copy of the JAX package's host resampler
// (savsr_tpu/csrc/resample.cpp): it applies precomputed [out, in] weight
// matrices (savsr_tpu_torch/data/resize.py) along H, then W, with float
// accumulation in the same order (one multiply-add per nonzero weight, in
// increasing input index), so both packages produce the same bits from the
// same frames. Parallel over output rows with std::thread; C ABI for ctypes.
//
// Layout: channel-last float32 images [N, H, W, C] (contiguous).
// Weights are dense row-major [H_out, H_in] / [W_out, W_in] float32; they
// are banded, so each output row or column visits only its nonzero band.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// y[n, ho, w, c] = sum_h mh[ho, h] * x[n, h, w, c]
// then z[n, ho, wo, c] = sum_w mw[wo, w] * y[n, ho, w, c]
// scratch is caller-provided [n, h_out, w_in, c].
void resample_hw_f32(const float* x, float* scratch, float* out,
                     const float* mh, const float* mw,
                     int64_t n, int64_t h_in, int64_t w_in, int64_t c,
                     int64_t h_out, int64_t w_out, int n_threads) {
  const int64_t row_in = w_in * c;
  const int64_t row_out = w_out * c;

  // precompute nonzero band [lo, hi) per output row/col: the bicubic
  // matrices are banded, so this turns dense matvecs into short ones
  std::vector<int64_t> h_lo(h_out), h_hi(h_out), w_lo(w_out), w_hi(w_out);
  for (int64_t i = 0; i < h_out; ++i) {
    int64_t lo = 0, hi = h_in;
    const float* row = mh + i * h_in;
    while (lo < h_in && row[lo] == 0.0f) ++lo;
    while (hi > lo && row[hi - 1] == 0.0f) --hi;
    h_lo[i] = lo; h_hi[i] = hi;
  }
  for (int64_t i = 0; i < w_out; ++i) {
    int64_t lo = 0, hi = w_in;
    const float* row = mw + i * w_in;
    while (lo < w_in && row[lo] == 0.0f) ++lo;
    while (hi > lo && row[hi - 1] == 0.0f) --hi;
    w_lo[i] = lo; w_hi[i] = hi;
  }

  if (n_threads < 1) n_threads = 1;

  // pass 1: vertical (H_in -> H_out), parallel over (n, h_out)
  {
    const int64_t total = n * h_out;
    auto work = [&](int64_t t0, int64_t t1) {
      for (int64_t t = t0; t < t1; ++t) {
        const int64_t img = t / h_out;
        const int64_t ho = t % h_out;
        const float* w_row = mh + ho * h_in;
        float* dst = scratch + (img * h_out + ho) * row_in;
        std::memset(dst, 0, sizeof(float) * row_in);
        for (int64_t h = h_lo[ho]; h < h_hi[ho]; ++h) {
          const float wgt = w_row[h];
          if (wgt == 0.0f) continue;
          const float* src = x + (img * h_in + h) * row_in;
          for (int64_t k = 0; k < row_in; ++k) dst[k] += wgt * src[k];
        }
      }
    };
    std::vector<std::thread> threads;
    const int64_t chunk = (total + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      const int64_t a = i * chunk, b = std::min(total, (i + 1) * chunk);
      if (a >= b) break;
      threads.emplace_back(work, a, b);
    }
    for (auto& th : threads) th.join();
  }

  // pass 2: horizontal (W_in -> W_out), parallel over (n, h_out)
  {
    const int64_t total = n * h_out;
    auto work = [&](int64_t t0, int64_t t1) {
      for (int64_t t = t0; t < t1; ++t) {
        const float* src_row = scratch + t * row_in;
        float* dst_row = out + t * row_out;
        for (int64_t wo = 0; wo < w_out; ++wo) {
          const float* w_row = mw + wo * w_in;
          float* dst = dst_row + wo * c;
          for (int64_t ch = 0; ch < c; ++ch) dst[ch] = 0.0f;
          for (int64_t w = w_lo[wo]; w < w_hi[wo]; ++w) {
            const float wgt = w_row[w];
            if (wgt == 0.0f) continue;
            const float* src = src_row + w * c;
            for (int64_t ch = 0; ch < c; ++ch) dst[ch] += wgt * src[ch];
          }
        }
      }
    };
    std::vector<std::thread> threads;
    const int64_t chunk = (total + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      const int64_t a = i * chunk, b = std::min(total, (i + 1) * chunk);
      if (a >= b) break;
      threads.emplace_back(work, a, b);
    }
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
