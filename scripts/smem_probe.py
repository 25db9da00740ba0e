#!/usr/bin/env python3
"""Shared-memory load cost on one CUDA card, by address pattern: the cycles
an SM spends per warp-wide shared load (one wavefront = one cycle of the
shared-memory pipe), for 16-byte and 4-byte loads.

    python3 scripts/smem_probe.py [--out FILE]

One block of 8 warps per SM runs a loop of independent shared loads (inline
PTX, so each is one instruction of the given width) and reads clock64()
around it; the cost is the SM's cycles divided by its warps' loads. The
patterns are those of the CUDA-core kernels' register tiles: every lane of a
warp at one address, each quarter warp (8 lanes) at one address, 8
consecutive pieces repeated in every quarter warp, and 32 consecutive
pieces. The kernels of csrc/ are sized by this cost (csrc/stau.cu, the f32
kernel's note).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r"""
#include <cuda_runtime.h>

// lane -> float offset of its first load, by pattern
__device__ __forceinline__ int lane_base(int pattern, int lane, int width) {
  switch (pattern) {
    case 0: return 0;                        // the warp at one address
    case 1: return (lane / 8) * width;       // each quarter warp at one address
    case 2: return (lane % 8) * width;       // 8 consecutive pieces, in every quarter
    default: return lane * width;            // 32 consecutive pieces
  }
}

template <int WIDTH>
__global__ void probe_kernel(int pattern, int iters, float* sink, long long* cycles) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const int base = lane_base(pattern, threadIdx.x % 32, WIDTH);
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(sm + base));
  float acc[8] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned a = s0 + 4u * (unsigned)(((it * 8 + u) & 63) * 64);
      float v;
      if (WIDTH == 4) {
        float y, z, w;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v), "=f"(y), "=f"(z), "=f"(w) : "r"(a));
      } else {
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
      }
      acc[u] += v;
    }
  }
  const long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.f;
  for (int u = 0; u < 8; ++u) s += acc[u];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe(int width, int pattern, int iters, int blocks, float* sink,
                     long long* cycles) {
  if (width == 4)
    probe_kernel<4><<<blocks, 256>>>(pattern, iters, sink, cycles);
  else
    probe_kernel<1><<<blocks, 256>>>(pattern, iters, sink, cycles);
  cudaError_t e = cudaDeviceSynchronize();
  return e == cudaSuccess ? static_cast<int>(cudaGetLastError()) : static_cast<int>(e);
}
"""

PATTERNS = ("the warp at one address", "each quarter warp at one address",
            "8 consecutive pieces in every quarter warp", "32 consecutive pieces")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the costs here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from savsr_tpu_torch.csrc import build

    if not torch.cuda.is_available():
        print("smem_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "libprobe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(lib_path)
        lib.probe.restype = ctypes.c_int
        lib.probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        sink = torch.empty(blocks * 256, device="cuda")
        cycles = torch.empty(blocks, dtype=torch.int64, device="cuda")
        for width, wname in ((4, "16-byte"), (1, "4-byte")):
            for pattern, pname in enumerate(PATTERNS):
                for _ in range(2):  # the first launch warms up
                    rc = lib.probe(width, pattern, iters, blocks, ctypes.c_void_p(sink.data_ptr()),
                                   ctypes.c_void_p(cycles.data_ptr()))
                    if rc:
                        raise RuntimeError(f"probe launch failed: CUDA error {rc}")
                per_load = float(np.median(cycles.cpu().numpy())) / (iters * 8 * 8)
                print(f"[smem] {wname} loads, {pname}: {per_load:.3f} SM cycles per warp load",
                      flush=True)
                results.append({"width_bytes": 4 * width, "pattern": pname,
                                "cycles_per_warp_load": per_load})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "loads": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
