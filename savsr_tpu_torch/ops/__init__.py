"""Kernel wrappers of the serving path (conv3x3, conv1x1, sta, stau, tail)
and of the training path (osconv_agg, osconv_dagg), and their launch counts.

``launches[k]`` counts launches of kernel ``k`` on CUDA tensors (one per
call, added where the wrapper launches it); ``plain_cuda_calls[k]`` counts
calls of its plain PyTorch version with CUDA tensors, which neither path
makes. Counts are process-wide; ``reset_counts`` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNELS = ("conv3x3", "conv1x1", "sta", "stau", "tail", "osconv_agg", "osconv_dagg")

launches = dict.fromkeys(KERNELS, 0)
plain_cuda_calls = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
        plain_cuda_calls[k] = 0


def count_plain(kernel: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        plain_cuda_calls[kernel] += 1


# ---------------------------------------------------------------------------
# ctypes launch helpers shared by the wrappers
# ---------------------------------------------------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_rc(lib, rc: int, what: str) -> None:
    """Raise on a refused or failed launch (the C entry point returns
    cudaGetLastError() right after its launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.savsr_error_string(rc).decode()}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
