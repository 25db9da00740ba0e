"""savsr_tpu_torch: the PyTorch + CUDA port of savsr_tpu for NVIDIA Hopper.

Eval-mode SAVSR serving (``python -m savsr_tpu_torch.inference``) and SAVSR
training (``python -m savsr_tpu_torch.train``), with the seven Pallas
kernels of the JAX package rewritten as hand-written CUDA kernels for
sm_90a (``csrc/*.cu``, built with nvcc and bound with ctypes).
Every kernel wrapper in ``ops/`` runs its plain PyTorch version on CPU
tensors and launches its CUDA kernel on CUDA tensors; there is no fallback
from one to the other. The package imports neither JAX nor savsr_tpu.
"""

__version__ = "0.1.0"
