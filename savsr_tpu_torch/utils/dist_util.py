"""Process-group utilities: one process per GPU.

The port's counterpart of ``savsr_tpu/utils/dist_util.py`` (the role of
lbasicsr/utils/dist_util.py). A world of W ranks is W processes, each on one
device, joined by a ``torch.distributed`` process group: NCCL between CUDA
devices, gloo on the CPU (``dist_params: backend:`` overrides either).
``rank`` / ``world_size`` gate logging, checkpoint writes and the data and
eval shares; the collectives themselves live in ``savsr_tpu_torch.parallel``.

Launchers:

- ``pytorch``: ``python -m torch.distributed.run --nproc_per_node N ...``
  (torchrun), which exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``; without them it raises, it never runs
  as a world of one.
- ``slurm``: ``srun`` with one task per GPU: ``SLURM_PROCID``,
  ``SLURM_NTASKS``, ``SLURM_LOCALID``; the address is ``MASTER_ADDR`` or the
  first host of ``SLURM_NODELIST``, the port ``MASTER_PORT`` or
  ``dist_params: port`` (29500).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TORCHRUN_CMD = ("python -m torch.distributed.run --nproc_per_node <N> -m savsr_tpu_torch.train "
                "-opt <cfg.yml> --launcher pytorch")


def default_backend(device: Optional[str | torch.device]) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def local_rank(launcher: str) -> int:
    """This process's index on its host under ``launcher``."""
    if launcher == "pytorch":
        return int(os.environ["LOCAL_RANK"])
    if launcher == "slurm":
        return int(os.environ["SLURM_LOCALID"])
    return 0


def _slurm_head(node_list: str) -> str:
    """The first host of a SLURM node list ("gpu[01-04],cpu1" -> "gpu01")."""
    head = node_list.split(",")[0]
    if "[" in head:
        name, rng = head.split("[", 1)
        head = name + rng.rstrip("]").split(",")[0].split("-")[0]
    return head


def init_dist(launcher: str, backend: Optional[str] = None, port: int = 29500,
              **_unused) -> None:
    """Join the process group of ``launcher`` (``pytorch`` | ``slurm``).
    A second call in the same process returns; a failing
    ``init_process_group`` propagates."""
    if dist.is_initialized():
        return
    if launcher == "pytorch":
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--launcher pytorch needs torchrun's environment ({', '.join(missing)} not "
                f"set): launch with {TORCHRUN_CMD}")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif launcher == "slurm":
        rank, world = int(os.environ["SLURM_PROCID"]), int(os.environ["SLURM_NTASKS"])
        addr = os.environ.get("MASTER_ADDR") or _slurm_head(os.environ["SLURM_NODELIST"])
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', port)}"
    else:
        raise ValueError(f"launcher {launcher!r} (pytorch | slurm)")
    dist.init_process_group(backend=backend or "nccl", init_method=init_method, rank=rank,
                            world_size=world)


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_master() -> bool:
    return get_dist_info()[0] == 0


def master_only(func):
    """Run ``func`` on rank 0 only (the others return None)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_master():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Wait for every rank (nothing to wait for in a world of one)."""
    if get_dist_info()[1] > 1:
        dist.barrier()


def destroy_dist() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
