"""Data and spatial parallelism over a process group: the port's
counterpart of ``savsr_tpu/parallel/mesh.py``.

The JAX package runs one program over a mesh of devices and lets XLA insert
the collectives. Here each of the W ranks is its own process on its own
device, and the collectives are explicit: parameters, EMA and optimizer
state are broadcast from rank 0 (``replicate``), each rank trains on its
share of the global batch (``rank_rows``: the r-th 1/W of every global
micro-batch), BatchNorm takes its batch statistics over the world
(``archs/arch_util.py batch_norm``), and the gradients are averaged over the
ranks in a few flat buckets (``reduce_gradients``). No
``DistributedDataParallel`` wrapper: the bf16 step calls the network through
``torch.func.functional_call``, which a DDP wrapper would not see, and the
BatchNorm running statistics are written outside autograd.

The ``spatial`` axis (``mesh: {data: D, spatial: S}``, D x S ranks): rank r
sits in data group r // S at band r % S (the JAX mesh's row-major
(data, spatial) order); the S ranks of a data group hold the same samples
and share each frame, each computing its band of rows
(``parallel/spatial.py``), in the eval forward and in the training step;
the data groups stride the eval's items and split the global batch. In
training each band's loss is its share of the frame's, so the gradient is
the sum over the bands and the mean over the data groups: one all-reduce
over the world, times 1 / D (``reduce_gradients``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.dist_util import get_dist_info
from .spatial import BandGroup

BUCKET_BYTES = 32 << 20


@dataclass(frozen=True)
class Mesh:
    """The world as a ``{data: D, spatial: S}`` mesh: its shape and this
    process's global rank; ``group`` is the world's process group (None in
    a world of one, where nothing is communicated), ``data_group`` that of
    the D ranks of this rank's band index (the world when S is 1), and
    ``bands`` this rank's band group (None when S is 1; it carries the
    data group and D)."""

    shape: Dict[str, int] = field(default_factory=lambda: {"data": 1, "spatial": 1})
    rank: int = 0
    group: Optional[Any] = None
    data_group: Optional[Any] = None
    bands: Optional[BandGroup] = None

    @property
    def size(self) -> int:
        """The data axis: the number of data groups."""
        return self.shape["data"]

    @property
    def spatial(self) -> int:
        return self.shape["spatial"]

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def band(self) -> int:
        return self.rank % self.spatial


def mesh_axes(opt: Optional[dict], world: int) -> Tuple[int, int]:
    """(D, S): the data and spatial axes of ``opt['mesh']`` ({axis: size},
    -1 fills with the rest of the world; default ``{data: -1, spatial:
    1}``) over a world of ``world`` ranks, whose size D x S must be."""
    spec = {k: int(v) for k, v in ((opt or {}).get("mesh") or {}).items()}
    unknown = set(spec) - {"data", "spatial"}
    if unknown:
        raise ValueError(f"mesh: unknown axes {sorted(unknown)} (data | spatial)")
    spec.setdefault("data", -1)
    spec.setdefault("spatial", 1)
    fill = [k for k, v in spec.items() if v == -1]
    if len(fill) > 1:
        raise ValueError(f"mesh: {spec} has more than one axis of size -1")
    if fill:
        spec[fill[0]] = max(1, world // int(np.prod([v for v in spec.values() if v != -1])))
    d, s = spec["data"], spec["spatial"]
    if d * s != world:
        raise ValueError(f"mesh: data: {d} x spatial: {s} must equal the world size {world} "
                         "(one process per GPU)")
    return d, s


def get_mesh_from_opt(opt: Optional[dict]) -> Mesh:
    """The mesh of ``opt['mesh']`` (``mesh_axes``) over the process group
    when ``opt['dist']`` (a launcher joined one), else over this process
    alone. data x spatial must equal the world size (one process per GPU).
    Every rank makes every group, in one order."""
    opt = opt or {}
    rank, world = get_dist_info() if opt.get("dist") else (0, 1)
    d, s = mesh_axes(opt, world)
    if world == 1:
        return Mesh({"data": 1, "spatial": 1})
    if s == 1:
        return Mesh({"data": d, "spatial": 1}, rank, dist.group.WORLD, dist.group.WORLD)
    bands = data_group = None
    for g in range(d):  # the band groups: S consecutive ranks each
        ranks = tuple(range(g * s, (g + 1) * s))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            bands = BandGroup(rank % s, s, ranks, group, dist.get_backend(group))
    for b in range(s):  # the data groups: the ranks of one band index
        group = dist.new_group(list(range(b, world, s)))
        if rank % s == b:
            data_group = group
    bands = replace(bands, data=d, data_group=data_group if d > 1 else None)
    return Mesh({"data": d, "spatial": s}, rank, dist.group.WORLD, data_group, bands)


def rank_rows(n: int, world: int, rank: int, accum: int = 1) -> List[int]:
    """The rows of a global batch of ``n`` that rank ``rank`` of ``world``
    holds: the rank-th 1/world of each of the ``accum`` global micro-batches
    (micro-batch m is rows [m*n/accum, (m+1)*n/accum)), in order. Every rank
    then works in every micro-step, and a rank's m-th chunk is its share of
    micro-batch m."""
    if n % (accum * world):
        raise ValueError(f"a global batch of {n} does not split into {accum} micro-batch(es) "
                         f"x {world} rank(s): batch_size_per_gpu must be divisible by "
                         "train: accum_steps")
    per = n // (accum * world)
    return [m * (n // accum) + rank * per + i for m in range(accum) for i in range(per)]


def shard_or_replicate_batch(tree: Dict[str, Any], mesh: Mesh, accum: int = 1) -> Dict[str, Any]:
    """This rank's share (``rank_rows`` at its data index) of a global
    batch: every leaf with a leading batch axis of the global size is cut,
    the rest (the scale, keys of another length) is kept whole."""
    sizes = {len(v) for v in tree.values() if isinstance(v, (np.ndarray, torch.Tensor))}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves of different lengths {sorted(sizes)}")
    n = sizes.pop()
    rows = rank_rows(n, mesh.size, mesh.data_index, accum)
    out = {}
    for k, v in tree.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and len(v) == n:
            out[k] = v[rows] if isinstance(v, np.ndarray) else v[torch.as_tensor(rows)]
        elif isinstance(v, list) and len(v) == n:
            out[k] = [v[i] for i in rows]
        else:
            out[k] = v
    return out


def _buckets(tensors: List[torch.Tensor], limit: int = BUCKET_BYTES):
    """Consecutive runs of one dtype of at most ``limit`` bytes."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or size + nb > limit):
            yield run
            run, size = [], 0
        run.append(t)
        size += nb
    if run:
        yield run


def _flat_collective(tensors: Iterable[torch.Tensor], device, op) -> None:
    """Run ``op(flat)`` on each bucket of ``tensors`` flattened on
    ``device`` (NCCL takes CUDA tensors only, so CPU-held state such as
    Adam's step counts travels on the device), then copy the results back
    in place."""
    order = sorted(tensors, key=lambda t: str(t.dtype))
    for bucket in _buckets(order):
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in bucket])
        op(flat)
        offset = 0
        with torch.no_grad():
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(obj, mesh: Mesh, device) -> Any:
    """Make ``obj`` equal to rank 0's on every rank (the role of the JAX
    package's ``replicate``): an ``nn.Module``'s parameters and buffers, a
    dict of tensors, or an optimizer's state, broadcast in place. Returns
    ``obj``."""
    if mesh.group is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    elif isinstance(obj, torch.optim.Optimizer):
        tensors = [v for state in obj.state.values() for v in state.values()
                   if isinstance(v, torch.Tensor)]
    else:
        tensors = [v for v in obj.values() if isinstance(v, torch.Tensor)]
    src = dist.get_global_rank(mesh.group, 0)
    _flat_collective(tensors, device, lambda flat: dist.broadcast(flat, src, group=mesh.group))
    return obj


def reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Each parameter's gradient becomes the sum of the world's over the
    data axis's size D (so the step's gradient is that of the mean loss
    over the global batch: each band's gradient is that of its share of
    its group's loss, and a group's bands' shares add up to it), summed in
    a few flat buckets."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    inv = 1.0 / mesh.size

    def op(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.mul_(inv)

    _flat_collective(grads, grads[0].device, op)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t
