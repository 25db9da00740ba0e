"""Data loading: dataset protocol, sampler, prefetching loader.

The port's own copy of ``savsr_tpu/data/loader.py`` (in the role of
torch.utils.data plus the reference's prefetchers,
lbasicsr/data/prefetch_dataloader.py, and EnlargedSampler,
lbasicsr/data/data_sampler.py). Host-side; batches are dicts of numpy
arrays that the training loop ships to the device. ``DevicePrefetcher``
keeps the next batch uploading on a side CUDA stream while the current
step runs. A dataset's ``batch_draws`` (one draw per batch, such as the
arbitrary-scale set's scale) is called in the consumer's process, in batch
order, whatever the workers, so every rank of a world draws the same
sequence.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ..parallel.mesh import rank_rows

# state of one decode process of the process-pool path, set by its initializer
_POOL_DATASET = None
_POOL_COLLATE = None


def _pool_init(dataset, collate_fn, epoch: int, counter) -> None:
    """Initializer of a decode process (started with ``spawn``: the parent
    holds threads and possibly a CUDA context, which ``fork`` must not
    copy). Each process gets its own copy of the dataset; a dataset with its
    own generator (``rng``) is reseeded per (seed, epoch, process) so the
    processes do not all draw the same crops and scales."""
    global _POOL_DATASET, _POOL_COLLATE
    with counter.get_lock():
        index = counter.value
        counter.value += 1
    if hasattr(dataset, "rng"):
        dataset.rng.seed(f"{dataset.opt.get('seed')}:{epoch}:{index}")
    _POOL_DATASET, _POOL_COLLATE = dataset, collate_fn


def _pool_load_batch(batch_indices: List[int], draws: Dict[str, Any]):
    samples = [_POOL_DATASET[i] for i in batch_indices]
    return _POOL_COLLATE(samples, **draws)


class Dataset:
    """Minimal map-style dataset protocol."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy leaves along a new batch axis; pass through scalars/strings
    as lists (single sample values when identical)."""
    out: Dict[str, Any] = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class EnlargedSampler:
    """Epoch-seeded shuffling sampler with dataset-enlarge ratio, sharded
    by global batch. The global order is the one-process order (a seeded
    permutation of ratio*len, data_sampler.py:6-48), whatever the world
    size; it is cut into global batches of ``batch_size`` x
    ``num_replicas`` items, and rank r takes from each the r-th
    1/num_replicas of each of its ``accum_steps`` micro-batches
    (``parallel.rank_rows``). So the W ranks' shares reassemble the
    one-process order, every rank works in every micro-step, and a rank's
    m-th micro-batch is its share of global micro-batch m. (The JAX
    package stripes the items by rank instead.) In a world of one every
    item is kept in order; otherwise the last short global batch is
    dropped."""

    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0, ratio: int = 1,
                 batch_size: int = 1, accum_steps: int = 1):
        self.dataset_len = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.batch_size = batch_size
        self.total_size = num_samples * ratio
        global_batch = batch_size * num_replicas
        self.rows = (rank_rows(global_batch, num_replicas, rank, accum_steps)
                     if num_replicas > 1 else None)
        self.num_samples = (self.total_size if num_replicas == 1
                            else self.total_size // global_batch * batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.epoch)
        indices = rng.permutation(self.total_size) % self.dataset_len
        if self.num_replicas > 1:
            global_batch = self.batch_size * self.num_replicas
            n = self.total_size // global_batch
            indices = indices[:n * global_batch].reshape(n, global_batch)[:, self.rows]
        return iter(indices.reshape(-1).tolist())

    def __len__(self) -> int:
        return self.num_samples


class DataLoader:
    """Batching loader with optional background-thread prefetch.

    ``num_workers`` threads run ``dataset[i]`` + collate ahead of the
    consumer (cv2/numpy release the GIL for the heavy parts). With
    num_workers=0 everything is synchronous.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        sampler=None,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        prefetch_depth: int = 4,
        seed: Optional[int] = None,
        worker_mode: str = "thread",
        batch_draws: Optional[Callable[[], Dict[str, Any]]] = None,
    ):
        self.dataset = dataset
        # called once per batch, in order, here: its result goes to the collate
        self.batch_draws = batch_draws
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        # more runnable decode threads than cores actively hurts (measured
        # 4.1 vs 25.6 samples/s with 2 workers on a 1-core host): clamp
        import os as _os

        cores = _os.cpu_count() or 1
        self.num_workers = min(num_workers, cores)
        self.prefetch_depth = max(prefetch_depth, 2 * max(self.num_workers, 1))
        # "thread" (default): GIL-sharing decode threads — cv2/numpy release
        # the GIL for the heavy parts, but the Python-level collate serializes.
        # "process": spawned decode processes sidestep the GIL entirely at the
        # cost of one batch copy over the pipe.
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r} (thread | process)")
        self.worker_mode = worker_mode
        self._epoch = 0
        if sampler is not None:
            self.sampler = sampler
            self._shuffle = False
        else:
            self.sampler = None
            self._shuffle = shuffle
            self._seed = seed if seed is not None else 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_batches(self) -> List[List[int]]:
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        elif self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            indices = rng.permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self) -> int:
        if self.sampler is not None:
            n = len(self.sampler)
        else:
            n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_batch(self, batch_indices: List[int], draws: Dict[str, Any]):
        samples = [self.dataset[i] for i in batch_indices]
        return self.collate_fn(samples, **draws)

    def __iter__(self):
        batches = [(bi, self.batch_draws() if self.batch_draws is not None else {})
                   for bi in self._index_batches()]
        if self.num_workers <= 0:
            for bi, draws in batches:
                yield self._load_batch(bi, draws)
            return

        # num_workers workers each build whole batches; a bounded window of
        # in-flight futures keeps delivery ordered and memory capped, and the
        # finally-block cancels cleanly if the consumer abandons iteration
        # (threads: cv2/numpy release the GIL; processes: their own copy of
        # the dataset, no GIL sharing at all)
        window = max(self.prefetch_depth, self.num_workers)
        if self.worker_mode == "process":
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            executor = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx, initializer=_pool_init,
                initargs=(self.dataset, self.collate_fn, self._epoch, ctx.Value("i", 0)),
            )
            load = _pool_load_batch
        else:
            executor = ThreadPoolExecutor(max_workers=self.num_workers)
            load = self._load_batch
        futures: deque = deque()
        try:
            it = iter(batches)
            for bi, draws in itertools.islice(it, window):
                futures.append(executor.submit(load, bi, draws))
            while futures:
                batch = futures.popleft().result()  # raises worker failure
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(executor.submit(load, *nxt))
                yield batch
        finally:
            while futures:
                futures.popleft().cancel()
            executor.shutdown(wait=False)


class CPUPrefetcher:
    """Thin iterator adapter with the reset()/next() prefetcher protocol
    (reference prefetch_dataloader.py:61-81); the actual read-ahead lives in
    DataLoader's worker pool."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self._iter = None

    def reset(self) -> None:
        self._iter = iter(self.loader)

    def next(self):
        return next(self._iter, None)


class DevicePrefetcher:
    """Overlap host->device transfer with compute: keeps one batch in flight
    on the device (the reference CUDAPrefetcher,
    prefetch_dataloader.py:84-125). ``to_device`` uploads a batch from pinned
    memory with non-blocking copies; on a CUDA device it runs on a side
    stream, and ``next`` makes the current stream wait for that upload."""

    def __init__(self, loader: DataLoader, to_device: Callable[[Any], Any], device=None):
        import torch

        self.loader = loader
        self.to_device = to_device
        self._iter = None
        self._next = None
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and torch.device(device).type == "cuda" else None)

    def reset(self) -> None:
        self._iter = iter(self.loader)
        self._preload()

    def _preload(self) -> None:
        try:
            batch = next(self._iter)
        except StopIteration:
            self._next = None
            return
        if self._stream is None:
            self._next = self.to_device(batch)
            return
        import torch

        with torch.cuda.stream(self._stream):
            self._next = self.to_device(batch)

    def next(self):
        batch = self._next
        if batch is not None:
            if self._stream is not None:
                import torch

                cur = torch.cuda.current_stream(self._stream.device)
                cur.wait_stream(self._stream)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(cur)
            self._preload()
        return batch
