"""Data subsystem: registered datasets + loader builders.

The port's counterpart of ``savsr_tpu/data/__init__.py`` (mirrors
lbasicsr/data/__init__.py): datasets are registered plugins resolved by name
from YAML; ``build_dataloader`` wires the batching, the sampler and a
dataset-provided ``as_collate_fn`` hook (the arbitrary-scale batch
degradation lives there).
"""

from __future__ import annotations

from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import DATASET_REGISTRY
from .loader import DataLoader, DevicePrefetcher, EnlargedSampler

# import dataset modules so their @register decorators run
from . import video_test_dataset  # noqa: F401
from . import vimeo90k_dataset  # noqa: F401

__all__ = ["build_dataset", "build_dataloader", "DataLoader", "DevicePrefetcher",
           "EnlargedSampler"]

# dataset types of the JAX package that the port does not have yet
NOT_PORTED = ("REDSDataset", "REDSRecurrentDataset", "ASREDSRecurrentDataset",
              "Vimeo90KRecurrentDataset", "ASVimeo90KRecurrentDataset",
              "VideoRecurrentTestDataset", "ASVideoRecurrentTestDataset")


def build_dataset(dataset_opt: dict, seed=None, rank: int = 0):
    """Instantiate a dataset by its YAML ``type``. ``seed`` seeds its own
    generators: ``seed + rank`` its per-item draws (each rank of a world
    crops and flips apart), ``seed`` its per-batch draws (every rank draws
    the same scale for a global step)."""
    dataset_opt = deepcopy(dataset_opt)
    if dataset_opt["type"] in NOT_PORTED:
        raise NotImplementedError(f"datasets: type: {dataset_opt['type']} is not ported yet")
    if seed is not None:
        dataset_opt["seed"] = seed + rank
        dataset_opt["scale_seed"] = seed
    dataset = DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)
    get_root_logger().info(
        f"Dataset [{dataset.__class__.__name__}] - {dataset_opt.get('name')} is built.")
    return dataset


def build_dataloader(dataset, dataset_opt: dict, sampler=None, seed=None):
    """Phase-aware loader construction (reference data/__init__.py:26-103):
    training batches are shuffled (or drawn by ``sampler``) and the last
    short batch dropped; ``val``/``test`` loaders keep the dataset's order,
    one item per batch unless ``batch_size_per_gpu`` says otherwise. A
    training set's ``batch_draws`` hook (the per-batch scale) is called by
    the loader in batch order."""
    phase = dataset_opt["phase"]
    common = dict(collate_fn=getattr(dataset, "as_collate_fn", None),
                  num_workers=dataset_opt.get("num_worker_per_gpu", 0),
                  worker_mode=dataset_opt.get("worker_mode", "thread"))
    if phase == "train":
        return DataLoader(dataset, batch_size=dataset_opt["batch_size_per_gpu"],
                          shuffle=sampler is None, sampler=sampler, drop_last=True, seed=seed,
                          batch_draws=getattr(dataset, "batch_draws", None), **common)
    if phase in ("val", "test"):
        return DataLoader(dataset, batch_size=dataset_opt.get("batch_size_per_gpu", 1),
                          shuffle=False, **common)
    raise ValueError(f"Wrong dataset phase: {phase}.")
