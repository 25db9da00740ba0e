"""Small host-side helpers: seeding, directory layout, file scanning,
resume bookkeeping (the port's counterpart of ``savsr_tpu/utils/misc.py``)."""

from __future__ import annotations

import os
import random
import time
from os import path as osp
from typing import Iterator, Optional

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed the global host-side generators (python, numpy, torch). The
    loaders, the datasets and the network initialisation use their own
    generator objects seeded from ``manual_seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """Make a directory; archive an existing one as ``<path>_archived_<ts>``
    so colliding experiment names never overwrite."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """Create the experiment (training) or results (test) directory tree."""
    path_opt = dict(opt["path"])
    mkdir_and_rename(path_opt.pop("experiments_root" if opt["is_train"] else "results_root"))
    for key, path in path_opt.items():
        if any(s in key for s in ("strict_load", "pretrain_network", "resume", "param_key")):
            continue
        if path is not None:
            os.makedirs(path, exist_ok=True)


def scandir(dir_path: str, suffix: Optional[str | tuple] = None, recursive: bool = False,
            full_path: bool = False) -> Iterator[str]:
    """Yield the paths of the files under ``dir_path`` (hidden files
    skipped), relative to it unless ``full_path``, optionally only those
    ending in ``suffix``."""
    root = dir_path

    def _scan(dir_path: str):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                rel = entry.path if full_path else osp.relpath(entry.path, root)
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)


def check_resume(opt: dict, resume_iter: int) -> None:
    """When resuming, point pretrain paths at the resumed checkpoints
    (semantics of lbasicsr/utils/misc.py:94-124)."""
    if not opt["path"].get("resume_state"):
        return
    networks = [key for key in opt.keys() if key.startswith("network_")]
    if any(opt["path"].get(f"pretrain_{name}") is not None for name in networks):
        print("pretrain_network paths will be ignored during resuming.", flush=True)
    for network in networks:
        name = f"pretrain_{network}"
        basename = network.replace("network_", "")
        if opt["path"].get("ignore_resume_networks") is None or (
            network not in opt["path"]["ignore_resume_networks"]
        ):
            opt["path"][name] = osp.join(opt["path"]["models"],
                                         f"net_{basename}_{resume_iter}.npz")
            print(f"Set {name} to {opt['path'][name]}", flush=True)
    # EMA params must not be loaded into the raw net when resuming mid-run
    for ori_key in list(opt["path"].keys()):
        if ori_key.startswith("param_key") and opt["path"][ori_key] == "params_ema":
            opt["path"][ori_key] = "params"
            print(f"Set {ori_key} to params", flush=True)
