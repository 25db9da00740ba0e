"""YAML config parsing with CLI overrides.

The port's counterpart of ``savsr_tpu/utils/options.py`` (behaviour of
lbasicsr/utils/options.py:100-221): YAML with ``!!python/tuple`` scale
literals, ``--force_yml a:b=v`` deep overrides, seeding from ``manual_seed``,
experiments (training) or results (test) path derivation and debug-mode
frequency rewrites, plus the port's ``--device``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from os import path as osp
from shutil import copyfile
from typing import Any, Optional, Tuple

import yaml

from .misc import set_random_seed


class ConfigLoader(yaml.SafeLoader):
    """SafeLoader + ``!!python/tuple`` (scale literals in the reference configs)."""


ConfigLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)),
)


def yaml_load(f: str) -> dict:
    """Load a YAML file path or string into a dict."""
    if os.path.isfile(f):
        with open(f, "r") as fh:
            return yaml.load(fh, Loader=ConfigLoader)
    return yaml.load(f, Loader=ConfigLoader)


def dict2str(opt: dict, indent_level: int = 1) -> str:
    """Pretty-print a nested option dict."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def _postprocess_yml_value(value: str) -> Any:
    """Interpret a ``--force_yml`` value string."""
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("!!float"):
        return float(value.replace("!!float", ""))
    if value.isdigit():
        return int(value)
    if value.replace(".", "", 1).isdigit() and value.count(".") < 2:
        return float(value)
    if value.startswith("[") or value.startswith("("):
        return yaml.load(value, Loader=ConfigLoader)
    return value


def apply_force_yml(opt: dict, entries) -> None:
    """Apply ``key1:key2=value`` deep overrides (no new keys created)."""
    for entry in entries or ():
        keys, value = entry.split("=")
        value = _postprocess_yml_value(value.strip())
        node = opt
        parts = keys.strip().split(":")
        for key in parts[:-1]:
            node = node[key]
        if parts[-1] not in node:
            raise KeyError(f"--force_yml cannot create new key '{keys}'")
        node[parts[-1]] = value


def parse_options(root_path: str, is_train: bool = True,
                  args_list: Optional[list] = None) -> Tuple[dict, argparse.Namespace]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none"], default="none",
                        help="job launcher (multi-GPU launchers are not ported yet)")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Force to update yml options. Example: train:ema_decay=0.999")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises if there is no card)")
    args = parser.parse_args(args_list)

    opt = yaml_load(args.opt)
    opt["dist"] = False
    opt["rank"], opt["world_size"] = 0, 1
    opt["device"] = args.device

    seed = opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
        opt["manual_seed"] = seed
    set_random_seed(seed + opt["rank"])

    apply_force_yml(opt, args.force_yml)
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train

    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt.get("num_gpu") == "auto":
        opt["num_gpu"] = 1  # one device per process; multi-GPU is not ported yet

    # datasets: fan out phase / scale (val_x4 -> phase 'val', etc.)
    for phase, dataset in opt.get("datasets", {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        for root_key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(root_key) is not None:
                dataset[root_key] = osp.expanduser(dataset[root_key])

    for key, val in opt.get("path", {}).items():
        if (val is not None) and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)

    if not is_train:
        results_root = opt["path"].get("results_root")
        if results_root is None:
            results_root = osp.join(root_path, "results")
        results_root = osp.join(results_root, opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root, "visualization")
        return opt, args
    experiments_root = opt["path"].get("experiments_root")
    if experiments_root is None:
        experiments_root = osp.join(root_path, "experiments")
    experiments_root = osp.join(experiments_root, opt["name"])
    opt["path"]["experiments_root"] = experiments_root
    opt["path"]["models"] = osp.join(experiments_root, "models")
    opt["path"]["training_states"] = osp.join(experiments_root, "training_states")
    opt["path"]["log"] = experiments_root
    opt["path"]["visualization"] = osp.join(experiments_root, "visualization")
    if "debug" in opt["name"]:
        if "val" in opt:
            opt["val"]["val_freq"] = 8
        if "logger" in opt:
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    return opt, args


def copy_opt_file(opt_file: str, experiments_root: str) -> None:
    """Copy the config into the experiment dir with command-line provenance."""
    cmd = " ".join(sys.argv)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {cmd}\n\n")
        f.seek(0)
        f.writelines(lines)
