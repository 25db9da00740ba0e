"""Video evaluation datasets (Vid4 / UDM10 / REDS4 / Vimeo90K-test).

The port's counterpart of ``savsr_tpu/data/video_test_dataset.py``
(lbasicsr/data/video_test_dataset.py): one item per frame, its window of
``num_frame`` LR frames and its GT frame. Image stacks are [T, H, W, C] RGB
float32 in [0, 1]; the item keys (lq, gt, folder, idx, border, lq_path,
scale) are the reference's, so the eval pipeline's per-folder, per-frame
bookkeeping is identical. The whole-clip test sets of the recurrent model
family are not ported yet (data/__init__.py NOT_PORTED).
"""

from __future__ import annotations

import os
from os import path as osp
from typing import Dict, List

import numpy as np

from ..utils.logger import get_root_logger
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .data_util import (
    arbitrary_scale_downsample,
    duf_downsample,
    generate_frame_indices,
    read_img_seq,
)
from .loader import Dataset


@DATASET_REGISTRY.register()
class VideoTestDataset(Dataset):
    """Windowed video test dataset over per-clip subfolders.

    opt keys: dataroot_gt, dataroot_lq, io_backend, cache_data, name,
    meta_info_file (optional), num_frame, padding; arbitrary-scale keys:
    use_arbitrary_scale_downsampling, downsampling_scale, downsampling_mode.
    """

    def __init__(self, opt: dict):
        self.opt = opt
        self.cache_data = opt["cache_data"]
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt.get("dataroot_lq")
        self.data_info: Dict[str, List] = {
            "lq_path": [], "gt_path": [], "folder": [], "idx": [], "border": []
        }
        if opt.get("io_backend", {}).get("type", "disk") == "lmdb":
            raise ValueError("No need to use lmdb during validation/test.")

        self.as_down = bool(opt.get("use_arbitrary_scale_downsampling"))
        self.scale = opt.get("downsampling_scale", opt.get("scale", 1))

        logger = get_root_logger()
        logger.info(f"Generate data info for VideoTestDataset - {opt['name']}")
        self.imgs_lq, self.imgs_gt = {}, {}
        if "meta_info_file" in opt and opt["meta_info_file"]:
            with open(opt["meta_info_file"], "r") as fin:
                subfolders = [line.split(" ")[0] for line in fin]
            subfolders_gt = [osp.join(self.gt_root, k) for k in subfolders]
            subfolders_lq = [
                osp.join(self.lq_root, k) if self.lq_root else None for k in subfolders
            ]
        else:
            subfolders_gt = sorted(
                osp.join(self.gt_root, d) for d in os.listdir(self.gt_root)
                if osp.isdir(osp.join(self.gt_root, d))
            )
            if self.lq_root and osp.isdir(self.lq_root):
                subfolders_lq = sorted(
                    osp.join(self.lq_root, d) for d in os.listdir(self.lq_root)
                    if osp.isdir(osp.join(self.lq_root, d))
                )
            else:
                subfolders_lq = [None] * len(subfolders_gt)
        if len(subfolders_lq) != len(subfolders_gt):
            subfolders_lq = [None] * len(subfolders_gt)

        for subfolder_lq, subfolder_gt in zip(subfolders_lq, subfolders_gt):
            subfolder_name = osp.basename(subfolder_gt)
            img_paths_gt = sorted(scandir(subfolder_gt, full_path=True))
            if subfolder_lq is not None and osp.isdir(subfolder_lq):
                img_paths_lq = sorted(scandir(subfolder_lq, full_path=True))
            else:
                img_paths_lq = img_paths_gt  # AS eval derives LQ from GT
            max_idx = len(img_paths_gt)

            self.data_info["lq_path"].extend(img_paths_lq)
            self.data_info["gt_path"].extend(img_paths_gt)
            self.data_info["folder"].extend([subfolder_name] * max_idx)
            self.data_info["idx"].extend(f"{i}/{max_idx}" for i in range(max_idx))
            border_l = [0] * max_idx
            for i in range(self.opt["num_frame"] // 2):
                border_l[i] = 1
                border_l[max_idx - i - 1] = 1
            self.data_info["border"].extend(border_l)

            if self.cache_data:
                if self.as_down:
                    self.imgs_gt[subfolder_name] = read_img_seq(
                        img_paths_gt, require_as_mod_crop=True, scale=self.scale
                    )
                    self.imgs_lq[subfolder_name] = self.imgs_gt[subfolder_name]
                else:
                    self.imgs_lq[subfolder_name] = read_img_seq(img_paths_lq)
                    self.imgs_gt[subfolder_name] = read_img_seq(img_paths_gt)
            else:
                self.imgs_lq[subfolder_name] = img_paths_lq
                self.imgs_gt[subfolder_name] = img_paths_gt

    def __getitem__(self, index: int):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]

        select_idx = generate_frame_indices(
            idx, max_idx, self.opt["num_frame"], padding=self.opt["padding"]
        )
        if self.cache_data:
            imgs_lq = self.imgs_lq[folder][np.asarray(select_idx)]
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq([self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]

        return {
            "lq": imgs_lq,
            "gt": img_gt,
            "folder": folder,
            "idx": self.data_info["idx"][index],
            "border": border,
            "lq_path": lq_path,
        }

    def __len__(self) -> int:
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class ASVideoTestDataset(VideoTestDataset):
    """Arbitrary-scale windowed test dataset: LQ windows are produced on the
    fly by as_mod_crop + asBI downsampling of the GT frames
    (reference video_test_dataset.py:272-328)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        if "downsampling_scale" in opt:
            self.opt["scale"] = opt["downsampling_scale"]

    def __getitem__(self, index: int):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]

        select_idx = generate_frame_indices(
            idx, max_idx, self.opt["num_frame"], padding=self.opt["padding"]
        )
        scale = self.opt["scale"]
        mode = self.opt.get("downsampling_mode", "torch")
        if self.cache_data:
            imgs_lq = self.imgs_gt[folder][np.asarray(select_idx)]
            imgs_lq = arbitrary_scale_downsample(imgs_lq, scale=scale, mode=mode)
            img_gt = self.imgs_gt[folder][idx]
        else:
            img_paths = [self.imgs_gt[folder][i] for i in select_idx]
            imgs_lq = read_img_seq(img_paths, require_as_mod_crop=True, scale=scale)
            if self.opt.get("use_arbitrary_scale_downsampling", True):
                imgs_lq = arbitrary_scale_downsample(imgs_lq, scale=scale, mode=mode)
            img_gt = read_img_seq(
                [self.imgs_gt[folder][idx]], require_as_mod_crop=True, scale=scale
            )[0]

        return {
            "lq": imgs_lq,
            "gt": img_gt,
            "folder": folder,
            "idx": self.data_info["idx"][index],
            "border": border,
            "lq_path": lq_path,
            "scale": scale,
        }


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset(Dataset):
    """Vimeo90K-test: one septuplet per item, center-frame GT
    (reference video_test_dataset.py:150-216)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.cache_data = opt["cache_data"]
        if self.cache_data:
            raise NotImplementedError("cache_data in Vimeo90K-Test is not implemented.")
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info: Dict[str, List] = {
            "lq_path": [], "gt_path": [], "folder": [], "idx": [], "border": []
        }
        neighbor_list = [
            i + (9 - opt["num_frame"]) // 2 for i in range(opt["num_frame"])
        ]
        with open(opt["meta_info_file"], "r") as fin:
            subfolders = [line.split(" ")[0] for line in fin]
        for idx, subfolder in enumerate(subfolders):
            gt_path = osp.join(self.gt_root, subfolder, "im4.png")
            self.data_info["gt_path"].append(gt_path)
            lq_paths = [
                osp.join(self.lq_root, subfolder, f"im{i}.png") for i in neighbor_list
            ]
            self.data_info["lq_path"].append(lq_paths)
            self.data_info["folder"].append("vimeo90k")
            self.data_info["idx"].append(f"{idx}/{len(subfolders)}")
            self.data_info["border"].append(0)

    def __getitem__(self, index: int):
        lq_path = self.data_info["lq_path"][index]
        gt_path = self.data_info["gt_path"][index]
        imgs_lq = read_img_seq(lq_path)
        img_gt = read_img_seq([gt_path])[0]
        return {
            "lq": imgs_lq,
            "gt": img_gt,
            "folder": self.data_info["folder"][index],
            "idx": self.data_info["idx"][index],
            "border": self.data_info["border"][index],
            "lq_path": lq_path[self.opt["num_frame"] // 2],
        }

    def __len__(self) -> int:
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class ASVideoTestVimeo90KDataset(VideoTestVimeo90KDataset):
    """Arbitrary-scale Vimeo90K-test (reference video_test_dataset.py:331-377):
    LQ = asBI(GT window), GT = center frame, both as_mod_cropped."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.scale = opt.get("downsampling_scale", opt.get("scale", 4))

    def __getitem__(self, index: int):
        lq_path = self.data_info["lq_path"][index]
        gt_path = self.data_info["gt_path"][index]
        imgs_lq = read_img_seq(lq_path, require_as_mod_crop=True, scale=self.scale)
        imgs_lq = arbitrary_scale_downsample(
            imgs_lq, scale=self.scale, mode=self.opt.get("downsampling_mode", "torch")
        )
        img_gt = read_img_seq([gt_path], require_as_mod_crop=True, scale=self.scale)[0]
        return {
            "lq": imgs_lq,
            "gt": img_gt,
            "folder": self.data_info["folder"][index],
            "idx": self.data_info["idx"][index],
            "border": self.data_info["border"][index],
            "lq_path": lq_path[self.opt["num_frame"] // 2],
            "scale": self.scale,
        }


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """DUF-protocol test set: LQ from GT by Gaussian BD downsampling or from
    bicubic folders (reference video_test_dataset.py:219-269)."""

    def __getitem__(self, index: int):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]
        scale = self.opt["scale"]
        scale = int(scale[0] if isinstance(scale, tuple) else scale)

        select_idx = generate_frame_indices(
            idx, max_idx, self.opt["num_frame"], padding=self.opt["padding"]
        )
        if self.opt["use_duf_downsampling"]:
            img_paths = [self.imgs_gt[folder][i] for i in select_idx]
            imgs_lq = read_img_seq(img_paths, require_mod_crop=True, scale=scale)
            imgs_lq = duf_downsample(imgs_lq, kernel_size=13, scale=scale)
        else:
            img_paths = [self.imgs_lq[folder][i] for i in select_idx]
            imgs_lq = read_img_seq(img_paths)
        img_gt = read_img_seq(
            [self.imgs_gt[folder][idx]], require_mod_crop=True, scale=scale
        )[0]

        return {
            "lq": imgs_lq,
            "gt": img_gt,
            "folder": folder,
            "idx": self.data_info["idx"][index],
            "border": border,
            "lq_path": lq_path,
        }
