"""Vimeo90K training datasets, including the shipped arbitrary-scale one.

The port's counterpart of ``savsr_tpu/data/vimeo90k_dataset.py`` (mirrors
lbasicsr/data/vimeo90k_dataset.py). The AS variant loads GT-only septuplets
and defers degradation to a batch-level collate hook (``as_collate_fn``):
one (scale_h, scale_w) is drawn per batch (with the epoch-gated curriculum),
the GT batch is cropped to (round(lq_size*sh), round(lq_size*sw)) and
bicubic-downsampled on the fly. Samples and batches are channel-last numpy
([T, H, W, C] RGB in [0, 1]), as in the JAX package; the model moves them to
the device and to NCHW.

Every random draw comes from the dataset's own generators, seeded from the
entries that ``build_dataset`` puts into the options: crops, flips and
reversals from ``rng`` (``seed``: manual_seed + rank, so the ranks of a
world draw apart), and in a loader the one scale of each batch from
``scale_rng`` (``scale_seed``: manual_seed, so every rank draws the scale
sequence of a one-process run and a global step has one scale). A direct
``as_collate_fn(batch)`` without a scale draws it from ``rng``, as the JAX
package draws everything from one stream.
"""

from __future__ import annotations

import random
from os import path as osp
from typing import Dict, List

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes
from ..utils.logger import get_root_logger
from ..utils.registry import DATASET_REGISTRY
from .data_util import arbitrary_scale_downsample
from .loader import Dataset
from .transforms import augment, paired_random_crop, single_random_crop

# 30 symmetric (x1.1..x4.0) + 30 asymmetric (h, w) pairs — the training
# scale pool (reference vimeo90k_dataset.py:178-202)
SYM_SCALES = [round(1.1 + 0.1 * i, 1) for i in range(30)]
ASYM_H = [1.5] * 5 + [2.0] * 5 + [2.5] * 5 + [3.0] * 5 + [3.5] * 5 + [4.0] * 5
ASYM_W = (
    [2.0, 2.5, 3.0, 3.5, 4.0]
    + [1.5, 2.5, 3.0, 3.5, 4.0]
    + [1.5, 2.0, 3.0, 3.5, 4.0]
    + [1.5, 2.0, 2.5, 3.5, 4.0]
    + [1.5, 2.0, 2.5, 3.0, 4.0]
    + [1.5, 2.0, 2.5, 3.0, 3.5]
)
SCALE_H_LIST = SYM_SCALES + ASYM_H
SCALE_W_LIST = SYM_SCALES + ASYM_W


@DATASET_REGISTRY.register()
class Vimeo90KDataset(Dataset):
    """Fixed-scale paired Vimeo90K dataset (reference vimeo90k_dataset.py:13).

    opt keys: dataroot_gt, dataroot_lq, meta_info_file, io_backend, num_frame,
    gt_size, scale, use_hflip, use_rot, random_reverse.
    """

    def __init__(self, opt: dict):
        self.opt = opt
        self.rng = random.Random(opt.get("seed"))
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt.get("dataroot_lq")
        with open(opt["meta_info_file"], "r") as fin:
            self.keys = [line.split(" ")[0] for line in fin]
        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        num_frame = opt["num_frame"]
        self.neighbor_list = [i + (9 - num_frame) // 2 for i in range(num_frame)]
        self.random_reverse = opt.get("random_reverse", False)
        get_root_logger().info(
            f"Vimeo90K dataset: {len(self.keys)} keys; "
            f"random reverse is {self.random_reverse}.")

    def _read(self, path: str) -> np.ndarray:
        if self.file_client is None:
            opt = dict(self.io_backend_opt)
            self.file_client = FileClient(opt.pop("type"), **opt)
        return imfrombytes(self.file_client.get(path), float32=True)

    def _maybe_reverse(self) -> None:
        if self.random_reverse and self.rng.random() < 0.5:
            self.neighbor_list.reverse()

    def __getitem__(self, index: int):
        self._maybe_reverse()
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip, seq = key.split("/")
        img_gt_path = osp.join(self.gt_root, clip, seq, "im4.png")
        img_gt = self._read(img_gt_path)
        img_lqs = [self._read(osp.join(self.lq_root, clip, seq, f"im{n}.png"))
                   for n in self.neighbor_list]
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, gt_size, scale, img_gt_path,
                                             rng=self.rng)
        img_lqs.append(img_gt)
        img_results = augment(img_lqs, self.opt["use_hflip"], self.opt["use_rot"], rng=self.rng)
        # BGR (cv2) -> RGB, stack [T, H, W, C]
        img_results = [np.ascontiguousarray(v[..., ::-1], dtype=np.float32) for v in img_results]
        return {"lq": np.stack(img_results[:-1], axis=0), "gt": img_results[-1], "key": key}

    def __len__(self) -> int:
        return len(self.keys)


@DATASET_REGISTRY.register()
class ASVimeo90KDataset(Vimeo90KDataset):
    """Arbitrary-scale Vimeo90K training set (the shipped trainer's dataset,
    reference vimeo90k_dataset.py:151-309): GT-only septuplets + batch-level
    scale sampling in ``as_collate_fn``."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        if opt.get("degrade_on_device", False):
            raise NotImplementedError("degrade_on_device is not ported yet")
        self.epoch = 0
        self.init_int_scale = opt.get("init_int_scale", False)
        self.single_scale_ft = opt.get("single_scale_ft", False)
        self.CL_train_set = opt.get("CL_train_set", None)
        self.lq_size = opt.get("lq_size", 60)
        self.scale_rng = random.Random(opt.get("scale_seed", opt.get("seed")))
        self.max_scale = opt.get("max_scale", 4)
        if opt.get("only_sy_scale", False):
            self.scale_h_list = list(SYM_SCALES)
            self.scale_w_list = list(SYM_SCALES)
        else:
            self.scale_h_list = list(SCALE_H_LIST)
            self.scale_w_list = list(SCALE_W_LIST)
        if "scale_h_list" in opt and "scale_w_list" in opt:
            self.scale_h_list = opt["scale_h_list"]
            self.scale_w_list = opt["scale_w_list"]

    def __getitem__(self, index: int):
        self._maybe_reverse()
        key = self.keys[index]
        clip, seq = key.split("/")
        img_gts = [self._read(osp.join(self.gt_root, clip, seq, f"im{n}.png"))
                   for n in self.neighbor_list]
        patch = self.lq_size * self.max_scale
        img_gts = single_random_crop(img_gts, (patch, patch), rng=self.rng)
        img_gts = augment(img_gts, self.opt["use_hflip"], self.opt["use_rot"], rng=self.rng)
        img_gts = np.stack(
            [np.ascontiguousarray(v[..., ::-1], dtype=np.float32) for v in img_gts], axis=0)
        return {"gt": img_gts, "key": key}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _pool_draw(self, rng):
        i = rng.randrange(0, len(self.scale_h_list))
        return self.scale_h_list[i], self.scale_w_list[i]

    def cl_train_stg(self, rng):
        """Curriculum draw (reference vimeo90k_dataset.py:248-264):
        CL_train_set=[E, a, b]; past epoch E -> full pool; within each
        10-epoch cycle: first a epochs x4, then integer x2-4, then full pool."""
        if self.epoch >= self.CL_train_set[0]:
            return self._pool_draw(rng)
        m = self.epoch % 10
        if m <= self.CL_train_set[1]:
            return 4, 4
        if self.CL_train_set[1] < m <= self.CL_train_set[2]:
            s = rng.randint(2, 4)
            return s, s
        return self._pool_draw(rng)

    def draw_scale(self, rng=None):
        """One batch's (scale_h, scale_w), from ``rng`` (default: ``self.rng``)."""
        rng = self.rng if rng is None else rng
        if self.CL_train_set is not None:
            return self.cl_train_stg(rng)
        if self.single_scale_ft:
            return self.opt["scale"][0], self.opt["scale"][1]
        if self.epoch == 0 and self.init_int_scale:
            s = rng.randint(2, 4)
            return s, s
        return self._pool_draw(rng)

    def batch_draws(self) -> Dict:
        """The loader's per-batch draw: the batch's scale, from ``scale_rng``."""
        return {"scale": self.draw_scale(self.scale_rng)}

    def as_collate_fn(self, batch: List[Dict], scale=None) -> Dict:
        """Batch-level arbitrary-scale degradation (reference
        vimeo90k_dataset.py:266-309): stack GTs, draw one scale (unless the
        loader drew it), crop GT to (round(lq*sh), round(lq*sw)),
        asBI-downsample to the LQ batch, keep only the center GT frame."""
        out: Dict = {"key": [d["key"] for d in batch]}
        gt = np.stack([d["gt"] for d in batch], axis=0)  # [B, T, H, W, C]
        scale_h, scale_w = self.draw_scale() if scale is None else scale
        lq_size = self.opt["lq_size"]
        gt_size = (round(lq_size * scale_h), round(lq_size * scale_w))
        b, t, h, w, c = gt.shape
        gt = single_random_crop(gt.reshape(b * t, h, w, c), gt_size, rng=self.rng)
        gt = gt.reshape(b, t, *gt.shape[1:])
        out["gt"] = gt[:, t // 2]
        lq = arbitrary_scale_downsample(gt, (scale_h, scale_w),
                                        self.opt.get("downsample_mode", "torch"))
        out["lq"] = np.ascontiguousarray(lq)
        out["scale"] = (scale_h, scale_w)
        return out
