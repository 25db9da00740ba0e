"""Geometric transforms: mod-crops, random crops, flip/rot augmentation.

The port's own copy of ``savsr_tpu/data/transforms.py``; semantics mirror
lbasicsr/data/transforms.py (channel-last numpy arrays;
the arbitrary-scale ``as_mod_crop``/``cal_step`` pair guarantees that
``round(h/step/s)*step*s`` is integral so the LR size is exact).
"""

from __future__ import annotations

import random
from math import floor
from typing import List, Tuple, Union

import numpy as np

Scale = Union[Tuple[float, float], float]


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of ``scale`` (integer-scale testing)."""
    img = img.copy()
    if img.ndim in (2, 3):
        h, w = img.shape[0], img.shape[1]
        img = img[: h - h % scale, : w - w % scale, ...]
    else:
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    return img


def cal_step(scale: float) -> int:
    """Smallest step in {1,2,5,10,20,50} with ``scale*step`` integral."""
    for step in (1, 2, 5, 10, 20, 50):
        if abs(scale * step - round(scale * step)) < 0.001 * step:
            return step
    raise ValueError(f"No valid step for scale {scale}")


def as_mod_crop(img: np.ndarray, scale: Scale) -> np.ndarray:
    """Arbitrary-scale mod crop: crop H,W so that H/s and W/s are integral."""
    if not isinstance(scale, tuple):
        scale = (scale, scale)
    step_h = cal_step(scale[0])
    step_w = cal_step(scale[1])
    img = img.copy()
    if img.ndim in (2, 3):
        h, w = img.shape[0], img.shape[1]
        h = round(floor(h / step_h / scale[0]) * step_h * scale[0])
        w = round(floor(w / step_w / scale[1]) * step_w * scale[1])
        img = img[:h, :w, ...]
    else:
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    return img


def single_random_crop(
    imgs: Union[np.ndarray, List[np.ndarray]], patch_size: Tuple[int, int], rng=random
):
    """Randomly crop the same (top, left) window from every image.

    Images are channel-last [..., H, W, C] numpy arrays; leading dims allowed.
    ``rng``: a ``random.Random`` (default: the module's global generator).
    """
    single = not isinstance(imgs, list)
    img_list = [imgs] if single else imgs
    h, w = img_list[0].shape[-3], img_list[0].shape[-2]
    ph, pw = patch_size
    if h < ph or w < pw:
        raise ValueError(f"Image ({h}x{w}) smaller than patch ({ph}x{pw})")
    top = rng.randint(0, h - ph)
    left = rng.randint(0, w - pw)
    out = [v[..., top : top + ph, left : left + pw, :] for v in img_list]
    return out[0] if single else out


def paired_random_crop(
    img_gts, img_lqs, gt_patch_size: int, scale: int, gt_path: str = "", rng=random
):
    """Paired random crop for fixed integer scale (GT window = scale * LQ)."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    gts = [img_gts] if single_gt else img_gts
    lqs = [img_lqs] if single_lq else img_lqs

    h_lq, w_lq = lqs[0].shape[-3], lqs[0].shape[-2]
    h_gt, w_gt = gts[0].shape[-3], gts[0].shape[-2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x of LQ "
            f"({h_lq}, {w_lq}). {gt_path}"
        )
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(
            f"LQ ({h_lq}, {w_lq}) smaller than patch size {lq_patch_size}. {gt_path}"
        )
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    lqs = [v[..., top : top + lq_patch_size, left : left + lq_patch_size, :] for v in lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    gts = [
        v[..., top_gt : top_gt + gt_patch_size, left_gt : left_gt + gt_patch_size, :]
        for v in gts
    ]
    return (gts[0] if single_gt else gts), (lqs[0] if single_lq else lqs)


def augment(
    imgs,
    hflip: bool = True,
    rotation: bool = True,
    flows=None,
    return_status: bool = False,
    rng=random,
):
    """Random horizontal flip / vertical flip / 90-degree transpose; the same
    draw applies to all images in the list (HWC numpy)."""
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img: np.ndarray) -> np.ndarray:
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    def _augment_flow(flow: np.ndarray) -> np.ndarray:
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    single = not isinstance(imgs, list)
    imgs = [imgs] if single else imgs
    imgs = [_augment(img) for img in imgs]
    if single:
        imgs = imgs[0]

    if flows is not None:
        single_f = not isinstance(flows, list)
        flows = [flows] if single_f else flows
        flows = [_augment_flow(f) for f in flows]
        if single_f:
            flows = flows[0]
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs
