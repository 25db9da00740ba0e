"""Image file IO (numpy HWC BGR, as cv2 reads and writes it) and the
float -> uint8 image conversion of the eval pipeline."""

from __future__ import annotations

import os

import cv2
import numpy as np


def imfrombytes(content: bytes, float32: bool = False) -> np.ndarray:
    """Decode a colour image from bytes as HWC BGR (uint8, or float32 in
    [0, 1])."""
    img = cv2.imdecode(np.frombuffer(content, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("cannot decode image bytes")
    return img.astype(np.float32) / 255.0 if float32 else img


def imread(path: str, float32: bool = False) -> np.ndarray:
    """Read a colour image as HWC BGR (uint8, or float32 in [0, 1])."""
    with open(path, "rb") as f:
        content = f.read()
    try:
        return imfrombytes(content, float32)
    except IOError:
        raise IOError(f"cannot decode image {path}") from None


def imwrite(img: np.ndarray, file_path: str, params=None, auto_mkdir: bool = True) -> None:
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    if not cv2.imwrite(file_path, img, params if params is not None else []):
        raise IOError(f"Failed writing image to {file_path}")


def array2img(arr, rgb2bgr: bool = True, out_type=np.uint8, min_max=(0, 1)):
    """Channel-last RGB float array(s) -> displayable numpy image(s) (the
    JAX package's ``array2img``, the reference's tensor2img): accepts HW, HWC
    or NHWC (N squeezed if 1); clamps to ``min_max``, rescales to [0, 1],
    flips RGB to BGR, and for uint8 multiplies by 255 and rounds (half to
    even), so metric inputs are bit-identical to the reference's."""
    single = not isinstance(arr, (list, tuple))
    result = []
    for a in [arr] if single else list(arr):
        a = np.asarray(a, dtype=np.float32)
        if a.ndim == 4:
            if a.shape[0] != 1:
                raise ValueError("array2img expects batch size 1 for 4D input")
            a = a[0]
        a = np.clip(a, min_max[0], min_max[1])
        a = (a - min_max[0]) / (min_max[1] - min_max[0])
        if a.ndim == 3:
            if a.shape[2] == 1:
                a = a[..., 0]
            elif rgb2bgr:
                a = a[..., ::-1]
        if out_type == np.uint8:
            a = (a * 255.0).round()
        result.append(np.ascontiguousarray(a.astype(out_type)))
    return result[0] if single else result


def crop_border(imgs, crop_border: int):
    """Crop ``crop_border`` pixels from each edge of HWC image(s)."""
    if crop_border == 0:
        return imgs
    if isinstance(imgs, list):
        return [v[crop_border:-crop_border, crop_border:-crop_border, ...] for v in imgs]
    return imgs[crop_border:-crop_border, crop_border:-crop_border, ...]
