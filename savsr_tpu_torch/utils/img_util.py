"""Image file IO (numpy HWC BGR, as cv2 reads and writes it)."""

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
