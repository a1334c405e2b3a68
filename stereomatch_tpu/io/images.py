"""Host-side image I/O and color conversion.

Replaces the reference's lodepng path (`loadPNG`/`savePNG`/`imgCharToFloat`,
src/PatchMatchStereoGPU.cu:9414-9477, include/lodepng.h) and cv::imread /
imwrite usage with PIL-backed loading (Pillow is the optional `io`
extra: it is imported on the first load or save, so the rest of the
package runs without it). Images are kept as float32 arrays in
[0, 255], channel-last RGB, matching the numeric ranges the reference
kernels operate in.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "load_image",
    "save_image",
    "save_disparity_png",
    "to_gray",
    "to_planar",
    "normalize01",
]

# OpenCV BGR2GRAY weights; the reference computes gray as
# 0.114*B + 0.587*G + 0.299*R (src/PatchMatchStereoGPU.cu:1531-1539).
_GRAY_R, _GRAY_G, _GRAY_B = 0.299, 0.587, 0.114


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "image file I/O needs Pillow: pip install 'stereomatch-tpu[io]'"
        ) from e
    return Image


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32. RGB (H, W, 3) in [0,255], or (H, W) gray."""
    img = _pil_image().open(path)
    if gray:
        img = img.convert("L")
        return np.asarray(img, dtype=np.float32)
    img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32)


def save_image(path: str, img: np.ndarray) -> None:
    arr = np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8)
    _pil_image().fromarray(arr).save(path)


def save_disparity_png(path: str, disp: np.ndarray, max_disp: float | None = None) -> None:
    """Save a disparity map as 8-bit PNG, scaled by 255/max_disp (the
    reference writes 8-bit disparity PNGs: build/left_disparity.png)."""
    d = np.asarray(disp, dtype=np.float32)
    if max_disp is None:
        max_disp = float(d.max()) or 1.0
    save_image(path, d * (255.0 / max_disp))


def to_gray(rgb: np.ndarray | "object") -> "object":
    """Luma conversion with OpenCV weights. Works on numpy or jax arrays,
    (..., H, W, 3) -> (..., H, W)."""
    return _GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2]


def to_planar(rgb: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (C, H, W) planar float (ref: imgCharToFloat,
    src/PatchMatchStereoGPU.cu:9456-9477)."""
    return np.ascontiguousarray(np.moveaxis(rgb, -1, 0))


def normalize01(img: "object") -> "object":
    return img * (1.0 / 255.0)
