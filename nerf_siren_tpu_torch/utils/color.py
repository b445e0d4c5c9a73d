"""Semantic class-map visualization.

Counterpart of `nerf_siren_tpu/utils/color.py`, in numpy: the machine of the
card has no cv2. `colorize_cls` paints a class map with the fixed 23-colour
palette; `color_cls` blends it over an rgb image as `cv2.addWeighted(image,
0.4, colours, 0.6, 0)` does for uint8 (float32 weights, rounded to the
nearest, saturated), and writes the three PNGs of the JAX function with
`imageio`, pixel for pixel the files cv2 writes there.
"""
from __future__ import annotations

import os

import numpy as np

PART_COLORS = np.asarray(
    [[255, 0, 0], [255, 0, 255], [255, 170, 0],
     [255, 0, 85], [255, 0, 170],
     [0, 255, 0], [85, 255, 0], [170, 255, 0],
     [0, 255, 85], [0, 255, 170],
     [0, 0, 255], [85, 0, 255], [170, 0, 255],
     [0, 85, 255], [0, 170, 255],
     [255, 255, 0], [255, 255, 85], [255, 255, 170],
     [255, 85, 255], [255, 170, 255],
     [0, 255, 255], [85, 255, 255], [170, 255, 255]], np.uint8)


def colorize_cls(pred_map: np.ndarray) -> np.ndarray:
    """(H, W) int class map -> (H, W, 3) uint8 colour map: class 0 (and any
    negative id) black, class i >= 1 `PART_COLORS[i % 23]` (the palette
    cycles past its 23 colours)."""
    pred = np.asarray(pred_map).astype(np.int64)
    colors = PART_COLORS[pred % len(PART_COLORS)]
    return np.where((pred >= 1)[..., None], colors, 0).astype(np.uint8)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """`cv2.addWeighted(a, alpha, b, beta, 0)` of two uint8 images: float32
    sums rounded half to even and saturated to uint8."""
    s = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def color_cls(img: np.ndarray, pred_map: np.ndarray, savedir: str,
              prefix: str = "") -> np.ndarray:
    """Write `<prefix>pred_map.png`, `<prefix>img_color.png` and
    `<prefix>img_raw.png` into `savedir` as the JAX function does, and
    return the overlay (RGB uint8).

    img: (H, W, 3) uint8 RGB; pred_map: (H, W) int classes. The JAX function
    hands cv2 the palette colours as BGR, so its class colours land on disk
    with red and blue swapped; so do these."""
    import imageio

    os.makedirs(savedir, exist_ok=True)
    vis_im = np.asarray(img).astype(np.uint8)
    pred_color = colorize_cls(pred_map)
    overlay_bgr = add_weighted(vis_im[..., ::-1], 0.4, pred_color, 0.6)
    imageio.imwrite(os.path.join(savedir, prefix + "pred_map.png"),
                    np.ascontiguousarray(pred_color[..., ::-1]))
    imageio.imwrite(os.path.join(savedir, prefix + "img_color.png"),
                    np.ascontiguousarray(overlay_bgr[..., ::-1]))
    imageio.imwrite(os.path.join(savedir, prefix + "img_raw.png"), vis_im)
    return np.ascontiguousarray(overlay_bgr[..., ::-1])
