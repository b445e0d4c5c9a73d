"""Blender-synthetic (NeRF lego/chair/...) dataset loader.

Counterpart of `nerf_siren_tpu/datasets/blender.py` (PIL is imported when
an image is read). Behavioral parity with the reference loader (reference: datasets/blender.py:12-116):
- focal = 0.5 * 800 / tan(camera_angle_x / 2), rescaled to img_wh,
- near/far = 2.0/6.0, white background,
- RGBA images blended to white: rgb*a + (1-a),
- train split precomputes ALL rays + rgbs into flat numpy buffers,
- val/test return per-image rays with an alpha>0 valid mask.

Deliberate divergence: the reference reads `frames[0]`'s pose for every
training frame (reference: datasets/blender.py:50-52) — a fork bug vs its
upstream (kwea123/nerf_pl) that collapses all training cameras into one. We
use each frame's own transform_matrix, matching upstream and the published
PSNR numbers.

This is host-side numpy; arrays feed the device through the batch iterator
of `training/system.py::epoch_iterator`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_siren_tpu_torch.datasets import register_dataset
from nerf_siren_tpu_torch.datasets.ray_utils import get_ray_directions, get_rays


def _load_blended_image(path: str, img_wh: Tuple[int, int]):
    """Returns (rgb (h*w, 3) white-blended, alpha (h*w,))."""
    from PIL import Image

    img = Image.open(path)
    img = img.resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0  # (h, w, 4) or (h, w, 3)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        rgb = rgb * a + (1.0 - a)
        alpha = a[..., 0]
    else:
        rgb = arr[..., :3]
        alpha = np.ones(arr.shape[:2], np.float32)
    return rgb.reshape(-1, 3), alpha.reshape(-1)


@register_dataset("blender")
class BlenderDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 img_wh: Tuple[int, int] = (800, 800), **kwargs):
        assert img_wh[0] == img_wh[1], "image width must equal image height!"
        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.white_back = True
        self.read_meta()

    def read_meta(self):
        with open(os.path.join(self.root_dir, f"transforms_{self.split}.json")) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800

        self.near, self.far = 2.0, 6.0
        self.bounds = np.array([self.near, self.far], np.float32)
        self.directions = get_ray_directions(h, w, self.focal)

        if self.split == "train":
            from nerf_siren_tpu_torch.utils.data import parallel_map

            def build(frame):
                """Per-frame decode + ray precompute; PIL/numpy release
                the GIL, so frames load in parallel threads."""
                c2w = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
                image_path = os.path.join(self.root_dir,
                                          f"{frame['file_path']}.png")
                rgb, _ = _load_blended_image(image_path, self.img_wh)
                rays_o, rays_d = get_rays(self.directions, c2w)
                n = rays_o.shape[0]
                rays = np.concatenate(
                    [rays_o, rays_d,
                     np.full((n, 1), self.near, np.float32),
                     np.full((n, 1), self.far, np.float32)], 1)
                return c2w, image_path, rays, rgb

            built = parallel_map(build, self.meta["frames"])
            self.poses = np.stack([b[0] for b in built], 0)
            self.image_paths = [b[1] for b in built]
            self.all_rays = np.concatenate([b[2] for b in built], 0)
            self.all_rgbs = np.concatenate([b[3] for b in built], 0)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(8, len(self.meta["frames"]))  # reference: 8 val images
        return len(self.meta["frames"])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}

        frame = self.meta["frames"][idx]
        c2w = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        image_path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        rgb, alpha = _load_blended_image(image_path, self.img_wh)
        rays_o, rays_d = get_rays(self.directions, c2w)
        n = rays_o.shape[0]
        rays = np.concatenate(
            [rays_o, rays_d,
             np.full((n, 1), self.near, np.float32),
             np.full((n, 1), self.far, np.float32)], 1)
        return {"rays": rays, "rgbs": rgb, "c2w": c2w,
                "valid_mask": alpha > 0}
