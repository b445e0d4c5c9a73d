"""LLFF forward-facing dataset loader (fern, flower, ...).

Counterpart of `nerf_siren_tpu/datasets/llff.py` (PIL is imported when an
image is read). Behavioral parity with the reference loader (reference: datasets/llff.py:159-318):
- poses_bounds.npy (N, 17) → (3, 5) pose+hwf and 2 depth bounds per image,
- focal rescaled to target resolution,
- axis convention fix "down right back" → "right up back",
- poses centered by the inverse average pose,
- global scale so the nearest depth sits at 1/0.75 ≈ 1.33,
- forward-facing: NDC rays with near plane 1.0 and near/far = 0/1,
  spheric: world rays with near = bounds.min(), far = min(8*near, bounds.max()),
- val image = pose closest to center; test split renders a spiral
  (forward-facing) or a downward circle (spheric) path.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from nerf_siren_tpu_torch.datasets import register_dataset
from nerf_siren_tpu_torch.datasets.poses import (
    center_poses,
    create_spheric_poses,
    create_spiral_poses,
)
from nerf_siren_tpu_torch.datasets.ray_utils import get_ndc_rays, get_ray_directions, get_rays


def _load_rgb(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(img_wh, Image.LANCZOS)
    return (np.asarray(img, np.float32) / 255.0).reshape(-1, 3)


@register_dataset("llff")
class LLFFDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 img_wh: Tuple[int, int] = (504, 378),
                 spheric_poses: bool = False, val_num: int = 1, **kwargs):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.spheric_poses = spheric_poses
        self.val_num = max(1, val_num)
        self.white_back = False
        self.read_meta()

    # -- geometry --------------------------------------------------------------

    def read_meta(self):
        poses_bounds = np.load(os.path.join(self.root_dir, "poses_bounds.npy"))
        self.image_paths = sorted(glob.glob(os.path.join(self.root_dir, "images/*")))
        if self.split in ("train", "val"):
            assert len(poses_bounds) == len(self.image_paths), \
                "Mismatch between number of images and number of poses!"

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, -2:]

        H, W, self.focal = poses[0, :, -1]
        assert H * self.img_wh[0] == W * self.img_wh[1], \
            f"img_wh must keep the original aspect ratio ({W}, {H})!"
        self.focal *= self.img_wh[0] / W

        # "down right back" -> "right up back"
        poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)
        distances = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(distances))

        near_original = self.bounds.min()
        scale_factor = near_original * 0.75
        self.bounds /= scale_factor
        self.poses[..., 3] /= scale_factor

        self.directions = get_ray_directions(self.img_wh[1], self.img_wh[0], self.focal)

        if self.split == "train":
            from nerf_siren_tpu_torch.utils.data import parallel_map

            train_ids = [i for i in range(len(self.image_paths))
                         if i != self.val_idx]
            built = parallel_map(
                lambda i: (_load_rgb(self.image_paths[i], self.img_wh),
                           self._rays_for_pose(self.poses[i])),
                train_ids)
            self.all_rays = np.concatenate([b[1] for b in built], 0)
            self.all_rgbs = np.concatenate([b[0] for b in built], 0)
        elif self.split == "val":
            self.c2w_val = self.poses[self.val_idx]
            self.image_path_val = self.image_paths[self.val_idx]
        else:
            if self.split.endswith("train"):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def _rays_for_pose(self, c2w: np.ndarray) -> np.ndarray:
        rays_o, rays_d = get_rays(self.directions, np.asarray(c2w, np.float32))
        if not self.spheric_poses:
            near, far = 0.0, 1.0
            rays_o, rays_d = get_ndc_rays(self.img_wh[1], self.img_wh[0],
                                          self.focal, 1.0, rays_o, rays_d)
        else:
            near = self.bounds.min()
            far = min(8 * near, self.bounds.max())
        n = rays_o.shape[0]
        return np.concatenate(
            [rays_o, rays_d,
             np.full((n, 1), near, np.float32),
             np.full((n, 1), far, np.float32)], 1)

    # -- dataset protocol ------------------------------------------------------

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return self.val_num
        return len(self.poses_test)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}

        if self.split == "val":
            c2w = self.c2w_val
        else:
            c2w = self.poses_test[idx]

        sample = {"rays": self._rays_for_pose(c2w), "c2w": np.asarray(c2w, np.float32)}
        if self.split == "val":
            sample["rgbs"] = _load_rgb(self.image_path_val, self.img_wh)
        return sample
