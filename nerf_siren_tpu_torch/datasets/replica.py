"""Replica indoor-scan dataset (reference: datasets/replica.py).

Counterpart of `nerf_siren_tpu/datasets/replica.py` (cv2 is imported when
frames are read).

Parity points:
- poses from `traj_w_c.txt` (N, 4, 4) world-from-camera matrices,
- rgb / depth (uint16 mm → m) / semantic_class / semantic_instance PNGs,
- train = every `step`th of `total_num` frames, test = offset by step//2
  (reference replica.py:101-103),
- pinhole intrinsics from hfov=90°: fx = W / (2 tan(hfov/2)), cx,cy at the
  (W-1)/2 pixel center, near/far = 0.1/10 (reference replica.py:227-244),
- rays built in the OpenCV convention (x right, y down, z forward,
  reference replica.py:47-85), flattened into the (N, 8) buffer.
"""
from __future__ import annotations

import glob
import math
import os
from typing import Dict, Optional

import numpy as np

from nerf_siren_tpu_torch.datasets import register_dataset


def get_rays_camera(H: int, W: int, fx: float, fy: float, cx: float, cy: float,
                    convention: str = "opencv") -> np.ndarray:
    """Per-pixel camera-frame ray directions (H, W, 3)."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    if convention == "opencv":
        dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
    elif convention == "opengl":
        dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)
    else:
        raise ValueError(convention)
    return dirs


def create_rays(Ts_c2w: np.ndarray, H: int, W: int, fx: float, fy: float,
                cx: float, cy: float, near: float, far: float,
                convention: str = "opencv") -> np.ndarray:
    """(N_imgs, H*W, 8) world rays from (N_imgs, 4, 4) poses."""
    dirs_c = get_rays_camera(H, W, fx, fy, cx, cy, convention).reshape(-1, 3)
    out = []
    for T in Ts_c2w:
        R, t = T[:3, :3], T[:3, 3]
        d = dirs_c @ R.T
        o = np.broadcast_to(t, d.shape)
        n = d.shape[0]
        out.append(np.concatenate(
            [o, d, np.full((n, 1), near, np.float32),
             np.full((n, 1), far, np.float32)], -1).astype(np.float32))
    return np.stack(out)


@register_dataset("replica")
class ReplicaDatasetCache:
    n_classes = 102  # Replica semantic label space (0 = void)

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(640, 480), total_num: int = 900, step: int = 5, **kwargs):
        self.root_dir = root_dir
        self.split = split
        self.img_w, self.img_h = img_wh
        self.white_back = False
        self.convention = "opencv"

        self.set_params_replica()

        traj = np.loadtxt(os.path.join(root_dir, "traj_w_c.txt"), delimiter=" ")
        self.Ts_full = traj.reshape(-1, 4, 4)

        def listing(sub, prefix):
            files = glob.glob(os.path.join(root_dir, sub, f"{prefix}*.png"))
            return sorted(files, key=lambda f: int(f.split("_")[-1][:-4]))

        self.rgb_list = listing("rgb", "rgb")
        self.depth_list = listing("depth", "depth")
        self.semantic_list = listing("semantic_class", "semantic_class")
        self.instance_list = listing("semantic_instance", "semantic_instance")

        total_num = min(total_num, len(self.rgb_list))
        train_ids = list(range(0, total_num, step))
        test_ids = [min(x + step // 2, total_num - 1) for x in train_ids]
        self.train_ids, self.test_ids = train_ids, test_ids

        ids = train_ids if split == "train" else test_ids
        self._load_frames(ids)

    def set_params_replica(self):
        self.H, self.W = self.img_h, self.img_w
        self.hfov = 90.0
        self.fx = self.W / 2.0 / math.tan(math.radians(self.hfov / 2.0))
        self.fy = self.fx
        self.focal = self.fx
        self.cx = (self.W - 1.0) / 2.0
        self.cy = (self.H - 1.0) / 2.0
        self.near, self.far = 0.1, 10.0
        self.bounds = np.array([self.near, self.far], np.float32)

    def _load_frames(self, ids):
        import cv2

        from nerf_siren_tpu_torch.utils.data import parallel_map

        def load_one(idx):
            """cv2 decode/resize releases the GIL; frames load in parallel."""
            img = cv2.imread(self.rgb_list[idx])[:, :, ::-1] / 255.0
            if img.shape[:2] != (self.H, self.W):
                img = cv2.resize(img, (self.W, self.H), interpolation=cv2.INTER_LINEAR)
            depth = sem = None
            if self.depth_list:
                depth = cv2.imread(self.depth_list[idx], cv2.IMREAD_UNCHANGED) / 1000.0
                if depth.shape[:2] != (self.H, self.W):
                    depth = cv2.resize(depth, (self.W, self.H), interpolation=cv2.INTER_LINEAR)
                depth = depth.astype(np.float32)
            if self.semantic_list:
                sem = cv2.imread(self.semantic_list[idx], cv2.IMREAD_UNCHANGED)
                if sem.shape[:2] != (self.H, self.W):
                    sem = cv2.resize(sem, (self.W, self.H), interpolation=cv2.INTER_NEAREST)
                sem = sem.astype(np.int32)
            return img.astype(np.float32), depth, sem, self.Ts_full[idx]

        built = parallel_map(load_one, ids)
        self.poses = np.stack([b[3] for b in built])
        self.images = np.stack([b[0] for b in built])
        self.depths = (np.stack([b[1] for b in built])
                       if self.depth_list else None)
        self.semantics = (np.stack([b[2] for b in built])
                          if self.semantic_list else None)

        rays = create_rays(self.poses, self.H, self.W, self.fx, self.fy,
                           self.cx, self.cy, self.near, self.far, self.convention)
        n_imgs, n_px, _ = rays.shape
        self.all_rays = rays.reshape(n_imgs * n_px, 8)
        self.all_rgbs = self.images.reshape(n_imgs * n_px, 3)
        if self.semantics is not None:
            self.all_cls = self.semantics.reshape(n_imgs * n_px)
        self.n_images, self.n_px = n_imgs, n_px

    def __len__(self):
        if self.split == "train":
            return self.all_rays.shape[0]
        return self.n_images

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        if self.split == "train":
            s = {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
            if self.semantics is not None:
                s["cls"] = self.all_cls[idx]
            return s
        sl = slice(idx * self.n_px, (idx + 1) * self.n_px)
        s = {"rays": self.all_rays[sl], "rgbs": self.all_rgbs[sl]}
        if self.semantics is not None:
            s["cls"] = self.all_cls[sl]
        if self.depths is not None:
            s["depth"] = self.depths[idx].reshape(-1)
        return s
