"""Blender + semantic labels, image-batch mode

Counterpart of `nerf_siren_tpu/datasets/blender_cls.py` (cv2 and PIL are
imported when a label is read).
(reference: datasets/blender.py:118-262 BlenderDatasetWithClsBatch).

Parity points:
- labels load from a `labels/` dir next to the images, stored as
  class-id × 10 PNGs, decoded by /10 and nearest-resized
  (reference blender.py:163-175),
- returns whole-image (H·W, ...) slabs per item for image-batch training,
- optional random crop mode returns crop_size² windows
  (reference blender.py:200-215).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_siren_tpu_torch.datasets import register_dataset
from nerf_siren_tpu_torch.datasets.blender import BlenderDataset, _load_blended_image
from nerf_siren_tpu_torch.datasets.ray_utils import get_rays


@register_dataset("blender_cls_ib")
class BlenderClsImgBatchDataset(BlenderDataset):
    n_classes = 6

    def __init__(self, root_dir, split="train", img_wh=(800, 800),
                 is_crop: bool = False, crop_size: int = 32, **kwargs):
        self.is_crop = is_crop
        self.crop_size = crop_size
        self._crop_rng = np.random.default_rng(0)
        super().__init__(root_dir, split, img_wh, **kwargs)

    def _label_path(self, frame) -> str:
        name = os.path.basename(frame["file_path"])
        return os.path.join(self.root_dir, "labels", f"{name}.png")

    def _load_label(self, path: str) -> np.ndarray:
        import cv2
        from PIL import Image

        lab = np.asarray(Image.open(path), np.float64) / 10.0
        lab = cv2.resize(lab, self.img_wh, interpolation=cv2.INTER_NEAREST)
        return lab.reshape(-1).astype(np.int32)

    def read_meta(self):
        super().read_meta()
        if self.split == "train":
            from nerf_siren_tpu_torch.utils.data import parallel_map

            labels = parallel_map(
                lambda frame: self._load_label(self._label_path(frame)),
                self.meta["frames"])
            self.all_cls = np.concatenate(labels, 0)
            w, h = self.img_wh
            self.n_px = w * h
            self.n_images = len(self.meta["frames"])

    def __len__(self):
        if self.split == "train":
            return self.n_images
        return super().__len__()

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        if self.split != "train":
            sample = super().__getitem__(idx)
            path = self._label_path(self.meta["frames"][idx])
            if os.path.exists(path):
                sample["cls"] = self._load_label(path)
            return sample

        sl = slice(idx * self.n_px, (idx + 1) * self.n_px)
        rays = self.all_rays[sl]
        rgbs = self.all_rgbs[sl]
        cls = self.all_cls[sl]
        if self.is_crop:
            w, h = self.img_wh
            c = self.crop_size
            x0 = int(self._crop_rng.integers(0, w - c + 1))
            y0 = int(self._crop_rng.integers(0, h - c + 1))
            pix = (np.arange(y0, y0 + c)[:, None] * w +
                   np.arange(x0, x0 + c)[None, :]).reshape(-1)
            rays, rgbs, cls = rays[pix], rgbs[pix], cls[pix]
        return {"rays": rays, "rgbs": rgbs, "cls": cls}

    def image_batches(self, batch_size: int = 1, seed: int = 0, epoch: int = 0):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(self.n_images)
        for b in range(0, self.n_images - batch_size + 1, batch_size):
            sel = order[b:b + batch_size]
            items = [self[int(i)] for i in sel]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
