"""LLFF + face-parsing labels dataset (reference: datasets/llff_cls.py).

Counterpart of `nerf_siren_tpu/datasets/llff_cls.py` (cv2 and PIL are
imported when a label is read).

Parity points:
- the CelebAMask-style 18-attribute map is merged to 5 classes
  (skin/face/neck/head/cloth, reference llff_cls.py:16-51),
- stored label PNGs encode attribute-id × 10 (convert_pred scale,
  reference llff_cls.py:53-62),
- only the hand-picked `edited_ids` frames carry edited labels
  (reference llff_cls.py:72-74); labels load from `edit_parse/{name}.png`
  (train) or `raw_parse/` (val), nearest-resized,
- geometry is the plain LLFF pipeline (poses_bounds → center → NDC rays).

The image-batch ('_ib') variant returns whole-image slabs for systems that
batch by image (reference llff_cls.py:319-378); with the flat-ray training
pipeline it shares this implementation through `image_batches()`.
"""
from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from nerf_siren_tpu_torch.datasets import register_dataset
from nerf_siren_tpu_torch.datasets.llff import LLFFDataset, _load_rgb

ATTS = ['skin', 'l_brow', 'r_brow', 'l_eye', 'r_eye', 'eye_g', 'l_ear',
        'r_ear', 'ear_r', 'nose', 'mouth', 'u_lip', 'l_lip', 'neck',
        'neck_l', 'cloth', 'hair', 'hat']
NEW_ATTS = ['skin', 'face', 'face', 'face', 'face', 'face', 'head', 'head',
            'head', 'face', 'face', 'face', 'face', 'neck', 'cloth', 'cloth',
            'head', 'head']
NEW_MAP = {'skin': 1, 'face': 2, 'neck': 3, 'head': 4, 'cloth': 5}

EDITED_IDS = [25, 50, 75, 100, 125, 175, 200, 225, 250, 275,
              300, 325, 350, 375, 400, 1250, 1275, 1300, 1325, 1350, 1375,
              1400, 1425, 1450]


def merge_cls() -> Dict[int, int]:
    """attribute id (1-based) → merged 5-class id."""
    return {i: NEW_MAP[new] for i, (_, new) in enumerate(zip(ATTS, NEW_ATTS), 1)}


def convert_pred(pred: np.ndarray, scale: int = 10) -> np.ndarray:
    """Decode a stored label image (attribute×scale) to merged class ids."""
    pred = np.asarray(pred, np.float64)
    for ids, new in merge_cls().items():
        pred[pred == ids * scale] = new
    return pred


@register_dataset("llff_cls")
class LLFFClsDataset(LLFFDataset):
    n_classes = 6  # 5 merged classes + background 0

    def __init__(self, root_dir, split="train", img_wh=(504, 378),
                 spheric_poses=False, val_num=1, edited_ids=None, **kwargs):
        self.edited_ids = list(edited_ids) if edited_ids is not None else list(EDITED_IDS)
        super().__init__(root_dir, split, img_wh, spheric_poses, val_num, **kwargs)

    # -- label IO --------------------------------------------------------------

    def _frame_id(self, image_path: str) -> int:
        return int(os.path.basename(image_path).split(".")[0].split("_")[-1])

    def _load_parse(self, path: str) -> np.ndarray:
        import cv2
        from PIL import Image

        parse = convert_pred(np.asarray(Image.open(path)))
        parse = cv2.resize(parse, self.img_wh, interpolation=cv2.INTER_NEAREST)
        return parse.reshape(-1).astype(np.int32)

    # -- geometry + buffers ----------------------------------------------------

    def read_meta(self):
        # run the base geometry; then rebuild train buffers restricted to the
        # edited frames, adding labels
        base_split = self.split
        if base_split == "train":
            self.split = "val"  # skip the base buffer pass
            super().read_meta()
            self.split = base_split
            self._build_train_buffers()
        else:
            super().read_meta()
            if base_split == "val":
                raws = sorted(glob.glob(os.path.join(self.root_dir, "raw_parse/*.png")))
                self.parse_path_val = raws[self.val_idx] if raws else None

    def _build_train_buffers(self):
        from nerf_siren_tpu_torch.utils.data import parallel_map

        selected = []
        for i, image_path in enumerate(self.image_paths):
            if i == self.val_idx:
                continue
            if self._frame_id(image_path) not in self.edited_ids:
                continue
            name = os.path.basename(image_path).split(".")[0]
            parse_path = os.path.join(self.root_dir, f"edit_parse/{name}.png")
            if not os.path.exists(parse_path):
                continue
            selected.append((i, image_path, parse_path))
        built = parallel_map(
            lambda s: (_load_rgb(s[1], self.img_wh),
                       self._load_parse(s[2]),
                       self._rays_for_pose(self.poses[s[0]])),
            selected)
        rgbs_list = [b[0] for b in built]
        parse_list = [b[1] for b in built]
        rays_list = [b[2] for b in built]
        if not rays_list:
            raise FileNotFoundError(
                f"no edited frames with edit_parse labels found in {self.root_dir}")
        self.all_rays = np.concatenate(rays_list, 0)
        self.all_rgbs = np.concatenate(rgbs_list, 0)
        self.all_cls = np.concatenate(parse_list, 0)
        self.n_images = len(rays_list)

    def __getitem__(self, idx):
        sample = super().__getitem__(idx)
        if self.split == "train":
            sample["cls"] = self.all_cls[idx]
        elif self.split == "val" and getattr(self, "parse_path_val", None):
            sample["cls"] = self._load_parse(self.parse_path_val)
        return sample

    def image_batches(self, batch_size: int = 2, seed: int = 0, epoch: int = 0):
        """Whole-image batches (the '_ib' mode): yields dicts of
        (B, H·W, ...) slabs (reference llff_cls.py:319-378)."""
        n_px = self.img_wh[0] * self.img_wh[1]
        n_imgs = self.all_rays.shape[0] // n_px
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(n_imgs)
        rays = self.all_rays.reshape(n_imgs, n_px, 8)
        rgbs = self.all_rgbs.reshape(n_imgs, n_px, 3)
        cls = self.all_cls.reshape(n_imgs, n_px)
        for b in range(0, n_imgs - batch_size + 1, batch_size):
            sel = order[b:b + batch_size]
            yield {"rays": rays[sel], "rgbs": rgbs[sel], "cls": cls[sel]}


@register_dataset("llff_cls_ib")
class LLFFClsImgBatchDataset(LLFFClsDataset):
    pass
