"""Image metrics (counterpart of `mse` / `psnr` in
`nerf_siren_tpu/training/metrics.py`)."""
from __future__ import annotations

from typing import Optional

import torch


def mse(image_pred: torch.Tensor, image_gt: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error, over the pixels of `valid_mask` when given."""
    value = (image_pred - image_gt) ** 2
    if valid_mask is None:
        return value.mean()
    return torch.where(valid_mask, value, 0.0).sum() / valid_mask.sum().clamp_min(1)


def psnr(image_pred: torch.Tensor, image_gt: torch.Tensor,
         valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-10 log10 of the mean squared error, for images in [0, 1]."""
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask))
