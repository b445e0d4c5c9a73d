"""Image metrics needed by eval (counterpart of `psnr` in
`nerf_siren_tpu/training/metrics.py`)."""
from __future__ import annotations

import torch


def psnr(image_pred: torch.Tensor, image_gt: torch.Tensor) -> torch.Tensor:
    """-10 log10 of the mean squared error, for images in [0, 1]."""
    return -10.0 * torch.log10(((image_pred - image_gt) ** 2).mean())
