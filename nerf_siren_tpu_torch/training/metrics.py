"""Image and class-map metrics (counterpart of `mse`, `psnr`, `ssim`,
`confusion_matrix`, `miou` and `class_accuracy` in
`nerf_siren_tpu/training/metrics.py`).

SSIM follows the kornia convention the reference uses: per-pixel structural
dissimilarity under a Gaussian window, returned as 1 - 2 * dssim in [-1, 1].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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


def _gaussian_kernel(window_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - (window_size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filter of (N, C, H, W) images: a depthwise
    convolution down the columns, then along the rows."""
    c, k = img.shape[1], k1d.shape[0]
    x = F.conv2d(img, k1d.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, k1d.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(image_pred: torch.Tensor, image_gt: torch.Tensor, window_size: int = 3,
         max_val: float = 1.0, reduction: str = "mean") -> torch.Tensor:
    """SSIM of (N, C, H, W) images, kornia-style: a Gaussian window of
    `window_size` and sigma 1.5, 'valid' filtering, 1 - 2 * dssim."""
    k = _gaussian_kernel(window_size, 1.5, image_pred.device)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu1, mu2 = _filter2d_sep(image_pred, k), _filter2d_sep(image_gt, k)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2d_sep(image_pred ** 2, k) - mu1_sq
    s2 = _filter2d_sep(image_gt ** 2, k) - mu2_sq
    s12 = _filter2d_sep(image_pred * image_gt, k) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    dssim = (1.0 - ssim_map) / 2.0
    if reduction == "mean":
        dssim = dssim.mean()
    return 1.0 - 2.0 * dssim


def confusion_matrix(pred_cls: torch.Tensor, gt_cls: torch.Tensor, n_classes: int,
                     ignore_index: Optional[int] = None) -> torch.Tensor:
    """(n_classes, n_classes) int32 counts[gt, pred] over flat int labels."""
    pred_cls, gt_cls = pred_cls.reshape(-1).long(), gt_cls.reshape(-1).long()
    valid = torch.ones_like(gt_cls, dtype=torch.bool)
    if ignore_index is not None:
        valid = gt_cls != ignore_index
    idx = torch.where(valid, gt_cls * n_classes + pred_cls, 0)
    counts = torch.zeros(n_classes * n_classes, dtype=torch.int32, device=gt_cls.device)
    counts.index_add_(0, idx, valid.to(torch.int32))
    return counts.reshape(n_classes, n_classes)


def miou(pred_cls: torch.Tensor, gt_cls: torch.Tensor, n_classes: int,
         ignore_index: Optional[int] = None):
    """(mean IoU, per-class IoU (n_classes,)); a class absent from both the
    prediction and the ground truth has IoU nan and is left out of the
    mean."""
    cm = confusion_matrix(pred_cls, gt_cls, n_classes, ignore_index)
    inter = torch.diag(cm).float()
    union = (cm.sum(0) + cm.sum(1)).float() - inter
    iou = torch.where(union > 0, inter / union.clamp_min(1), torch.nan)
    return torch.nanmean(iou), iou


def class_accuracy(pred_cls: torch.Tensor, gt_cls: torch.Tensor, n_classes: int,
                   ignore_index: Optional[int] = None):
    """(overall pixel accuracy, per-class recall (n_classes,))."""
    cm = confusion_matrix(pred_cls, gt_cls, n_classes, ignore_index)
    total = cm.sum().clamp_min(1).float()
    overall = torch.diag(cm).sum().float() / total
    rows = cm.sum(1)
    per_class = torch.where(rows > 0, torch.diag(cm) / rows.clamp_min(1), torch.nan)
    return overall, per_class
