"""Training losses (counterpart of `nerf_siren_tpu/training/losses.py`).

- mse: coarse MSE + fine MSE when present.
- msece: weight * MSE + (1 - weight) * cross-entropy on class logits
  (ignore_index -1), split as {'sum', 'rgb', 'cls'}.
- msenll: 0.99 * MSE + 0.01 * NLL over log-probability class outputs.
Reductions are masked means, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

Outputs = Dict[str, torch.Tensor]


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def mse_loss(outputs: Outputs, rgb_target: torch.Tensor, **_) -> Outputs:
    loss = _mse(outputs["rgb_coarse"], rgb_target)
    if "rgb_fine" in outputs:
        loss = loss + _mse(outputs["rgb_fine"], rgb_target)
    return {"sum": loss, "rgb": loss}


def _masked_nll(logp: torch.Tensor, labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Mean negative log-probability over labels != ignore_index."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    safe = torch.where(safe < 0, safe + logp.shape[-1], safe)   # numpy-style negative index
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    return _masked_nll(torch.log_softmax(logits, dim=-1), labels, ignore_index)


def msece_loss(outputs: Outputs, rgb_target: torch.Tensor, cls_target: torch.Tensor = None,
               weight: float = 0.0, **_) -> Outputs:
    cls_target = cls_target.reshape(-1).long()
    mse_l = _mse(outputs["rgb_coarse"].reshape(-1, 3), rgb_target.reshape(-1, 3))
    ce_l = _masked_ce(outputs["cls_coarse"], cls_target)
    if "rgb_fine" in outputs:
        mse_l = mse_l + _mse(outputs["rgb_fine"].reshape(-1, 3), rgb_target.reshape(-1, 3))
        ce_l = ce_l + _masked_ce(outputs["cls_fine"], cls_target)
    mse_l = mse_l * weight
    ce_l = ce_l * (1.0 - weight)
    return {"sum": mse_l + ce_l, "rgb": mse_l, "cls": ce_l}


def msenll_loss(outputs: Outputs, rgb_target: torch.Tensor, cls_target: torch.Tensor = None,
                weight: float = 0.99, **_) -> Outputs:
    """`outputs['cls_*']` are log-probabilities already."""
    cls_target = cls_target.reshape(-1).long()
    rgb_l = _mse(outputs["rgb_coarse"].reshape(-1, 3), rgb_target.reshape(-1, 3))
    cls_l = _masked_nll(outputs["cls_coarse"], cls_target, -100)
    if "rgb_fine" in outputs:
        rgb_l = rgb_l + _mse(outputs["rgb_fine"].reshape(-1, 3), rgb_target.reshape(-1, 3))
        cls_l = cls_l + _masked_nll(outputs["cls_fine"], cls_target, -100)
    rgb_l = rgb_l * weight
    cls_l = cls_l * (1.0 - weight)
    return {"sum": rgb_l + cls_l, "rgb": rgb_l, "cls": cls_l}


loss_dict = {"mse": mse_loss, "msece": msece_loss, "msenll": msenll_loss}
