"""Training losses (counterpart of `nerf_siren_tpu/training/losses.py`).

- mse: coarse MSE + fine MSE when present.
- msece: weight * MSE + (1 - weight) * cross-entropy on class logits
  (ignore_index -1), split as {'sum', 'rgb', 'cls'}.
- msenll: 0.99 * MSE + 0.01 * NLL over log-probability class outputs.
Reductions are masked means, as in the JAX package. Under data parallelism
the class losses take `global_count` (`parallel/shard_train.py::
DataParallel.mean_count`): each rank divides its masked sum by the global
batch's valid-label count over the world size, so the ranks' average (the
step's all-reduce) is JAX's one global masked mean, also where ranks hold
different numbers of ignored labels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Outputs = Dict[str, torch.Tensor]


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def mse_loss(outputs: Outputs, rgb_target: torch.Tensor, **_) -> Outputs:
    loss = _mse(outputs["rgb_coarse"], rgb_target)
    if "rgb_fine" in outputs:
        loss = loss + _mse(outputs["rgb_fine"], rgb_target)
    return {"sum": loss, "rgb": loss}


def _denominator(labels: torch.Tensor, ignore_index: int,
                 global_count: Optional[Callable] = None) -> torch.Tensor:
    """A masked mean's denominator: the count of labels != ignore_index, at
    least 1, or with `global_count` what it makes of this rank's count."""
    n = (labels != ignore_index).sum()
    return n.clamp_min(1) if global_count is None else global_count(n)


def _masked_nll(logp: torch.Tensor, labels: torch.Tensor, ignore_index: int,
                denominator: torch.Tensor) -> torch.Tensor:
    """Sum of negative log-probabilities over labels != ignore_index, over
    `denominator` (`_denominator`)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    safe = torch.where(safe < 0, safe + logp.shape[-1], safe)   # numpy-style negative index
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / denominator


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int,
               denominator: torch.Tensor) -> torch.Tensor:
    return _masked_nll(torch.log_softmax(logits, dim=-1), labels, ignore_index, denominator)


def msece_loss(outputs: Outputs, rgb_target: torch.Tensor, cls_target: torch.Tensor = None,
               weight: float = 0.0, global_count: Optional[Callable] = None, **_) -> Outputs:
    cls_target = cls_target.reshape(-1).long()
    den = _denominator(cls_target, -1, global_count)
    mse_l = _mse(outputs["rgb_coarse"].reshape(-1, 3), rgb_target.reshape(-1, 3))
    ce_l = _masked_ce(outputs["cls_coarse"], cls_target, -1, den)
    if "rgb_fine" in outputs:
        mse_l = mse_l + _mse(outputs["rgb_fine"].reshape(-1, 3), rgb_target.reshape(-1, 3))
        ce_l = ce_l + _masked_ce(outputs["cls_fine"], cls_target, -1, den)
    mse_l = mse_l * weight
    ce_l = ce_l * (1.0 - weight)
    return {"sum": mse_l + ce_l, "rgb": mse_l, "cls": ce_l}


def msenll_loss(outputs: Outputs, rgb_target: torch.Tensor, cls_target: torch.Tensor = None,
                weight: float = 0.99, global_count: Optional[Callable] = None,
                **_) -> Outputs:
    """`outputs['cls_*']` are log-probabilities already."""
    cls_target = cls_target.reshape(-1).long()
    den = _denominator(cls_target, -100, global_count)
    rgb_l = _mse(outputs["rgb_coarse"].reshape(-1, 3), rgb_target.reshape(-1, 3))
    cls_l = _masked_nll(outputs["cls_coarse"], cls_target, -100, den)
    if "rgb_fine" in outputs:
        rgb_l = rgb_l + _mse(outputs["rgb_fine"].reshape(-1, 3), rgb_target.reshape(-1, 3))
        cls_l = cls_l + _masked_nll(outputs["cls_fine"], cls_target, -100, den)
    rgb_l = rgb_l * weight
    cls_l = cls_l * (1.0 - weight)
    return {"sum": rgb_l + cls_l, "rgb": rgb_l, "cls": cls_l}


loss_dict = {"mse": mse_loss, "msece": msece_loss, "msenll": msenll_loss}
