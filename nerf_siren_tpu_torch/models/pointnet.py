"""PointNet dense segmentation over a fixed-capacity point cloud.

Counterpart of `nerf_siren_tpu/models/pointnet.py` (`PointNetDenseCls(k,
inc=6)` of the reference):
- STN3d: per-point linears 3 -> 64 -> 128 -> 1024 (ReLU, no BN), a masked
  max-pool, then 1024 -> 512 -> 256 -> 9 with a ReLU on the last one too
  (a reference quirk, kept), plus the identity;
- `PointNetfeat(global_feat=False)`: the STN on xyz only, rgb passed
  through, per-point 64 / 128 / 1024 with BN, a masked max-pool, the global
  feature broadcast and concatenated with the 64-wide point feature (1088);
- the dense head 512 / 256 / 128 with BN and ReLU, then k classes and a
  per-point `log_softmax`.
The cloud has a fixed capacity with a validity mask. BatchNorm uses the
masked statistics of this call's valid points, in training and in
evaluation alike, as the JAX function does: `nn.BatchNorm1d`'s running
statistics would be another function, so BN is `masked_bn`, and its
parameters are the JAX tree's `scale` and `bias`. A max-pool column with
no valid point is 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_siren_tpu_torch.models.layers import init_linear


class MaskedBN(nn.Module):
    """BatchNorm parameters (`scale`, `bias`) for `masked_bn`."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return masked_bn(self, x, mask)


def masked_bn(bn: MaskedBN, x: torch.Tensor, mask: Optional[torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm of x (P, C) over the points of `mask` (all without one),
    with this call's biased statistics. The count stays on the device."""
    if mask is None:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        m = mask[:, None].to(x.dtype)
        count = m.sum().clamp_min(1.0)
        mean = (x * m).sum(0) / count
        var = ((x - mean) ** 2 * m).sum(0) / count
    return (x - mean) * torch.rsqrt(var + eps) * bn.scale + bn.bias


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Max over the points (axis 0) of the valid rows of x (P, C) -> (C,);
    a column with no valid row is 0. Ties share the gradient evenly, as
    JAX's max does."""
    if mask is not None:
        x = torch.where(mask[:, None], x, -torch.inf)
    out = x.amax(0)
    return torch.where(torch.isfinite(out), out, 0.0)


class STN3d(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = dict(generator=generator)
        self.conv1, self.conv2 = init_linear(3, 64, **g), init_linear(64, 128, **g)
        self.conv3 = init_linear(128, 1024, **g)
        self.fc1, self.fc2 = init_linear(1024, 512, **g), init_linear(512, 256, **g)
        self.fc3 = init_linear(256, 9, **g)

    def forward(self, xyz: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """xyz (P, 3) -> the (3, 3) transform."""
        h = torch.relu(self.conv1(xyz))
        h = torch.relu(self.conv2(h))
        h = torch.relu(self.conv3(h))
        g = masked_max(h, mask)
        g = torch.relu(self.fc1(g))
        g = torch.relu(self.fc2(g))
        g = torch.relu(self.fc3(g))      # the reference's ReLU on fc3
        return g.reshape(3, 3) + torch.eye(3, dtype=g.dtype, device=g.device)


class PointNetFeat(nn.Module):
    def __init__(self, inc: int = 6, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = dict(generator=generator)
        self.stn = STN3d(generator)
        self.conv1, self.conv2 = init_linear(inc, 64, **g), init_linear(64, 128, **g)
        self.conv3 = init_linear(128, 1024, **g)
        self.bn1, self.bn2, self.bn3 = MaskedBN(64), MaskedBN(128), MaskedBN(1024)

    def forward(self, pts: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """pts (P, inc), xyz first -> (P, 1088) point features."""
        xyz, others = pts[:, :3], pts[:, 3:]
        x = torch.cat([xyz @ self.stn(xyz, mask), others], dim=1)
        x = torch.relu(self.bn1(self.conv1(x), mask))
        pointfeat = x
        x = torch.relu(self.bn2(self.conv2(x), mask))
        x = self.bn3(self.conv3(x), mask)
        g = masked_max(x, mask)
        return torch.cat([g[None, :].expand(pts.shape[0], -1), pointfeat], dim=1)


class PointNetDenseCls(nn.Module):
    """Per-point k-class log-probabilities; parameters named as the JAX
    tree (`convert.points_to_jax`)."""

    def __init__(self, k: int = 2, inc: int = 6, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = dict(generator=generator)
        self.feat = PointNetFeat(inc, generator)
        self.conv1, self.conv2 = init_linear(1088, 512, **g), init_linear(512, 256, **g)
        self.conv3, self.conv4 = init_linear(256, 128, **g), init_linear(128, k, **g)
        self.bn1, self.bn2, self.bn3 = MaskedBN(512), MaskedBN(256), MaskedBN(128)

    def forward(self, pts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pts (P, inc) (+ a (P,) bool mask) -> (P, k) log-probabilities."""
        x = self.feat(pts, mask)
        x = torch.relu(self.bn1(self.conv1(x), mask))
        x = torch.relu(self.bn2(self.conv2(x), mask))
        x = torch.relu(self.bn3(self.conv3(x), mask))
        return torch.log_softmax(self.conv4(x), dim=-1)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ||T T^T - I||_F (trans (..., d, d))."""
    d = trans.shape[-1]
    diff = trans @ trans.transpose(-1, -2) - torch.eye(d, dtype=trans.dtype,
                                                       device=trans.device)
    return torch.linalg.matrix_norm(diff).mean()
