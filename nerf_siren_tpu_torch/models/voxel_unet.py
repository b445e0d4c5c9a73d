"""The dense voxel 3D-UNet over a point cloud (`--semantic_network conv3d`).

Counterpart of `nerf_siren_tpu/models/voxel_unet.py`:
1. `voxelize_points`: the valid points' box is mapped onto a res^3 grid
   (round half to even), and [xyz, rgb, occupancy] are scatter-averaged
   into it (`index_add`; on a card its atomics add in any order, so the
   sums may differ in their last bits from run to run);
2. `VoxelUNet`: a stem, per level a stride-2 conv down and a conv, then per
   level up a nearest x2 upsample cropped to the skip's size, the skip
   concatenated and a conv; a 1x1x1 head (ReLU after every conv but the
   head);
3. `apply_voxel_unet_points` (`VoxelUNet.forward`): each point's voxel
   logits, `log_softmax`.
The convolutions are `F.conv3d` on NCDHW (the JAX function's are XLA
convolutions, outside any Pallas kernel) with the JAX kernels' "SAME"
padding made explicit: at stride 2 XLA pads the extra row after, not
before (a 32-wide axis: 0 before, 1 after), where `padding=1` would pad
both sides and shift every window by one voxel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_RES = 32
ENC_CHANNELS = (16, 32, 64)


class Conv3d(nn.Module):
    """A k^3 convolution's `weight` (out, in, k, k, k) and `bias` with the
    torch-default U(+-1/sqrt(in * k^3)) init of the JAX `_init_conv3d`."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * k ** 3)
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, k, k, k).uniform_(-bound, bound, generator=generator))
        self.bias = nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return F.conv3d(F.pad(x, same_padding(x.shape[2:], self.weight.shape[-1], stride)),
                        self.weight, self.bias, stride=stride)


def same_padding(size: Tuple[int, ...], k: int, stride: int) -> Tuple[int, ...]:
    """XLA "SAME" padding of the spatial axes `size` for a k-wide window at
    `stride`, in `F.pad`'s order (last axis first, before then after): the
    total pad is max((ceil(n / stride) - 1) * stride + k - n, 0), its
    smaller half before."""
    pads = []
    for n in reversed(size):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class VoxelUNet(nn.Module):
    """The UNet on a `res`^3 grid, called as a point network (`forward`:
    PointNetDenseCls's contract); its convolutions named as the JAX tree
    (`stem`, `down<i>`, `enc<i>`, `dec<i>`, `head`; `convert.points_to_jax`)."""

    def __init__(self, in_channels: int = 7, out_channels: int = 6, res: int = DEFAULT_RES,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res = res
        g = dict(generator=generator)
        chs = ENC_CHANNELS
        self.stem = Conv3d(in_channels, chs[0], **g)
        enc_in = chs[0]
        for i, c in enumerate(chs):
            setattr(self, f"down{i}", Conv3d(enc_in, c, **g))
            setattr(self, f"enc{i}", Conv3d(c, c, **g))
            enc_in = c
        dec_in = chs[-1]
        for i in reversed(range(len(chs))):
            skip_ch = chs[i - 1] if i > 0 else chs[0]
            setattr(self, f"dec{i}", Conv3d(dec_in + skip_ch, skip_ch, **g))
            dec_in = skip_ch
        self.head = Conv3d(chs[0], out_channels, k=1, **g)

    def forward(self, pts: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(P, 6) points (+ mask) -> (P, n_classes) log-probabilities."""
        return apply_voxel_unet_points(self, pts, mask, self.res)

    def grid_forward(self, grid: torch.Tensor) -> torch.Tensor:
        """grid (1, C_in, D, H, W) -> (1, C_out, D, H, W) (the JAX
        `apply_voxel_unet` on NCDHW)."""
        n_levels = len(ENC_CHANNELS)
        h = torch.relu(self.stem(grid))
        skips = [h]
        for i in range(n_levels):
            h = torch.relu(getattr(self, f"down{i}")(h, stride=2))
            h = torch.relu(getattr(self, f"enc{i}")(h))
            skips.append(h)
        for i in reversed(range(n_levels)):
            target = skips[i]
            h = h.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
            h = h[:, :, :target.shape[2], :target.shape[3], :target.shape[4]]
            h = torch.relu(getattr(self, f"dec{i}")(torch.cat([h, target], dim=1)))
        return self.head(h)


def voxelize_points(pts_xyz: torch.Tensor, features: torch.Tensor,
                    valid: Optional[torch.Tensor], res: int):
    """Scatter-mean `features` (P, C) of the `valid` points into a res^3
    grid over their box. Returns (grid (1, res, res, res, C), each point's
    flat voxel index (P,))."""
    if valid is None:
        valid = torch.ones(pts_xyz.shape[0], dtype=torch.bool, device=pts_xyz.device)
    v = valid[:, None].to(pts_xyz.dtype)
    lo = torch.where(valid[:, None], pts_xyz, torch.inf).amin(0)
    hi = torch.where(valid[:, None], pts_xyz, -torch.inf).amax(0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    extent = (hi - lo).clamp_min(1e-6)

    uvw = (pts_xyz - lo) / extent * (res - 1)
    vox = torch.round(uvw).long().clamp(0, res - 1)
    flat = (vox[:, 0] * res + vox[:, 1]) * res + vox[:, 2]
    c = features.shape[-1]
    sums = features.new_zeros((res ** 3, c)).index_add(0, flat, features * v)
    counts = features.new_zeros((res ** 3, 1)).index_add(0, flat, v)
    grid = sums / counts.clamp_min(1.0)
    return grid.reshape(1, res, res, res, c), flat


def apply_voxel_unet_points(unet: VoxelUNet, pts: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            res: int = DEFAULT_RES) -> torch.Tensor:
    """PointNetDenseCls's contract: (P, 6) [xyz, rgb] (+ mask) -> per-point
    (P, n_classes) log-probabilities."""
    occ = (torch.ones(pts.shape[0], dtype=pts.dtype, device=pts.device) if mask is None
           else mask.to(pts.dtype))
    feats = torch.cat([pts, occ[:, None]], dim=-1)                       # (P, 7)
    grid, flat = voxelize_points(pts[:, :3], feats, mask, res)
    logits = unet.grid_forward(grid.permute(0, 4, 1, 2, 3))[0]      # (C, D, H, W)
    logits = logits.permute(1, 2, 3, 0).reshape(res ** 3, -1)
    return torch.log_softmax(logits[flat], dim=-1)

