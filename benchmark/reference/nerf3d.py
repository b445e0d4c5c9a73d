"""The fork's semantic NeRF (`--mode d3`, PointNet) in plain PyTorch: the
reference the benchmark holds the port's semantic training steps against.

It imports nothing of the port. The fields, their draws, the march and the
compositing are `reference/nerf.py`'s, run without gradients (the fork's
`no_grad_on_nerf`: the fields stay as they are). Each rgb pass then does
what the fork's `render_rays_3d` does (`models/rendering.py:265-472`):
1. gathers the samples whose compositing weight exceeds the threshold (0
   in training), however many there are;
2. divides their xyz by the Frobenius norm of the gathered (N, 3) xyz
   (`np.linalg.norm` of the whole cloud) and appends their rgb;
3. runs PointNet's segmentation network (Qi et al., CVPR 2017, Fig. 2;
   the fork's `PointNetDenseCls(k=6, inc=6)`, `models/pointnets.py`) on
   those N points alone, BatchNorm with the batch statistics of those
   points (the fork trains one cloud a batch in training mode);
4. puts each point's class log-probabilities back at its sample (zeros
   elsewhere) and composites cls = sum_s w_s cls_s.
No capacity and no mask: the port's fixed-capacity, masked form of the
same function is what this is independent of. The fork's departures from
the paper are kept: the input transform net has no BatchNorm and a ReLU
after its last layer (before the identity is added); the rgb bypasses the
transform.

The loss is `msenll`: 0.99 x (coarse + fine MSE) + 0.01 x (coarse + fine
NLL of the composited cls, taken as log-probabilities); Adam trains the
point network alone. Products take their operands through `op`
(`operand_round`): `fp32` leaves them as they are, `bf16` rounds them and
their cotangents (`reference/nerf.py`). Sums are float32; the caller turns
TF32 off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import nerf as base

Weights = Dict[str, torch.Tensor]
RGB_WEIGHT = 0.99    # msenll: the rgb share of the loss
BN_EPS = 1e-5


def operand_round(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Operands as they are (`fp32`) or rounded as `reference/nerf.py` rounds them."""
    if kind == "fp32":
        return lambda x: x
    return base.operand_round(kind)


# -- PointNet ---------------------------------------------------------------------

def pointnet_shapes(k: int, inc: int) -> List[Tuple[str, int, int]]:
    """(name, out, in) of PointNet's linear layers (its 1x1 convolutions),
    named as the port names them."""
    return [("feat.stn.conv1", 64, 3), ("feat.stn.conv2", 128, 64),
            ("feat.stn.conv3", 1024, 128), ("feat.stn.fc1", 512, 1024),
            ("feat.stn.fc2", 256, 512), ("feat.stn.fc3", 9, 256),
            ("feat.conv1", 64, inc), ("feat.conv2", 128, 64), ("feat.conv3", 1024, 128),
            ("conv1", 512, 1088), ("conv2", 256, 512), ("conv3", 128, 256), ("conv4", k, 128)]


BATCH_NORMS = (("feat.bn1", 64), ("feat.bn2", 128), ("feat.bn3", 1024),
               ("bn1", 512), ("bn2", 256), ("bn3", 128))


def random_pointnet(k: int, inc: int, generator: torch.Generator) -> Weights:
    """PointNet with PyTorch's default init (weights and biases U(-1/sqrt(in),
    1/sqrt(in)), BatchNorm scale 1 and bias 0), from one draw on the
    generator's device."""
    shapes = pointnet_shapes(k, inc)
    total = sum(o * i + o for _, o, i in shapes)
    u = torch.rand(total, generator=generator, device=generator.device) * 2 - 1
    out, at = {}, 0
    for name, o, i in shapes:
        bound = 1.0 / math.sqrt(i)
        out[f"{name}.weight"] = (u[at:at + o * i] * bound).view(o, i)
        at += o * i
        out[f"{name}.bias"] = u[at:at + o] * bound
        at += o
    for name, c in BATCH_NORMS:
        out[f"{name}.scale"] = torch.ones(c, device=generator.device)
        out[f"{name}.bias"] = torch.zeros(c, device=generator.device)
    return out


# Weights whose gradient is zero in exact arithmetic, so that what they get
# is rounding alone (which Adam then scales up to full steps): the biases
# that BatchNorm follows, and the global feature's branch. The global
# feature is the same at every point of the cloud, so the dense head's
# first BatchNorm, over the cloud's points, subtracts all that it adds: the
# loss does not depend on it, nor on the layers that make it (feat.conv2,
# feat.conv3, feat.bn2, feat.bn3), nor on conv1's columns that take it (the
# first 1024). The fork's cloud is its one batch, so its network has the
# same still branch.
STILL = ("feat.conv1.bias", "feat.conv2.", "feat.conv3.", "feat.bn2.", "feat.bn3.",
         "conv1.bias", "conv2.bias", "conv3.bias")
GLOBAL_FEATURE = 1024   # conv1's input columns that take the global feature


def learning(leaves: Weights) -> Weights:
    """The parts of the point network's leaves (weights, gradients, moments)
    that learn: every leaf but the `STILL` ones, and conv1's weight without
    the global feature's columns."""
    out = {k: v for k, v in leaves.items() if not k.startswith(STILL)}
    if "conv1.weight" in out:
        out["conv1.weight"] = out["conv1.weight"][:, GLOBAL_FEATURE:]
    return out


def batch_norm(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in training mode: the biased statistics of these points."""
    return F.batch_norm(x, None, None, w[f"{name}.scale"], w[f"{name}.bias"], training=True,
                        eps=BN_EPS)


def pointnet(w: Weights, pts: torch.Tensor, op) -> torch.Tensor:
    """(N, k) log-probabilities of the N points pts (N, inc), xyz first."""
    xyz, rest = pts[:, :3], pts[:, 3:]
    h = xyz
    for name in ("feat.stn.conv1", "feat.stn.conv2", "feat.stn.conv3"):
        h = torch.relu(base.dense(w, name, h, op))
    g = h.amax(0, keepdim=True)
    for name in ("feat.stn.fc1", "feat.stn.fc2", "feat.stn.fc3"):
        g = torch.relu(base.dense(w, name, g, op))
    trans = g.view(3, 3) + torch.eye(3, device=pts.device)
    x = torch.cat([op(xyz) @ op(trans), rest], 1)
    x = torch.relu(batch_norm(w, "feat.bn1", base.dense(w, "feat.conv1", x, op)))
    point_feat = x
    x = torch.relu(batch_norm(w, "feat.bn2", base.dense(w, "feat.conv2", x, op)))
    x = batch_norm(w, "feat.bn3", base.dense(w, "feat.conv3", x, op))
    x = torch.cat([x.amax(0, keepdim=True).expand(x.shape[0], -1), point_feat], 1)
    for i in (1, 2, 3):
        x = torch.relu(batch_norm(w, f"bn{i}", base.dense(w, f"conv{i}", x, op)))
    return torch.log_softmax(base.dense(w, "conv4", x, op), -1)


def semantic(w: Weights, xyz: torch.Tensor, rgb: torch.Tensor, weights: torch.Tensor,
             threshold: float, op) -> torch.Tensor:
    """Steps 1-4 above: xyz, rgb (R, S, 3), weights (R, S) -> cls (R, k); a
    pass with no weight above the threshold has cls 0."""
    r, s = weights.shape
    k = w["conv4.bias"].shape[0]
    keep = torch.nonzero(weights.reshape(-1) > threshold).squeeze(1)
    cls = weights.new_zeros(r * s, k)
    if keep.numel():
        pts_xyz = xyz.reshape(-1, 3)[keep]
        pts = torch.cat([pts_xyz / torch.linalg.norm(pts_xyz), rgb.reshape(-1, 3)[keep]], 1)
        cls = cls.index_put((keep,), pointnet(w, pts, op))
    return (weights[..., None] * cls.view(r, s, k)).sum(-2)


# -- the semantic render ----------------------------------------------------------

def render(wc: Weights, wf: Weights, wp: Weights, cfg: dict, rays: torch.Tensor, op,
           draws: Dict[str, torch.Tensor], threshold: float = 0.0) -> Dict[str, torch.Tensor]:
    """The training render of (R, 8) rays with the step's `draws`: both
    fields' full passes without gradients, then each pass's cls; `points`
    counts the valid points of both clouds."""
    r, s, n_imp = rays.shape[0], cfg["n_samples"], cfg["n_importance"]
    dirs = rays[:, 3:6]
    dir_norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    with torch.no_grad():
        z = base.coarse_depths(rays, s, draws.get("strat_u"))
        xyz_c = base.points(rays, z)
        sig, rgb_c = base.field(wc, cfg, xyz_c, dirs.repeat_interleave(s, 0), op)
        comp_c = base.composite(sig.view(r, s), z, dir_norm, rgb_c.view(r, s, 3),
                                draws.get("sigma_coarse"), cfg["white_back"])
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        z_f = base.sample_pdf(mid, comp_c["weights"][:, 1:-1], n_imp, draws.get("pdf_u"))
        z_all, _ = torch.sort(torch.cat([z, z_f], -1), -1)
        sa = s + n_imp
        xyz_f = base.points(rays, z_all)
        sig, rgb_f = base.field(wf, cfg, xyz_f, dirs.repeat_interleave(sa, 0), op)
        comp_f = base.composite(sig.view(r, sa), z_all, dir_norm, rgb_f.view(r, sa, 3),
                                draws.get("sigma_fine"), cfg["white_back"])
    valid = comp_c["weights"] > threshold, comp_f["weights"] > threshold
    return {"rgb_coarse": comp_c["rgb"], "rgb_fine": comp_f["rgb"],
            "points": sum(int(v.sum()) for v in valid),
            "cls_coarse": semantic(wp, xyz_c.view(r, s, 3), rgb_c.view(r, s, 3),
                                   comp_c["weights"], threshold, op),
            "cls_fine": semantic(wp, xyz_f.view(r, sa, 3), rgb_f.view(r, sa, 3),
                                 comp_f["weights"], threshold, op)}


def msenll(out: Dict[str, torch.Tensor], rgbs: torch.Tensor, labels: torch.Tensor):
    """0.99 x the coarse and fine MSE + 0.01 x the coarse and fine NLL."""
    mse = sum(((out[f"rgb_{p}"] - rgbs) ** 2).mean() for p in ("coarse", "fine"))
    nll = sum(-out[f"cls_{p}"].gather(1, labels[:, None]).mean() for p in ("coarse", "fine"))
    return RGB_WEIGHT * mse + (1 - RGB_WEIGHT) * nll


# -- training ---------------------------------------------------------------------

def train_steps(fields: Dict[str, Weights], wp0: Weights, cfg: dict, batches, seed: int,
                traffic: dict, op, moment_at: int = 1, start: int = 0):
    """Steps of the point network under msenll and Adam at a constant
    learning rate, the fields frozen, one a batch (rays (B, 8), rgbs (B, 3),
    labels (B,)), the whole batch at once (the cloud is the batch's), the
    first batch with the draws of global step `start`. Returns the loss of
    each step, the composited cls of the first step ({'coarse', 'fine'}),
    Adam's first moment and the weights after step `moment_at`, the
    weights after the last step, and each step's valid points (both
    clouds)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in wp0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = traffic["lr"]
    losses, first_cls, moment, mid, points = [], None, None, None, []
    for t, (rays, rgbs, labels) in enumerate(batches, start=1):
        draws = base.step_draws(seed, start + t - 1, rays.shape[0], cfg, traffic["perturb"],
                                traffic["noise_std"], rays.device)
        out = render(fields["coarse"], fields["fine"], params, cfg, rays, op, draws)
        loss = msenll(out, rgbs, labels)
        loss.backward()
        losses.append(float(loss.detach()))
        points.append(out["points"])
        if first_cls is None:
            first_cls = {p: out[f"cls_{p}"].detach() for p in ("coarse", "fine")}
        with torch.no_grad():
            c1 = np.float32(1) - np.float32(base.B1) ** t
            c2 = np.float32(1) - np.float32(base.B2) ** t
            for k, p in params.items():
                g = p.grad
                mu[k].mul_(base.B1).add_(g, alpha=1 - base.B1)
                nu[k].mul_(base.B2).addcmul_(g, g, value=1 - base.B2)
                p.add_(-lr * (mu[k] / float(c1)) / ((nu[k] / float(c2)).sqrt() + base.EPS))
                p.grad = None
            if t == moment_at:
                moment = {k: v.clone() for k, v in mu.items()}
                mid = {k: p.detach().clone() for k, p in params.items()}
    return (losses, first_cls, moment, mid, {k: p.detach() for k, p in params.items()},
            points)
