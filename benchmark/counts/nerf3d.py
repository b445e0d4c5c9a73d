"""Operations of the semantic step (`--mode d3`, PointNet), from the
configuration's widths and the step's shapes.

The fields run forward only (frozen): `counts/nerf.py`'s full pass at every
sample of both passes. The point network runs at the valid points of each
pass's cloud (weight above the threshold), as the fork's network does: the
port's fixed-capacity cloud also computes its masked slots, which are
padding and are not counted (the valid share is `d3_valid_pct`). A
point's forward is one multiply-add per weight of the per-point layers
(the input transform's shared MLP, the 3 x 3 transform, the feature MLP,
the dense head) and the transform's fully connected layers once a cloud;
training adds one multiply-add per weight for the weight gradients and one
for the inputs' gradients, except into the transform net's first layer
(its input, the cloud's xyz, learns nothing). BatchNorm, the max-pools and
the softmax are not counted (a few operations a feature). Flops are two
per multiply-add.
"""
from __future__ import annotations

from benchmark.counts import nerf

# (out, in) of PointNet's layers; `inc` and k come from the configuration
CLOUD_LAYERS = [(512, 1024), (256, 512), (9, 256)]        # the transform net's fc1-fc3


def point_layers(k: int, inc: int) -> list:
    """(out, in) of the layers run at every point."""
    return [(64, 3), (128, 64), (1024, 128),                   # the transform net's MLP
            (64, inc), (128, 64), (1024, 128),                 # the feature MLP
            (512, 1088), (256, 512), (128, 256), (k, 128)]     # the dense head


def pointnet_forward_macs(k: int, inc: int) -> int:
    """Multiply-adds of one point's forward (the 3 x 3 transform included)."""
    return sum(o * i for o, i in point_layers(k, inc)) + 9


def pointnet_train_macs(k: int, inc: int) -> int:
    """Multiply-adds of one point trained: forward, weight gradients, input
    gradients but into the first layer."""
    return 3 * pointnet_forward_macs(k, inc) - 64 * 3


def pointnet_step_flops(cfg: dict, points: float) -> int:
    """The point network's flops a step, forward and backward, at `points`
    valid points over the step's two clouds."""
    k, inc = cfg["n_classes"], cfg["point_inputs"]
    per_cloud = 3 * sum(o * i for o, i in CLOUD_LAYERS)
    return round(2 * (points * pointnet_train_macs(k, inc) + 2 * per_cloud))


def fields_step_flops(cfg: dict, traffic: dict) -> int:
    """The frozen fields' forward flops a step: the coarse pass at n_samples
    and the fine at n_samples + n_importance, full (rgb too)."""
    return 2 * nerf.train_points(cfg, traffic["rays_per_step"]) * nerf.forward_macs(cfg, True)


def step_flops(cfg: dict, traffic: dict, points: float) -> int:
    """The step's model flops: the fields at every sample, the point network
    at `points` valid points a step."""
    return fields_step_flops(cfg, traffic) + pointnet_step_flops(cfg, points)
