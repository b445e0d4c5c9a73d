"""Cross-process training-statistics collection (reference:
torch_utils/training_stats.py — Collector/report with moment accumulation
and broadcast sync).

Counterpart of `nerf_siren_tpu/utils/training_stats.py`: statistics are
(count, sum, sum-of-squares) moment triples, float32 tensors on any
device, so a step accumulates them without a host read and
`cross_replica_sum` syncs them over a process group with one `all_reduce`.
The host-side `Collector` mirrors the reference's API (report / as_dict /
mean / std).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

Moments = torch.Tensor  # shape (3,): [count, sum, sum_sq]


def init_moments(device=None) -> Moments:
    return torch.zeros((3,), dtype=torch.float32, device=device)


def report(moments: Moments, value) -> Moments:
    """Accumulate a scalar or array of values into the moment triple (a new
    tensor; nothing is read on the host)."""
    v = torch.as_tensor(value, dtype=torch.float32, device=moments.device).reshape(-1)
    return moments + torch.stack([torch.tensor(float(v.numel()), device=moments.device),
                                  v.sum(), (v ** 2).sum()])


def cross_replica_sum(moments: Moments, group=None) -> Moments:
    """The moments summed over the ranks of `group` (one all-reduce of a
    copy); without a process group, the moments."""
    out = moments.clone()
    if dist.is_initialized():
        dist.all_reduce(out, group=group)
    return out


def mean(moments: Moments) -> torch.Tensor:
    return moments[1] / torch.clamp(moments[0], min=1.0)


def std(moments: Moments) -> torch.Tensor:
    m = mean(moments)
    var = moments[2] / torch.clamp(moments[0], min=1.0) - m ** 2
    return torch.sqrt(torch.clamp(var, min=0.0))


class Collector:
    """Host-side stat registry (reference training_stats.Collector)."""

    def __init__(self):
        self._moments: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        v = np.asarray(value, np.float64).reshape(-1)
        m = self._moments.setdefault(name, np.zeros(3))
        m += [v.size, v.sum(), (v ** 2).sum()]

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return m[1] / m[0]

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mu = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mu ** 2, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"num": float(m[0]), "mean": self.mean(k), "std": self.std(k)}
                for k, m in self._moments.items()}

    def reset(self) -> None:
        self._moments.clear()
