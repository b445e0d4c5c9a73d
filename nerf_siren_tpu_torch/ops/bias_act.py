"""Bias + activation (+ gain + clamp).

Counterpart of `nerf_siren_tpu/ops/bias_act.py` (the reference's
`torch_utils/ops/bias_act.py` activation table and its plain path). Plain
PyTorch ops: the bias add, activation, gain and clamp are elementwise, so
the card runs them as PyTorch's own kernels. The table carries each
function's default alpha and gain (sqrt(2) for relu, lrelu and swish).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class _Act(NamedTuple):
    fn: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _Act(lambda x, alpha: x, 0.0, 1.0),
    "relu": _Act(lambda x, alpha: torch.relu(x), 0.0, math.sqrt(2)),
    "lrelu": _Act(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2)),
    "tanh": _Act(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _Act(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _Act(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _Act(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _Act(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _Act(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(gain * act(x + b), +-clamp); b broadcast along `dim`."""
    spec = activation_funcs[act]
    alpha = spec.def_alpha if alpha is None else alpha
    gain = spec.def_gain if gain is None else gain
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = spec.fn(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x
