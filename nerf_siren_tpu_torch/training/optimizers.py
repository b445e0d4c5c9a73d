"""Optimizers and learning-rate schedules, in plain tensor code.

Counterpart of `nerf_siren_tpu/training/optimizers.py` (optax): sgd, adam,
radam and ranger (radam + Lookahead), with steplr / cosine / poly epoch
schedules and the gradual warmup. The update rules are optax's, written
out so that the port matches them step for step:
- weight decay is added to the gradient before the optimizer
  (`optax.add_decayed_weights`);
- the learning rate of step t (0-based) is `schedule(t)`, a function of
  the global step with `steps_per_epoch` baked in (epoch-granular);
- adam / radam: eps = 1e-8 outside the square root, bias-corrected moments;
  radam applies its rectification when rho_t >= 5, else the bias-corrected
  momentum alone;
- ranger: every 6th step the weights move to slow + 0.5 (fast - slow).

The state is a dict of plain values and lists of tensors, one entry per
parameter in the order the optimizer was given them:
  {"count": int, "mu": [...], "nu": [...]}     adam, radam
  {"count": int, "trace": [...]}               sgd
  ranger adds {"slow": [...], "la_count": int}
`training/checkpoints.py` stores it under these names.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from nerf_siren_tpu_torch.config import TrainConfig

_EPS = 1e-8
B1, B2 = 0.9, 0.999
RADAM_THRESHOLD = 5.0
LOOKAHEAD_PERIOD, LOOKAHEAD_STEP = 6, 0.5

State = Dict[str, Any]
F32 = np.float32


def _pow_f32(base: float, n: int) -> np.float32:
    """base ** n for an integer n in float32 by square-and-multiply, the
    rounding XLA gives `b ** count` in optax."""
    r, b = F32(1), F32(base)
    while n:
        if n & 1:
            r = F32(r * b)
        b, n = F32(b * b), n >> 1
    return r


def _radam_rect_f32(t: int) -> float:
    """RAdam's rectification factor of step t (1-based), 0.0 while rho_t is
    below the threshold (the bias-corrected momentum alone is used then)."""
    ro_inf = 2.0 / (1.0 - B2) - 1.0
    b2t = _pow_f32(B2, t)
    ro = F32(ro_inf) - F32(2 * t) * b2t / (F32(1) - b2t)
    if ro < RADAM_THRESHOLD:
        return 0.0
    num = (ro - F32(4)) * (ro - F32(2)) * F32(ro_inf)
    return float(np.sqrt(num / (F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Epoch-granular schedule: lr as a function of the global step."""

    def epoch_of(step: int) -> int:
        return step // steps_per_epoch

    def base_schedule(step: int) -> float:
        e = epoch_of(step)
        if cfg.lr_scheduler == "steplr":
            return cfg.lr * cfg.decay_gamma ** sum(e >= m for m in cfg.decay_step)
        if cfg.lr_scheduler == "cosine":
            return _EPS + (cfg.lr - _EPS) * 0.5 * (1 + math.cos(math.pi * e / cfg.num_epochs))
        if cfg.lr_scheduler == "poly":
            return cfg.lr * (1 - e / cfg.num_epochs) ** cfg.poly_exp
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")

    if cfg.warmup_epochs > 0 and cfg.optimizer not in ("radam", "ranger"):
        def schedule(step: int) -> float:
            e = epoch_of(step)
            if e >= cfg.warmup_epochs:
                return base_schedule(step)
            frac = min(e / cfg.warmup_epochs, 1.0)
            if cfg.warmup_multiplier == 1.0:
                return cfg.lr * frac
            m = cfg.warmup_multiplier
            return cfg.lr * ((m - 1.0) * frac + 1.0) / m
        return schedule
    return base_schedule


class Optimizer:
    """One of sgd / adam / radam / ranger over a fixed list of parameters,
    updated in place by `step`."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int):
        if cfg.optimizer not in ("sgd", "adam", "radam", "ranger"):
            raise ValueError(f"optimizer not recognized: {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)

    def init(self, params: Sequence[torch.Tensor]) -> State:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.cfg.optimizer == "sgd":
            return {"count": 0, "trace": zeros()}
        state: State = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.cfg.optimizer == "ranger":
            state["slow"] = [p.detach().clone() for p in params]
            state["la_count"] = 0
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: State) -> None:
        """Apply one update to `params` (in place) and advance `state`."""
        cfg = self.cfg
        lr = self.schedule(state["count"])
        grads = [g + cfg.weight_decay * p if cfg.weight_decay else g
                 for p, g in zip(params, grads)]
        state["count"] += 1
        t = state["count"]
        if cfg.optimizer == "sgd":
            updates: List[torch.Tensor] = []
            for g, tr in zip(grads, state["trace"]):
                tr.mul_(cfg.momentum).add_(g)
                updates.append(-lr * tr)
        else:
            # the scalar factors in float32, as optax computes them: RAdam's
            # rectification near rho_t = 5 is sensitive to the last bit
            mu_corr = float(F32(1) - _pow_f32(B1, t))
            nu_corr = float(F32(1) - _pow_f32(B2, t))
            rect = None
            if cfg.optimizer in ("radam", "ranger"):
                rect = _radam_rect_f32(t)
            updates = []
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu.mul_(B1).add_(g, alpha=1 - B1)
                nu.mul_(B2).addcmul_(g, g, value=1 - B2)
                m_hat = mu / mu_corr
                if rect == 0.0:
                    u = m_hat
                else:
                    u = m_hat / ((nu / nu_corr).sqrt() + _EPS)
                    if rect is not None:
                        u = rect * u
                updates.append(-lr * u)
        if cfg.optimizer == "ranger":
            state["la_count"] += 1
            if state["la_count"] % LOOKAHEAD_PERIOD == 0:
                for p, u, slow in zip(params, updates, state["slow"]):
                    slow.add_(p + u - slow, alpha=LOOKAHEAD_STEP)
                    p.copy_(slow)
                return
        for p, u in zip(params, updates):
            p.add_(u)
