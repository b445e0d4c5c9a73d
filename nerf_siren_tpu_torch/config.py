"""Static configuration dataclasses of the port.

Counterpart of `nerf_siren_tpu/config.py`, with the same fields and
defaults: the port keeps its own copy and imports nothing of the JAX
package. The reference drives everything through one argparse namespace
(`opt.py`); here configuration is split into small frozen dataclasses that
every module of the port takes from this file.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Volume rendering: sample counts, disparity sampling, stratified
    perturbation, sigma noise, white background, and the test-time
    sigma-only coarse pass."""

    n_samples: int = 64          # coarse samples per ray
    n_importance: int = 0        # fine (importance) samples per ray
    use_disp: bool = False       # sample linearly in disparity instead of depth
    perturb: float = 0.0         # stratified-perturbation factor (train only)
    noise_std: float = 1.0       # stddev of noise added to raw sigma
    white_back: bool = False     # composite onto white background
    test_time: bool = False      # skip coarse rgb (sigma-only coarse pass)
    chunk: int = 32 * 1024       # rays per tile when rendering full images

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Architecture of the vanilla NeRF MLP."""

    depth: int = 8               # number of xyz-encoding layers
    width: int = 256             # hidden units
    in_channels_xyz: int = 63    # 3 + 3*10*2
    in_channels_dir: int = 27    # 3 + 3*4*2
    skips: Tuple[int, ...] = (4,)
    n_classes: int = 0           # >0 adds the semantic head


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """NeRF positional encoding."""

    in_channels: int = 3
    n_freqs: int = 10
    logscale: bool = True

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 * self.n_freqs + 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization: optimizer, schedule, batch, loss and seed."""

    optimizer: str = "adam"      # sgd | adam | radam | ranger
    lr: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_scheduler: str = "steplr"  # steplr | cosine | poly
    decay_step: Tuple[int, ...] = (2, 4, 8)   # epochs, steplr
    decay_gamma: float = 0.5
    warmup_epochs: int = 0
    warmup_multiplier: float = 1.0
    poly_exp: float = 0.9
    num_epochs: int = 16
    batch_size: int = 1024       # rays per global step
    loss_type: str = "mse"       # mse | msece | msenll
    seed: int = 42
