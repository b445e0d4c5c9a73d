"""The semantic NeRF configuration (`--mode d3`, PointNet) on the port: the
training system `train.py` builds from its flags, loaded with the
benchmark's weights, and the plain reference beside it
(`benchmark/reference/nerf3d.py`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import scenes
from benchmark.counts import nerf3d as counts
from benchmark.models import nerf
from benchmark.reference import nerf as ref_nerf
from benchmark.reference import nerf3d as ref

REFERENCE = ref
FIELDS = nerf.FIELDS


def make_weights(cfg: dict, generator: torch.Generator, kind: str) -> Dict[str, ref.Weights]:
    """Both fields' weights (`nerf.make_weights` of `kind`) and the point
    network's (PyTorch's default init), made on the generator's device."""
    weights = nerf.make_weights(cfg, generator, kind)
    weights["points"] = ref.random_pointnet(cfg["n_classes"], cfg["point_inputs"], generator)
    return weights


def class_table(rays, cfg: dict, seed: int, device, block: int = 1 << 24):
    """The class target of every ray (int64, on the host as a loader holds
    it): the argmax over the configuration's classes of p @ A + b, p the
    ray's point at depth 4 and A (3, k), b (k,) drawn from the seed, made on
    `device` `block` rays at a time."""
    k = cfg["n_classes"]
    g = scenes.torch_generator(seed, device, 3)
    a = torch.randn(3, k, generator=g, device=device) * 2.0
    b = torch.rand(k, generator=g, device=device) * 2.0
    out = np.empty(len(rays), np.int64)
    for lo in range(0, len(rays), block):
        r = torch.as_tensor(rays[lo:lo + block], device=device)
        p = r[:, 0:3] + r[:, 3:6] * 4.0
        out[lo:lo + r.shape[0]] = (p @ a + b).argmax(-1).cpu().numpy()
    return out


def cli_args(cfg: dict, traffic: dict) -> list:
    """The train CLI's flags of the cell (`--mode d3` on its defaults but
    the sizes and the schedule)."""
    return ["--root_dir", ".", "--mode", "d3", "--semantic_network", cfg["semantic_network"],
            "--point_norm", cfg["point_norm"], "--point_capacity", str(traffic["point_capacity"]),
            "--N_samples", str(cfg["n_samples"]), "--N_importance", str(cfg["n_importance"]),
            "--perturb", str(traffic["perturb"]), "--noise_std", str(traffic["noise_std"]),
            "--batch_size", str(traffic["rays_per_step"]), "--loss_type", traffic["loss_type"],
            "--optimizer", "adam", "--lr", str(traffic["lr"]),
            "--lr_scheduler", traffic["lr_scheduler"],
            "--decay_step", *[str(d) for d in traffic["decay_step"]],
            "--decay_gamma", str(traffic["decay_gamma"]),
            "--num_epochs", str(traffic["num_epochs"])]


def cli_options(cfg: dict, traffic: dict):
    """The train CLI's parsed flags (`opt.get_opts`): a program whose CLI
    lacks one of them stops here, before any work."""
    from nerf_siren_tpu_torch.opt import get_opts

    return get_opts(cli_args(cfg, traffic))


def train_system(hparams, cfg: dict, weights, device, steps_per_epoch: int):
    """The system `train.py` builds from `hparams` (`build_system`:
    `NeRF3DSystem`), and a fresh state around the benchmark's weights."""
    from nerf_siren_tpu_torch.train import build_system
    from nerf_siren_tpu_torch.training.semantic_system import make_points_network

    system = build_system(hparams, cfg["white_back"], steps_per_epoch, device,
                          n_classes=cfg["n_classes"])
    if getattr(system, "point_capacity", None) != hparams.point_capacity or \
            system.nerf_cfg != nerf.nerf_config(cfg):
        raise RuntimeError("the train CLI built another semantic system than the cell's")
    models = nerf.program_models(cfg, weights, device)
    points = make_points_network(cfg["semantic_network"], cfg["n_classes"]).to(device)
    points.load_state_dict({k: v.clone() for k, v in weights["points"].items()})
    models["points"] = points
    return system, system.state_for(models)


def state_leaves(state) -> Dict[str, torch.Tensor]:
    """The point network's weights, named as the reference names them."""
    return dict(state.models["points"].state_dict())


def field_leaves(state) -> Dict[str, torch.Tensor]:
    """Both fields' weights, keyed '<field>.<name>'."""
    return {f"{f}.{k}": v for f in FIELDS for k, v in state.models[f].state_dict().items()}


def first_moments(system, state) -> Dict[str, torch.Tensor]:
    """Adam's first moment of the point network as it stands."""
    from nerf_siren_tpu_torch.training.system import parameters

    return {n: mu for (k, n, _), mu in zip(parameters(state.models), state.opt_state["mu"])
            if k == "points"}


def step_flops(cfg: dict, traffic: dict, points: float) -> int:
    """The step's model flops at `points` valid points a step."""
    return counts.step_flops(cfg, traffic, points)


def reference_fields(weights) -> Dict[str, ref_nerf.Weights]:
    return {f: weights[f] for f in FIELDS}


def flat_fields(weights) -> Dict[str, torch.Tensor]:
    """Both fields' weights keyed '<field>.<name>', as `field_leaves` keys the state's."""
    return nerf.flat_weights(reference_fields(weights))
