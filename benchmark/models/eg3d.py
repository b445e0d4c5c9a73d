"""The EG3D configuration on the port: its training system, built from a
configuration file and loaded with the benchmark's weights, and the plain
reference beside it (`benchmark/reference/eg3d.py`)."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark import compare
from benchmark.counts import eg3d as counts
from benchmark.reference import eg3d as ref

REFERENCE = ref
MODEL = "eg3d_renderer"
W_AVG = "backbone.mapping.w_avg"


def triplane_config(cfg: dict, white_back: bool):
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig

    return TriPlaneConfig(
        z_dim=cfg["z_dim"], w_dim=cfg["w_dim"], plane_resolution=cfg["plane_resolution"],
        plane_channels=cfg["plane_channels"], mapping_layers=cfg["mapping_layers"],
        channel_base=cfg["channel_base"], channel_max=cfg["channel_max"],
        rendering=RenderingOptions(
            depth_resolution=cfg["n_samples"], depth_resolution_importance=cfg["n_importance"],
            ray_start=cfg["ray_start"], ray_end=cfg["ray_end"], box_warp=cfg["box_warp"],
            white_back=white_back))


def make_weights(cfg: dict, generator: torch.Generator, kind: str) -> Dict[str, torch.Tensor]:
    return ref.random_weights(cfg, generator)


def train_system(cfg: dict, traffic: dict, weights, device, steps_per_epoch: int):
    """The port's `EG3DSystem` and a fresh training state around a renderer
    holding copies of the weights, as `train.py --mode eg3d` builds them."""
    from nerf_siren_tpu_torch.config import TrainConfig
    from nerf_siren_tpu_torch.render.triplane import EG3DRenderer
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    train_cfg = TrainConfig(optimizer="adam", lr=traffic["lr"],
                            lr_scheduler=traffic["lr_scheduler"],
                            decay_step=tuple(traffic["decay_step"]),
                            decay_gamma=traffic["decay_gamma"],
                            num_epochs=traffic["num_epochs"],
                            batch_size=traffic["rays_per_step"])
    tcfg = triplane_config(cfg, cfg["white_back"])
    system = EG3DSystem(tcfg, train_cfg=train_cfg, steps_per_epoch=steps_per_epoch,
                        device=device)
    model = EG3DRenderer(tcfg, device=device)
    model.load_state_dict({k: v.clone() for k, v in weights.items()})
    return system, system.state_for({MODEL: model})


def flat_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return weights


def nest(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return leaves


def state_leaves(state) -> Dict[str, torch.Tensor]:
    return dict(state.models[MODEL].state_dict())


def first_moments(system, state) -> Dict[str, torch.Tensor]:
    """Adam's first moment as it stands, keyed by the tensors' names."""
    from nerf_siren_tpu_torch.training.system import parameters

    return {n: mu for (_, n, _), mu in zip(parameters(state.models), state.opt_state["mu"])}


def extra_gaps(after_program, after_reference, w0) -> dict:
    """w_avg_gap: the `w_avg` EMA (no gradient moves it): the gap of the
    norms of its change after the checked steps, over the reference's."""
    got = after_program[W_AVG] - w0[W_AVG]
    want = after_reference[W_AVG] - w0[W_AVG]
    n = compare.leaf_norms({"g": got, "w": want})
    return {"w_avg_gap": abs(n["g"] - n["w"]) / n["w"]}


def step_flops(cfg: dict, traffic: dict) -> int:
    return counts.train_step_flops(cfg, traffic["rays_per_step"])


def kernel_step_work(cfg: dict, traffic: dict):
    """No hand-written kernel runs in an EG3D training step."""
    return 0, 0
