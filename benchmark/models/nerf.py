"""The NeRF configuration on the port: its systems and renderers, built
from a configuration file, loaded with the benchmark's weights, and the
plain reference beside them (`benchmark/reference/nerf.py`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.counts import nerf as counts
from benchmark.harness import CACHE_DIR
from benchmark.reference import nerf as ref

FIELDS = ("coarse", "fine")
REFERENCE = ref
PROXY_FREQS = 5     # the density proxy's embedding (render/fast.py)


def nerf_config(cfg: dict):
    from nerf_siren_tpu_torch.config import NeRFConfig

    return NeRFConfig(depth=cfg["depth"], width=cfg["width"],
                      in_channels_xyz=counts.emb_width(cfg["xyz_freqs"]),
                      in_channels_dir=counts.emb_width(cfg["dir_freqs"]),
                      skips=tuple(cfg["skips"]))


def make_weights(cfg: dict, generator: torch.Generator, kind: str) -> Dict[str, ref.Weights]:
    """Both fields' weights, made on the generator's device: 'random'
    (PyTorch's default init) or 'ball' (a ball of density)."""
    make = ref.ball_field if kind == "ball" else ref.random_field
    return {f: make(cfg, generator) for f in FIELDS}


def program_models(cfg: dict, weights: Dict[str, ref.Weights], device):
    """The port's `NeRF` modules holding copies of `weights`."""
    from nerf_siren_tpu_torch.models.nerf import NeRF

    models = {}
    for f in FIELDS:
        m = NeRF(nerf_config(cfg), device=device)
        m.load_state_dict({k: v.clone() for k, v in weights[f].items()})
        models[f] = m
    return models


def train_system(cfg: dict, traffic: dict, weights, device, steps_per_epoch: int):
    """The port's `NeRFSystem` on the traffic's backend, and a fresh
    training state around the weights, as `train.py` builds them."""
    from nerf_siren_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    render_cfg = RenderConfig(n_samples=cfg["n_samples"], n_importance=cfg["n_importance"],
                              perturb=traffic["perturb"], noise_std=traffic["noise_std"],
                              white_back=cfg["white_back"])
    train_cfg = TrainConfig(optimizer="adam", lr=traffic["lr"],
                            lr_scheduler=traffic["lr_scheduler"],
                            decay_step=tuple(traffic["decay_step"]),
                            decay_gamma=traffic["decay_gamma"],
                            num_epochs=traffic["num_epochs"],
                            batch_size=traffic["rays_per_step"])
    system = NeRFSystem(render_cfg, train_cfg, nerf_config(cfg), steps_per_epoch,
                        train_backend=traffic["train_backend"], device=device)
    state = system.state_for(program_models(cfg, weights, device))
    return system, state


def flat_weights(weights: Dict[str, ref.Weights]) -> Dict[str, torch.Tensor]:
    """Both fields' weights keyed '<field>.<name>'."""
    return {f"{f}.{k}": v for f, ws in weights.items() for k, v in ws.items()}


def nest(leaves: Dict[str, torch.Tensor]) -> Dict[str, ref.Weights]:
    """Leaves keyed '<field>.<name>' as both fields' weights."""
    return {f: {k[len(f) + 1:]: v for k, v in leaves.items() if k.startswith(f + ".")}
            for f in FIELDS}


def state_leaves(state) -> Dict[str, torch.Tensor]:
    """The training state's weights, keyed '<field>.<name>' as the reference keys them."""
    return {f"{f}.{k}": v for f in FIELDS for k, v in state.models[f].state_dict().items()}


def first_moments(system, state) -> Dict[str, torch.Tensor]:
    """Adam's first moment as it stands, keyed '<field>.<name>'."""
    from nerf_siren_tpu_torch.training.system import parameters

    names = [f"{k}.{n}" for k, n, _ in parameters(state.models)]
    return dict(zip(names, state.opt_state["mu"]))


def step_flops(cfg: dict, traffic: dict) -> int:
    return counts.train_step_flops(cfg, traffic["rays_per_step"])


def kernel_step_work(cfg: dict, traffic: dict):
    """(flops, bytes) of the field kernels' work in one training step."""
    rays = traffic["rays_per_step"]
    return counts.train_step_flops(cfg, rays), counts.train_step_bytes(cfg, rays)


def eval_render_config(cfg: dict, traffic: dict):
    """The eval CLI's test-time render config."""
    from nerf_siren_tpu_torch.config import RenderConfig

    return RenderConfig(n_samples=cfg["n_samples"], n_importance=cfg["n_importance"],
                        white_back=cfg["white_back"], test_time=True, perturb=0.0,
                        noise_std=0.0, chunk=traffic["chunk"])


def render_setup(run, cfg: dict, traffic: dict, weights, device):
    """The eval CLI's renderer of the traffic's kind over the port's models,
    as `eval.py` builds it (`make_renderer`). 'fast' first runs the CLI's
    fast set-up (`setup_fast_proxy`: the proxy distilled from the fine
    field, the scene box; a `fast_setup` span) at the CLI's defaults and the
    traffic's `cli` flags, on a checkpoint file of its own under
    `benchmark/.cache/` and no proxy cache."""
    from nerf_siren_tpu_torch.eval import get_opts, make_renderer, setup_fast_proxy

    models = program_models(cfg, weights, device)
    render_cfg = eval_render_config(cfg, traffic)
    if traffic["renderer"] != "fast":
        return make_renderer(models, render_cfg, renderer=traffic["renderer"])
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint

    ckpt = CACHE_DIR / "fast_setup.msgpack"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(ckpt), {"seed": np.asarray(run.seed % 2 ** 31)})
    hp = get_opts(["--root_dir", ".", "--ckpt_path", str(ckpt), "--fast_proxy_path", "none"]
                  + [str(a) for kv in traffic.get("cli", {}).items() for a in kv])
    with run.spans.span("fast_setup"):
        fast = setup_fast_proxy(models, hp, np.array([cfg["near"], cfg["far"]]))
    run.readings.update(n_candidates=hp.fast_candidates, n_keep=hp.fast_keep,
                        proxy_hidden=fast.proxy.l1.weight.shape[0])
    return make_renderer(models, render_cfg, renderer="fast", fast=fast, hparams=hp)


def reference_render(weights, cfg: dict, rays: torch.Tensor, op, block: int = 8192):
    """The reference's exact coarse + fine render of `rays`, `block` rays at
    a time: what both frame renderers are held against."""
    outs = [ref.render(weights["coarse"], weights["fine"], cfg, rays[a:a + block], op)
            for a in range(0, rays.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def frame_work(cfg: dict, traffic: dict, rays: int, readings: dict) -> dict:
    """The counted work of one frame: its model flops, and the field
    kernel's flops and bytes (exact: both passes at the frame's points;
    fast: the full pass at K survivors a ray), and the proxy kernel's."""
    if traffic["renderer"] != "fast":
        flops = counts.frame_flops(cfg, rays)
        return dict(frame_flops=flops, k1_frame_flops=flops,
                    k1_frame_bytes=counts.frame_bytes(cfg, rays))
    c, k, hidden = readings["n_candidates"], readings["n_keep"], readings["proxy_hidden"]
    k1 = counts.survivor_flops(cfg, rays * k)
    k3 = counts.proxy_flops(hidden, PROXY_FREQS, rays * c)
    return dict(frame_flops=k1 + k3, k1_frame_flops=k1,
                k1_frame_bytes=counts.survivor_bytes(cfg, rays * k, rays),
                k3_frame_flops=k3, k3_frame_bytes=counts.proxy_bytes(hidden, PROXY_FREQS, rays, k))
