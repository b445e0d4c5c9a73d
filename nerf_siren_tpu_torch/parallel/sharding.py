"""Parameter sharding layouts over a `model` axis.

Counterpart of `nerf_siren_tpu/parallel/sharding.py`. Data parallelism
(weights replicated, rays sharded) is the layout the port trains with. For
scale-out headroom the NeRF MLP can also be tensor-sharded over a 'model'
axis, JAX's plan expressed as `torch.distributed.tensor` placements:
trunk layer i splits its output features when i is even (`Shard(0)` of
the `nn.Linear` weight, the bias too) and its input features when i is odd
(`Shard(1)`, the bias replicated): the column- / row-parallel alternation,
one collective per pair of layers. The heads stay replicated, and so does
everything on a model axis of size 1. `jax_spec` names a placement as
JAX's `PartitionSpec` of the same tensor in JAX's layout (kernel (in,
out)), which is how the tests hold the plan to `nerf_param_sharding`.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch import nn

_TRUNK = re.compile(r"^xyz_layers\.(\d+)\.(weight|bias)$")


def nerf_param_placements(model: nn.Module, model_axis_size: int) -> Dict[str, object]:
    """name -> placement of each parameter of a `NeRF` on a model axis of
    `model_axis_size` devices."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for name, _ in model.named_parameters():
        m = _TRUNK.match(name)
        if model_axis_size == 1 or m is None:
            out[name] = Replicate()
        elif int(m.group(1)) % 2 == 0:     # column parallel: output features
            out[name] = Shard(0)
        else:                              # row parallel: input features
            out[name] = Shard(1) if m.group(2) == "weight" else Replicate()
    return out


def jax_spec(placement, ndim: int, model_axis: str = "model") -> Tuple:
    """JAX's PartitionSpec entries of the same tensor in JAX's layout (a
    weight's kernel is its transpose), trailing Nones dropped."""
    from torch.distributed.tensor import Shard

    if not isinstance(placement, Shard):
        return ()
    dim = placement.dim if ndim == 1 else 1 - placement.dim
    return tuple([None] * dim + [model_axis])


def shard_module(model: nn.Module, device_mesh, placements: Dict[str, object]) -> nn.Module:
    """Replace `model`'s parameters, in place, by DTensors laid out on the
    one-axis `device_mesh` as `placements` says; returns the model."""
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        setattr(owner, leaf, nn.Parameter(
            distribute_tensor(p.detach(), device_mesh, [placements[name]]),
            requires_grad=p.requires_grad))
    return model


def sharded_forward(model: nn.Module, device_mesh, xyz_emb: torch.Tensor,
                    dir_emb: torch.Tensor = None) -> torch.Tensor:
    """The field's forward on a model sharded by `shard_module`: the inputs
    replicated, the output gathered whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    def rep(x):
        return None if x is None else DTensor.from_local(x, device_mesh, [Replicate()],
                                                          run_check=False)

    return model(rep(xyz_emb), rep(dir_emb)).full_tensor()
