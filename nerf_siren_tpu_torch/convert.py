"""Carry NeRF and density-proxy weights between JAX param trees and torch state_dicts.

The JAX tree (`nerf_siren_tpu.models.nerf.init_nerf`) holds numpy-convertible
arrays under ``{'xyz_layers': [...], 'xyz_final', 'sigma', 'dir_layer',
'rgb', 'parse': [...]}``, each a ``{'kernel': (in, out), 'bias': (out,)}``.
The torch `NeRF` stores `nn.Linear` weights as `(out, in)`, so kernels are
transposed on the way across. Lists restored from msgpack may arrive as
``{"0": ..., "1": ...}`` dicts; both forms are accepted. The fast
renderer's density proxy (`nerf_siren_tpu.render.fast.init_proxy`) is
``{'l1': {kernel, bias}, 'l2': {kernel, bias}}``, the port's
`render.fast.Proxy`. The EG3D renderer
(`nerf_siren_tpu.render.triplane.init_eg3d_renderer`) is ``{'z',
'backbone': {'mapping': {'fcs': [...], 'w_avg'}, 'synthesis': {'b4':
{'const', 'conv1', 'torgb'}, 'b8': {'conv0', 'conv1', 'torgb'}, ...}},
'decoder': {'fc1', 'fc2'}}``, its FC weights already (out, in): the
port's `render.triplane.EG3DRenderer` names every tensor by its path in
that tree, so the two maps only flatten and nest.

The SIREN field (`nerf_siren_tpu.models.siren.init_siren_nerf`: 'network',
'final_layer', 'color_layer_sine', 'color_layer_linear', 'mapping' and
'parse' linears, the latent 'z') and the semantic point networks under a
checkpoint's 'points' entry (`init_pointnet_dense_cls`: linears and BN
{'scale', 'bias'}; `init_voxel_unet`: convolutions with DHWIO kernels)
map through one walk, `module_from_jax` / `module_to_jax`: the port's
modules (`models.siren.SirenNeRF`, `models.pointnet.PointNetDenseCls`,
`models.voxel_unet.VoxelUNet`) name every tensor by its path in the JAX
tree, a {'kernel', 'bias'} node as the `weight` and `bias` of a torch
layer (a linear's kernel transposed, a convolution's DHWIO kernel as
OIDHW).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_SINGLE = ("xyz_final", "sigma", "dir_layer", "rgb")
_LISTS = ("xyz_layers", "parse")
_PROXY = ("l1", "l2")


def _as_list(node: Any) -> List[Any]:
    if isinstance(node, dict):
        return [node[str(i)] if str(i) in node else node[i] for i in range(len(node))]
    return list(node)


def _put(out: Dict[str, torch.Tensor], prefix: str, lin: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(lin["kernel"], np.float32).T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(lin["bias"], np.float32))


def _get(state_dict: Dict[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    w = state_dict[f"{prefix}.weight"].detach().cpu().float().numpy()
    b = state_dict[f"{prefix}.bias"].detach().cpu().float().numpy()
    return {"kernel": np.ascontiguousarray(w.T), "bias": b.copy()}


def nerf_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NeRF param tree -> `NeRF` state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, lin: Dict[str, Any]) -> None:
        _put(out, prefix, lin)

    for name in _LISTS:
        if name in params:
            for i, lin in enumerate(_as_list(params[name])):
                put(f"{name}.{i}", lin)
    for name in _SINGLE:
        if name in params:
            put(name, params[name])
    return out


def nerf_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """`NeRF` state_dict -> JAX NeRF param tree of float32 numpy arrays."""
    def get(prefix: str) -> Dict[str, np.ndarray]:
        return _get(state_dict, prefix)

    tree: Dict[str, Any] = {}
    for name in _LISTS:
        n = sum(1 for k in state_dict if k.startswith(f"{name}.") and k.endswith(".weight"))
        if n:
            tree[name] = [get(f"{name}.{i}") for i in range(n)]
    for name in _SINGLE:
        tree[name] = get(name)
    return tree


def proxy_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX proxy tree -> `render.fast.Proxy` state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for name in _PROXY:
        _put(out, name, params[name])
    return out


def proxy_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """`render.fast.Proxy` state_dict -> JAX proxy tree of float32 numpy arrays."""
    return {name: _get(state_dict, name) for name in _PROXY}


def eg3d_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `eg3d_renderer` tree -> `EG3DRenderer` state_dict (float32 CPU
    tensors), keyed by the dotted tree path (a list's items by index)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, (list, tuple)):
            node = {str(i): v for i, v in enumerate(node)}
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
            return
        out[prefix[:-1]] = torch.from_numpy(np.array(node, np.float32))

    walk("", params)
    return out


def eg3d_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """`EG3DRenderer` state_dict -> JAX `eg3d_renderer` tree of float32
    numpy arrays (the mapping's `fcs` as a list)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().float().numpy().copy()
    return _lists(tree)


def _lists(node: Any) -> Any:
    """A nested dict with its numbered children ("0", "1", ...) as lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    """A JAX kernel, (in, out) or DHWIO, as a torch weight: (out, in) or OIDHW."""
    return k.T if k.ndim == 2 else k.transpose(4, 3, 0, 1, 2)


def _kernel_to_jax(w: np.ndarray) -> np.ndarray:
    return w.T if w.ndim == 2 else w.transpose(2, 3, 4, 1, 0)


def module_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX tree of a SIREN field or a point network -> the port module's
    state_dict (float32 CPU tensors), keyed by the dotted tree path."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, (list, tuple)):
            node = {str(i): v for i, v in enumerate(node)}
        if isinstance(node, dict) and "kernel" in node:
            kernel = _kernel_to_torch(np.array(node["kernel"], np.float32))
            out[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
            out[f"{prefix}bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, np.float32))

    walk("", params)
    return out


def module_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of `module_from_jax`: the JAX tree of float32 numpy arrays
    (numbered children as lists)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = value.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, a = "kernel", _kernel_to_jax(a)
        node[leaf] = np.ascontiguousarray(a).copy()
    return _lists(tree)


siren_from_jax = points_from_jax = module_from_jax
siren_to_jax = points_to_jax = module_to_jax


def from_jax_for(model: torch.nn.Module):
    """The JAX-tree -> state_dict map of a model of the port."""
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.render.fast import Proxy
    from nerf_siren_tpu_torch.render.triplane import TriPlaneGenerator

    if isinstance(model, TriPlaneGenerator):
        return eg3d_from_jax
    if isinstance(model, Proxy):
        return proxy_from_jax
    return nerf_from_jax if isinstance(model, NeRF) else module_from_jax


def to_jax(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A model's state_dict (or tensors keyed as it) -> its JAX tree."""
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.render.fast import Proxy
    from nerf_siren_tpu_torch.render.triplane import TriPlaneGenerator

    if isinstance(model, TriPlaneGenerator):
        return eg3d_to_jax(state_dict)
    if isinstance(model, Proxy):
        return proxy_to_jax(state_dict)
    return (nerf_to_jax if isinstance(model, NeRF) else module_to_jax)(state_dict)
