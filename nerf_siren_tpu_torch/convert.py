"""Carry NeRF weights between the JAX param tree and a torch state_dict.

The JAX tree (`nerf_siren_tpu.models.nerf.init_nerf`) holds numpy-convertible
arrays under ``{'xyz_layers': [...], 'xyz_final', 'sigma', 'dir_layer',
'rgb', 'parse': [...]}``, each a ``{'kernel': (in, out), 'bias': (out,)}``.
The torch `NeRF` stores `nn.Linear` weights as `(out, in)`, so kernels are
transposed on the way across. Lists restored from msgpack may arrive as
``{"0": ..., "1": ...}`` dicts; both forms are accepted.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_SINGLE = ("xyz_final", "sigma", "dir_layer", "rgb")
_LISTS = ("xyz_layers", "parse")


def _as_list(node: Any) -> List[Any]:
    if isinstance(node, dict):
        return [node[str(i)] if str(i) in node else node[i] for i in range(len(node))]
    return list(node)


def nerf_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NeRF param tree -> `NeRF` state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, lin: Dict[str, Any]) -> None:
        out[f"{prefix}.weight"] = torch.from_numpy(np.array(lin["kernel"], np.float32).T.copy())
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(lin["bias"], np.float32))

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
        w = state_dict[f"{prefix}.weight"].detach().cpu().float().numpy()
        b = state_dict[f"{prefix}.bias"].detach().cpu().float().numpy()
        return {"kernel": np.ascontiguousarray(w.T), "bias": b.copy()}

    tree: Dict[str, Any] = {}
    for name in _LISTS:
        n = sum(1 for k in state_dict if k.startswith(f"{name}.") and k.endswith(".weight"))
        if n:
            tree[name] = [get(f"{name}.{i}") for i in range(n)]
    for name in _SINGLE:
        tree[name] = get(name)
    return tree
