"""Load the JAX package's msgpack checkpoints into torch models.

Counterpart of the loading half of `nerf_siren_tpu/training/checkpoints.py`.
The files are flax `msgpack_serialize` output, decoded here without flax:
arrays are msgpack ext type 1 (and numpy scalars ext type 3), each holding
a packed ``(shape, dtype name, C-order bytes)`` triple. Models are keyed by
name (`nerf_coarse`, `nerf_fine`, ...), and full-resume checkpoints nest
them under 'params'. `msgpack` is imported only when a file is read.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from nerf_siren_tpu_torch.convert import nerf_from_jax

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _decode_array(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy()
    else:
        flat = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
    return flat.reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _decode_array(data)
    if code == _EXT_NPSCALAR:
        return _decode_array(data)[()]
    return msgpack.ExtType(code, data)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's tree of dicts, lists and numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def extract_model_state(ckpt: Dict[str, Any], model_name: str,
                        prefixes_to_ignore: Iterable[str] = ("loss",)) -> Optional[Dict[str, Any]]:
    """One model's param tree from a checkpoint, or None."""
    if model_name in tuple(prefixes_to_ignore):
        return None
    src = ckpt.get("params", ckpt)
    return src.get(model_name)


def load_ckpt(model: nn.Module, path: str, model_name: str,
              prefixes_to_ignore: Iterable[str] = ("loss",)) -> nn.Module:
    """Warm-start a `NeRF` from the `model_name` tree of a checkpoint file.

    Non-strict like the JAX `load_ckpt`: tensors whose name and shape match
    are taken, the rest keep their init, and a load that takes nothing is
    reported instead of raised."""
    if not path or model_name in tuple(prefixes_to_ignore):
        return model
    sub = extract_model_state(load_checkpoint(path), model_name, prefixes_to_ignore)
    if sub is None:
        print(f"WARNING: checkpoint {path} has no '{model_name}' "
              f"parameters - keeping the (random) init", flush=True)
        return model
    state = model.state_dict()
    taken = skipped = 0
    for k, v in nerf_from_jax(sub).items():
        if k not in state:
            continue
        if state[k].shape != v.shape:
            skipped += 1
            continue
        state[k] = v.to(state[k].device, state[k].dtype)
        taken += 1
    model.load_state_dict(state)
    if taken == 0:
        print(f"WARNING: checkpoint {path} matched ZERO '{model_name}' tensors "
              f"({skipped} shape mismatches, {len(state) - skipped} missing) - "
              f"keeping the (random) init", flush=True)
    elif skipped:
        print(f"NOTE: '{model_name}' load from {path}: {taken} tensors taken, "
              f"{skipped} skipped on shape mismatch", flush=True)
    return model
