"""msgpack checkpoints that load into both packages.

Counterpart of `nerf_siren_tpu/training/checkpoints.py`. The files are in
flax's `msgpack_serialize` encoding, written and read here without flax:
arrays are msgpack ext type 1 (numpy scalars ext type 3), each holding a
packed ``(shape, dtype name, C-order bytes)`` triple. Models are keyed by
name (`nerf_coarse`, `nerf_fine`, `points`, `eg3d_renderer`, `proxy`) with
the JAX package's parameter trees (`convert.nerf_to_jax`,
`convert.siren_to_jax` for a SIREN field under the `nerf_*` names,
`convert.points_to_jax` for the semantic point network,
`convert.eg3d_to_jax`, `convert.proxy_to_jax` for the culled backends'
online proxy), and
full-resume checkpoints nest them under 'params', so the JAX package's
`load_ckpt` and `eval.py` read what the port trains, and the port reads
what the JAX package trains.

A full-resume file (`save_train_state`) holds
  {"params": {"nerf_coarse": tree, "nerf_fine": tree[, "points" | "proxy": tree]}
             (or {"eg3d_renderer": tree}: the whole renderer, `w_avg`,
             the `noise_const`s and z included),
   "opt_state": {"optimizer": name, "count": int, <slot>: {model name: tree}, ...},
   "step": int64 array, "epoch": int64 array}
where the slots are the port's optimizer state (`training/optimizers.py`:
"mu"/"nu" for adam and radam, "trace" for sgd, plus "slow" and "la_count"
for ranger), each laid out like the parameters. That optimizer layout is
the port's own: a full resume of it is guaranteed within the port only.
`msgpack` is imported only when a file is read or written.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_siren_tpu_torch.convert import eg3d_from_jax, from_jax_for, to_jax

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
MODEL_NAMES = {"coarse": "nerf_coarse", "fine": "nerf_fine", "points": "points",
               "proxy": "proxy"}


def _encode_array(a: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _encode_array(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _encode_array(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x)}")


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write a tree of dicts, lists, numbers, strings and numpy arrays
    atomically (a temporary file, then a rename)."""
    import msgpack

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack.packb(tree, default=_ext_pack, strict_types=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


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
              prefixes_to_ignore: Iterable[str] = ("loss",),
              from_jax: Optional[Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]] = None
              ) -> nn.Module:
    """Warm-start `model` from the `model_name` tree of a checkpoint file,
    mapped to its state_dict by `from_jax` (by default the map of the
    model's type, `convert.from_jax_for`; `load_eg3d_ckpt` passes the EG3D
    renderer's).

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
    for k, v in (from_jax or from_jax_for(model))(sub).items():
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


def load_nerf_fields(path: str, device, n_importance: int = 1,
                     nerf_cfg=None) -> Dict[str, nn.Module]:
    """The checkpoint's `nerf_coarse` (and, with n_importance > 0,
    `nerf_fine`) weights in fresh fields of `nerf_cfg` (default the
    full-width `NeRFConfig()`) on `device`, in eval mode; a tensor the file
    lacks keeps the init drawn from a seed-0 (coarse) or seed-1 (fine)
    generator, as the JAX CLIs' `init_nerf(PRNGKey(0 / 1))`."""
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.models.nerf import NeRF

    names = (("coarse", "nerf_coarse"), ("fine", "nerf_fine"))[: 2 if n_importance > 0 else 1]
    models = {}
    for seed, (key, name) in enumerate(names):
        net = NeRF(nerf_cfg or NeRFConfig(), generator=torch.Generator().manual_seed(seed))
        models[key] = load_ckpt(net, path, name).to(device).eval()
    return models


def load_eg3d_ckpt(model: nn.Module, path: str,
                   model_name: str = "eg3d_renderer") -> nn.Module:
    """Load the `eg3d_renderer` tree (backbone, decoder, z) of a checkpoint
    into an `EG3DRenderer`, non-strict and loud as `load_ckpt`."""
    return load_ckpt(model, path, model_name, from_jax=eg3d_from_jax)


# -- full training-state checkpoints (resume) ---------------------------------

def _named_trees(models: Dict[str, nn.Module], tensors) -> Dict[str, Any]:
    """Per-parameter tensors in `system.parameters` order -> {model name:
    JAX-layout tree of numpy arrays}."""
    from nerf_siren_tpu_torch.training.system import parameters

    per_model: Dict[str, Dict[str, torch.Tensor]] = {}
    for (key, name, _), t in zip(parameters(models), tensors):
        per_model.setdefault(key, {})[name] = t
    return {MODEL_NAMES.get(k, k): to_jax(models[k], sd) for k, sd in per_model.items()}


def _from_named_trees(models: Dict[str, nn.Module], trees: Dict[str, Any]):
    """Inverse of `_named_trees`: float32 CPU tensors in parameter order."""
    from nerf_siren_tpu_torch.training.system import parameters

    sds = {k: from_jax_for(m)(trees[MODEL_NAMES.get(k, k)]) for k, m in models.items()}
    return [sds[key][name] for key, name, _ in parameters(models)]


def train_state_tree(state, epoch: int, optimizer: str) -> Dict[str, Any]:
    """The checkpoint tree of a `TrainState` (numpy, fetched from the
    device on the calling thread)."""
    from nerf_siren_tpu_torch.training.system import parameters

    params = [p for _, _, p in parameters(state.models)]
    opt: Dict[str, Any] = {"optimizer": optimizer}
    for k, v in state.opt_state.items():
        opt[k] = _named_trees(state.models, v) if isinstance(v, list) else np.asarray(v)
    return {"params": _named_trees(state.models, params), "opt_state": opt,
            "step": np.asarray(state.step, np.int64), "epoch": np.asarray(epoch, np.int64)}


def save_train_state(path: str, state, epoch: int, optimizer: str) -> None:
    """Save params + optimizer state + step for an exact resume."""
    save_checkpoint(path, train_state_tree(state, epoch, optimizer))


class AsyncCheckpointer:
    """Overlap checkpoint writes with training. The device -> host fetch
    runs on the calling thread (a consistent snapshot); the serialization
    and the atomic write run on one background worker, in save order.
    `wait()` joins every pending write and raises the first failure."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []

    @staticmethod
    def _raise_first(futures) -> None:
        err = None
        for fut in futures:     # join all before raising: no abandoned write
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 - surfaced to the caller
                if err is None:
                    err = e
        if err is not None:
            raise err

    def save_train_state(self, path: str, state, epoch: int, optimizer: str) -> None:
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        self._raise_first(done)
        tree = train_state_tree(state, epoch, optimizer)
        self._pending.append(self._pool.submit(save_checkpoint, path, tree))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        self._raise_first(pending)

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def restore_train_state(path: str, state, optimizer: str) -> Tuple[Any, int]:
    """Load a port checkpoint into `state` (its models and optimizer state,
    in place); returns (state, next epoch)."""
    from nerf_siren_tpu_torch.training.system import parameters

    ckpt = load_checkpoint(path)
    opt = ckpt["opt_state"]
    if opt.get("optimizer") != optimizer:
        raise ValueError(f"{path}: optimizer state of {opt.get('optimizer')!r}, "
                         f"this run uses {optimizer!r}")
    with torch.no_grad():
        for (_, _, p), v in zip(parameters(state.models),
                                _from_named_trees(state.models, ckpt["params"])):
            p.copy_(v)
        for k, v in state.opt_state.items():
            if isinstance(v, list):
                for t, src in zip(v, _from_named_trees(state.models, opt[k])):
                    t.copy_(src)
            else:
                state.opt_state[k] = int(opt[k])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"])
