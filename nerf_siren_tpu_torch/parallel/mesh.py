"""Device meshes and sharded rendering: one process, many devices.

Counterpart of `nerf_siren_tpu/parallel/mesh.py`. Eval rays are
embarrassingly parallel: JAX splits a frame's rays over the mesh's `data`
axis in contiguous slabs and renders each on its chip with zero
collectives (mesh.py:72-118). The port does the same from one process:

- `Mesh`: a tuple of `torch.device`s on named axes. A device may repeat:
  the tests put two slabs on the CPU twice, the smoke two slabs on one
  card.
- `shard_rays`: contiguous slabs, one a device; `replicate`: a copy of a
  module, tensor or tree of them per device, made once, shared where
  devices repeat (and where a device is the object's own).
- `Mesh.run`: every slab of a mesh of more than one device runs in a host
  thread of its own, on a CUDA stream of its own (streams the mesh keeps)
  started behind the caller's stream and synchronised at the thread's end;
  the caller's stream then waits for all of them. The fast renderer
  synchronises on the host (its block counts and sizes): a host wait then
  blocks only its slab's thread while the other cards' launches go on.
  Each thread takes the caller's grad mode and inference mode, which
  PyTorch keeps per thread. Where a device repeats (the CPU in the tests,
  one card in `chip_smoke.py` phase 27) the route is the same; on one card
  its two threads share the interpreter lock, which phase 27 times against
  one device (PERF.md).
- `sharded_tile_render`: JAX's contract. Each slab is padded to a multiple
  of `chunk` and its tiles rendered in order; the slabs' outputs are
  concatenated on the caller's device and cut back to the frame.
- `cross_replica_param_hash`: JAX's fingerprint, over the leaves in JAX's
  tree order (`convert.py`'s trees), so the same weights give JAX's value
  within float32 summation order.
"""
from __future__ import annotations

import concurrent.futures
import copy
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Outputs = Dict[str, torch.Tensor]


class Mesh:
    """Devices laid out on named axes (row-major over `axis_shapes`)."""

    def __init__(self, devices: Sequence[torch.device], axis_shapes: Tuple[int, ...],
                 axis_names: Sequence[str]):
        if int(np.prod(axis_shapes)) != len(devices):
            raise ValueError(f"axis shapes {tuple(axis_shapes)} do not hold "
                             f"{len(devices)} devices")
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"{len(axis_shapes)} axis shapes for axis names "
                             f"{tuple(axis_names)}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(a) for a in axis_shapes)))
        self._streams: Dict[int, Any] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.shape})"

    def _stream(self, i: int):
        if i not in self._streams:
            self._streams[i] = torch.cuda.Stream(self.devices[i])
        return self._streams[i]

    def run(self, fns: Sequence[Callable], args: Sequence[Any]) -> List[Any]:
        """[fns[i](args[i]) for every device i], each slab from a host thread
        of its own on a stream of its own, under the caller's grad and
        inference modes (the module docstring); the caller's streams then
        wait for every slab."""
        callers = {d: torch.cuda.current_stream(d) for d in set(self.devices)
                   if d.type == "cuda"}
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

        def work(i):
            dev = self.devices[i]
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                if dev.type != "cuda":
                    return fns[i](args[i])
                stream = self._stream(i)
                with torch.cuda.device(dev):
                    stream.wait_stream(callers[dev])
                    with torch.cuda.stream(stream):
                        out = fns[i](args[i])
                    stream.synchronize()
                return out

        if self.size > 1:
            with concurrent.futures.ThreadPoolExecutor(self.size) as pool:
                outs = list(pool.map(work, range(self.size)))
        else:
            outs = [work(0)]
        for i, dev in enumerate(self.devices):
            if dev.type == "cuda":
                callers[dev].wait_stream(self._stream(i))
        return outs


def visible_devices(device_type: str) -> int:
    """Devices of a type a mesh may take: the visible cards, or for the
    CPU its cores (CPU 'devices' are slots sharing the host, as JAX's
    virtual CPU devices)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def mesh_devices(device, num_chips: int) -> List[torch.device]:
    """The devices of `--num_chips` on `device`'s type: 0 every visible card
    (the CPU counts as one), N the first N (N slots of the CPU); a count
    above the visible one is refused, naming it."""
    device = torch.device(device)
    visible = visible_devices(device.type)
    if num_chips < 0:
        raise SystemExit(f"--num_chips {num_chips}: 0 (every visible card) or a count")
    if num_chips > visible:
        what = "CUDA cards are" if device.type == "cuda" else "CPU cores are"
        raise SystemExit(f"--num_chips {num_chips}: {visible} {what} visible")
    if device.type == "cuda":
        n = num_chips or visible
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * max(num_chips, 1)


def make_mesh(axis_shapes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh; by default every visible card on one 'data' axis (the CPU
    alone when no card is visible)."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    if axis_shapes is None:
        axis_shapes = (len(devices),)
    return Mesh(devices, axis_shapes, axis_names)


def _data_devices(mesh: Mesh, axis: str) -> Tuple[torch.device, ...]:
    if mesh.shape[axis] != mesh.size:
        raise ValueError(f"slabs over axis {axis!r} of {mesh}: only a mesh whose devices "
                         f"all lie on that axis")
    return mesh.devices


def shard_rays(batch, mesh: Mesh, axis: str = "data"):
    """Contiguous slabs of a tensor (or a dict of tensors sharing the
    leading ray axis), one per device and moved there; the leading size
    must divide by the mesh's."""
    devices = _data_devices(mesh, axis)
    if isinstance(batch, dict):
        parts = {k: shard_rays(v, mesh, axis) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(len(devices))]
    n = batch.shape[0]
    if n % len(devices):
        raise ValueError(f"{n} rows do not split over {len(devices)} devices")
    per = n // len(devices)
    return [batch[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]


def _device_of(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            return t.device
        return None
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = _device_of(v)
            if d is not None:
                return d
    return None


def _to(tree, device):
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def replicate(tree, mesh: Mesh) -> List[Any]:
    """One copy of a module, tensor or dict of them per device of the mesh,
    made now; a device that repeats, or that is the object's own, shares
    one (the object itself where it is its own)."""
    own = _device_of(tree)
    made: Dict[torch.device, Any] = {}
    out = []
    for d in mesh.devices:
        if d not in made:
            made[d] = tree if own == d else _to(tree, d)
        out.append(made[d])
    return out


def render_slabs(slab_fns: Union[Callable, Sequence[Callable]], mesh: Mesh,
                 rays: torch.Tensor, multiple: int = 1, axis: str = "data") -> Outputs:
    """Render (N, C) rays in contiguous slabs, one per device, each padded to
    a multiple of `multiple` rays: slab_fns[i] (or one function for all)
    maps device i's slab to a dict of per-ray outputs; they are
    concatenated on the rays' device and cut back to N rows."""
    devices = _data_devices(mesh, axis)
    n_dev = len(devices)
    fns = list(slab_fns) if isinstance(slab_fns, (list, tuple)) else [slab_fns] * n_dev
    n = rays.shape[0]
    per = -(-n // (n_dev * multiple)) * multiple
    rays_p = F.pad(rays.float(), (0, 0, 0, per * n_dev - n))
    outs = mesh.run(fns, shard_rays(rays_p, mesh, axis))
    return {k: torch.cat([o[k].to(rays.device) for o in outs])[:n] for k in outs[0]}


def sharded_tile_render(tile_fn: Union[Callable, Sequence[Callable]], mesh: Mesh, chunk: int,
                        axis: str = "data") -> Callable[[torch.Tensor], Outputs]:
    """Mesh-shard a per-tile renderer (JAX's `sharded_tile_render`).

    tile_fn: (chunk, 8) rays -> dict of per-ray tensors, one function for
    every device or one per device (e.g. closures over `replicate`d packs).
    Returns render(rays) for an (N, 8) frame: contiguous slabs, each padded
    to a multiple of `chunk` and rendered tile by tile on its device, the
    outputs concatenated back on the ray axis. Zero collectives."""
    n_dev = mesh.shape[axis]
    fns = list(tile_fn) if isinstance(tile_fn, (list, tuple)) else [tile_fn] * n_dev

    def slab_fn(f):
        def run(slab):
            outs = [f(slab[i: i + chunk]) for i in range(0, slab.shape[0], chunk)]
            return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return run

    def render(rays: torch.Tensor) -> Outputs:
        return render_slabs([slab_fn(f) for f in fns], mesh, rays, chunk, axis)

    return render


def cross_replica_param_hash(params) -> torch.Tensor:
    """JAX's fingerprint of a tree of weights: sum over the leaves, in JAX's
    tree order (dict keys sorted, as `jax.tree_util`), of sum(leaf * 1e-3)
    + sum(|leaf|) * 1e-6, in float32. `params`: a JAX-layout tree of arrays
    (`convert.py`'s `*_to_jax`), a module or a dict of modules (each
    converted by `convert.py::to_jax`)."""
    leaves = _leaves(_as_tree(params))
    acc = torch.zeros((), dtype=torch.float32)
    for leaf in leaves:
        x = torch.as_tensor(np.asarray(leaf)).float() if not isinstance(leaf, torch.Tensor) \
            else leaf.detach().float().cpu()
        acc = acc + torch.sum(x * 1e-3) + torch.sum(x.abs()) * 1e-6
    return acc


def _as_tree(params):
    if isinstance(params, torch.nn.Module):
        from nerf_siren_tpu_torch.convert import to_jax

        return to_jax(params, params.state_dict())
    if isinstance(params, dict):
        return {k: _as_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_as_tree(v) for v in params]
    return params


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
