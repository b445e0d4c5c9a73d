"""Debugging / observability utilities — the counterparts of the JAX
package's `utils/debug.py` (and the reference's aux subsystems):

- `profile_trace`: a `torch.profiler` trace of the block, written as a
  Chrome trace (Perfetto, chrome://tracing) into `log_dir`,
- `named_scope`: `torch.profiler.record_function`, a named span in it,
- `enable_nan_debug`: autograd's anomaly mode, which names the forward
  operation whose backward produced a NaN,
- `check_replica_consistency`: the parameter fingerprint
  (`parallel/mesh.py::cross_replica_param_hash`) all-gathered over the
  process group, raising when any rank's differs (the reference's DDP
  param-hash check, torch_utils/misc.py:182-196),
- `assert_all_finite`: a host check of every tensor of a tree.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_siren_tpu_torch.parallel.mesh import cross_replica_param_hash

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def profile_trace(log_dir: str = "trace"):
    """Profile the block (the CPU, and every card when one is visible) and
    write `log_dir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debug(enabled: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enabled)


def check_replica_consistency(params: Any, reference_hash: Optional[float] = None,
                              atol: float = 1e-5, group=None) -> float:
    """Fingerprint `params`; raise if `reference_hash` is given and differs
    (JAX's tolerance), or, in a process group of more than one rank, if any
    rank's fingerprint differs from this one's (replicated weights are
    byte-equal, so their fingerprints are equal)."""
    h = cross_replica_param_hash(params)
    value = float(h)
    if reference_hash is not None and not np.isclose(value, reference_hash, atol=atol,
                                                     rtol=1e-6):
        raise AssertionError(f"replica params diverged: hash {value} != reference "
                             f"{reference_hash}")
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        mine = h.reshape(1).to(device)
        parts: List[torch.Tensor] = [torch.empty_like(mine)
                                     for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        hashes = [float(p) for p in parts]
        if any(x != hashes[0] for x in hashes):
            raise AssertionError(f"replica params diverged across ranks: hashes {hashes}")
    return value


def _walk(tree, path: str):
    if isinstance(tree, torch.nn.Module):
        for k, v in tree.state_dict().items():
            yield f"{path}.{k}", v
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise if any tensor or array of the tree (modules: their state_dict)
    holds a NaN or an Inf."""
    for path, leaf in _walk(tree, ""):
        arr = leaf.detach().float().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            raise FloatingPointError(f"non-finite values in {name}{path}")
