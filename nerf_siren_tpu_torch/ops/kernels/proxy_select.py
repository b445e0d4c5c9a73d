"""Proxy top-K selection (K6): plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of `nerf_siren_tpu/ops/pallas/proxy_select.py` (the TPU kernel
`_kernel`, experimental there: no renderer calls it). The kernel is
`csrc/proxy_select.cu`. It takes the proxy kernels' pack
(`proxy_march.pack_proxy_params`, re-exported here) and, per ray, scores C
uniform candidates z_i = near (1 - t_i) + far t_i, t_i = i / (C - 1), with
the density proxy (bf16 operands, float32 sums) and keeps the K highest
scores, the lower index first among equals, as depths in score order.

- `proxy_select_ref`: the plain version (the score of
  `proxy_march.proxy_scores_ref`, a stable descending sort).
- `proxy_select`: the public wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. `LAUNCHES` counts
  kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from nerf_siren_tpu_torch.ops.kernels.proxy_march import (  # noqa: F401 (re-export)
    Packed, _div, current_stream, pack_proxy_params, proxy_scores_ref, weight_args)

LAUNCHES = {"select": 0}


def _depths(rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    t = _div(torch.arange(n_candidates, dtype=torch.float32, device=rays.device), n_candidates - 1)
    return rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t


def proxy_select_ref(packed: Packed, rays: torch.Tensor, n_candidates: int,
                     n_keep: int) -> torch.Tensor:
    """Plain version of `proxy_select`: (R, K) depths in score order."""
    z = _depths(rays, n_candidates)
    score = proxy_scores_ref(packed, rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None])
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :n_keep]
    return z.gather(1, order)


def _fn():
    from nerf_siren_tpu_torch.ops.kernels import _build

    fn = _build.load("proxy_select").proxy_select_forward
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, p, ll, i, i, p, p]
    fn.restype = i
    return fn


def proxy_select(packed: Packed, rays: torch.Tensor, n_candidates: int = 64,
                 n_keep: int = 16) -> torch.Tensor:
    """rays (R, 8) f32 -> the depths (R, n_keep) of the n_keep candidates
    with the highest proxy score, in score order."""
    if not 1 <= n_keep <= n_candidates:
        raise ValueError(f"proxy_select needs 1 <= n_keep <= n_candidates, got {n_keep}")
    if rays.device.type == "cpu":
        return proxy_select_ref(packed, rays, n_candidates, n_keep)
    args = weight_args(packed, rays, n_candidates)
    z = torch.empty((rays.shape[0], n_keep), dtype=torch.float32, device=rays.device)
    err = _fn()(*args, rays.data_ptr(), rays.shape[0], n_candidates, n_keep, z.data_ptr(),
                current_stream(rays.device))
    if err != 0:
        raise RuntimeError(f"proxy_select_forward failed: cudaError {err}")
    LAUNCHES["select"] += 1
    return z
