"""Proxy top-K selection (K6): plain PyTorch version and the CUDA kernel's wrappers.

Counterpart of `nerf_siren_tpu/ops/pallas/proxy_select.py` (the TPU kernel
`_kernel`, experimental there: no renderer calls it). The kernel is the
TOPK epilogue of `csrc/proxy_march.cu`: the proxy march's scoring stage on
the tensor cores, then a top-K by rank from shared memory. It takes the
proxy kernels' pack (`proxy_march.pack_proxy_params`, re-exported here)
and, per ray, scores C uniform candidates z_i = near (1 - t_i) + far t_i,
t_i = i / (C - 1) (t = 0 at C = 1, as JAX's `linspace(0, 1, 1)`), with
the density proxy (bf16 operands, float32 sums) and keeps the K highest
scores, the lower index first among equals, as depths in score order.
Up to `MAX_CANDIDATES` a ray's scores stay in shared memory and each
candidate counts its rank; above it they live in a device scratch and K
passes of a block-wide arg-max take the candidates of rank 0, 1, ...,
K - 1 in turn (the same sets in the same order, O(K C) instead of O(C^2)).

- `candidate_depths`: the candidates, rounded as the kernel rounds them.
- `proxy_select_ref`: the plain version (the score of
  `proxy_march.proxy_scores_ref`, then `select_order`: a stable descending
  sort); given `scores`, the selection alone on those scores.
- `rank_select_ref`: the kernel's rank rule in plain PyTorch, a twin of
  `select_order`.
- `cut_swaps`: where the candidates kept under the kernel's scores differ
  from the plain ones, how far apart the swapped candidates' plain scores
  lie, against `proxy_march.proxy_score_bar`.
- `proxy_select`: the public wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. `LAUNCHES` counts
  kernel launches (through `utils/tracing.py::count_launch`). `proxy_select_scores`
  reads the kernel's scores back with its depths (a reading for the tests
  and the smoke, not counted).

The kernel sums the proxy in the tensor cores' order, so its scores lie
within `proxy_score_bar` of the plain ones, and given its own scores the
plain selection equals its depths bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerf_siren_tpu_torch.ops.kernels.proxy_march import (  # noqa: F401 (re-export)
    MAX_C, MAX_CANDIDATES, Packed, _div, _lib, check_range, current_stream, k3_args,
    pack_proxy_params, proxy_scores_ref, scratch_args, scratch_for)
from nerf_siren_tpu_torch.utils.tracing import count_launch

LAUNCHES = {"select": 0, "select_scratch": 0}   # above MAX_CANDIDATES: 'select_scratch'


def candidate_depths(rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """(R, C) near (1 - t) + far t at t = i / max(C - 1, 1)."""
    t = _div(torch.arange(n_candidates, dtype=torch.float32, device=rays.device),
             max(n_candidates - 1, 1))
    return rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t


def candidate_scores_ref(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """(R, C) the plain scores of the candidates, at o + d z."""
    z = candidate_depths(rays, n_candidates)
    return proxy_scores_ref(packed, rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None])


def select_order(scores: torch.Tensor, n_keep: int) -> torch.Tensor:
    """(R, K) the indices of the K highest scores, the lower index first
    among equals: a stable descending sort."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :n_keep]


def rank_select_ref(scores: torch.Tensor, n_keep: int) -> torch.Tensor:
    """The kernel's rule: candidate j's rank is #{i : s_i > s_j or (s_i ==
    s_j and i < j)}, and the candidates of rank < K go to their rank. (R, K)
    indices; equal to `select_order`."""
    r, c = scores.shape
    idx = torch.arange(c, device=scores.device)
    s_i, s_j = scores[:, None, :], scores[:, :, None]
    rank = ((s_i > s_j) | ((s_i == s_j) & (idx[None, :] < idx[:, None]))).sum(2)
    kept = rank < n_keep
    out = torch.full((r, n_keep), -1, dtype=torch.long, device=scores.device)
    rows = torch.arange(r, device=scores.device)[:, None].expand(r, c)
    out[rows[kept], rank[kept]] = idx.expand(r, c)[kept]
    return out


def proxy_select_ref(packed: Packed, rays: torch.Tensor, n_candidates: int, n_keep: int,
                     scores: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `proxy_select`: (R, K) depths in score order, on the
    given candidates' scores (R, C) or on `candidate_scores_ref`."""
    if scores is None:
        scores = candidate_scores_ref(packed, rays, n_candidates)
    return candidate_depths(rays, n_candidates).gather(1, select_order(scores, n_keep))


def _kept(scores: torch.Tensor, n_keep: int) -> torch.Tensor:
    return torch.zeros_like(scores, dtype=torch.bool).scatter_(1, select_order(scores, n_keep),
                                                               True)


def cut_swaps(ref_scores: torch.Tensor, bar: torch.Tensor, scores: torch.Tensor,
              n_keep: int) -> Tuple[int, float]:
    """(rays whose kept candidates under `scores` differ from those under
    the plain `ref_scores`, the largest |ref_a - ref_b| / (bar_a + bar_b)
    over candidates a kept only under `scores` and b kept only under
    `ref_scores` in such a ray; 0 where none). At most 1: every swap across
    the cut is a near tie that the summation order moved."""
    kept, ref_kept = _kept(scores, n_keep), _kept(ref_scores, n_keep)
    rays = (kept != ref_kept).any(1).nonzero()[:, 0]
    worst = 0.0
    for i in rays.tolist():   # pairs of the swapped candidates only: at most K x K a ray
        a = (kept[i] & ~ref_kept[i]).nonzero()[:, 0]
        b = (ref_kept[i] & ~kept[i]).nonzero()[:, 0]
        gap = (ref_scores[i, a][:, None] - ref_scores[i, b][None, :]).abs()
        ratio = torch.where(gap > 0, gap / (bar[i, a][:, None] + bar[i, b][None, :]),
                            torch.zeros_like(gap))
        worst = max(worst, float(ratio.max()))
    return int(rays.numel()), worst


def _check_keep(n_candidates: int, n_keep: int) -> None:
    if not 1 <= n_keep <= n_candidates:
        raise ValueError(f"proxy_select needs 1 <= n_keep <= n_candidates, got n_keep {n_keep} "
                         f"of {n_candidates} candidates")


def _launch(packed: Packed, rays: torch.Tensor, n_candidates: int, n_keep: int,
            scores: torch.Tensor | None) -> torch.Tensor:
    check_range("proxy_select", "candidates", n_candidates, 1, MAX_C)
    args = k3_args(packed, rays)
    z = torch.empty((rays.shape[0], n_keep), dtype=torch.float32, device=rays.device)
    scratch = scratch_for(args[-1], n_candidates, rays.shape[0], rays.device)
    tail = (z.data_ptr(), *scratch_args(scratch), current_stream(rays.device))
    if scores is None:
        err = _lib().proxy_select_forward(*args, rays.data_ptr(), rays.shape[0], n_candidates,
                                          n_keep, *tail)
    else:
        err = _lib().proxy_select_scores_forward(*args, rays.data_ptr(), rays.shape[0],
                                                 n_candidates, n_keep, scores.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"proxy_select_forward failed: cudaError {err}")
    return z


def proxy_select(packed: Packed, rays: torch.Tensor, n_candidates: int = 64,
                 n_keep: int = 16) -> torch.Tensor:
    """rays (R, 8) f32 -> the depths (R, n_keep) of the n_keep candidates
    with the highest proxy score, in score order."""
    _check_keep(n_candidates, n_keep)
    if rays.device.type == "cpu":
        return proxy_select_ref(packed, rays, n_candidates, n_keep)
    z = _launch(packed, rays, n_candidates, n_keep, None)
    count_launch(LAUNCHES, "select" if n_candidates <= MAX_CANDIDATES else "select_scratch")
    return z


def proxy_select_scores(packed: Packed, rays: torch.Tensor, n_candidates: int,
                        n_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the candidates' scores (R, C) as the kernel computes and selects
    from them, its depths (R, K)): the kernel built to store its scores too.
    A reading for the tests and the smoke, not on any path and not counted
    in LAUNCHES."""
    _check_keep(n_candidates, n_keep)
    if rays.device.type == "cpu":
        scores = candidate_scores_ref(packed, rays, n_candidates)
        return scores, proxy_select_ref(packed, rays, n_candidates, n_keep, scores)
    scores = torch.empty((rays.shape[0], n_candidates), dtype=torch.float32, device=rays.device)
    return scores, _launch(packed, rays, n_candidates, n_keep, scores)
