"""The comparisons that decide `correct`: gaps between the program's
readings and the plain reference's, each a number held against a limit."""
from __future__ import annotations

from typing import Dict, Iterable

import torch


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def median(values: Iterable[float]) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger (some
    leaves are all but zero)."""
    gn, wn = leaf_norms({k: got[k] for k in want}), leaf_norms(want)
    floor = median(wn.values())
    return {k: abs(gn[k] - wn[k]) / max(wn[k], floor) for k in want}


def moving_leaves(grad: Dict[str, torch.Tensor], share: float = 1e-3):
    """Leaves whose reference gradient is more than `share` of the median
    leaf's (the others move under Adam by round-off alone)."""
    norms = leaf_norms(grad)
    floor = share * median(norms.values())
    return [k for k, v in norms.items() if v > floor]

