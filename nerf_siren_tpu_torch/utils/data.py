"""Host-side data helpers (counterpart of `parallel_map` in
`nerf_siren_tpu/utils/data.py`)."""
from __future__ import annotations


def parallel_map(fn, items, max_workers: int = 8):
    """Ordered thread-pool map for IO-bound dataset preprocessing.

    PIL decode/resize and numpy ray precompute release the GIL, so a
    100-image scene loads in parallel threads. Small inputs take a plain
    map."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(max_workers, len(items))) as pool:
        return list(pool.map(fn, items))
