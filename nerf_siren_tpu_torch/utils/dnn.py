"""General DNN infra utilities (reference: dnnlib/util.py, torch_utils/misc.py).

Counterpart of `nerf_siren_tpu/utils/dnn.py`:
- EasyDict: attribute-access dict (reference dnnlib/util.py:42),
- construct_class_by_name: build an object from a dotted class path
  (reference dnnlib/util.py:303),
- param_count / param_summary: parameter counts per top-level entry of a
  dict of the port's modules (or tensors, or JAX-layout trees of arrays)
  (reference torch_utils/misc.py:198-268 print_module_summary),
- infinite_batches: infinite shuffled batch stream with per-process
  sharding, JAX's shards and seeds (reference torch_utils/misc.py:113-147
  InfiniteSampler),
- Logger: tee stdout/stderr to a file, open_url: paths, file:// URLs and a
  download cache.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class EasyDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def get_obj_by_name(name: str) -> Any:
    """Resolve 'pkg.module.Attr' to the attribute."""
    module_name, _, attr = name.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def construct_class_by_name(class_name: str, *args, **kwargs) -> Any:
    return get_obj_by_name(class_name)(*args, **kwargs)


def param_count(tree: Any) -> int:
    """Elements of a module's parameters, or of every array leaf of a
    (nested dict / list) tree."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return int(np.prod(tree.shape)) if hasattr(tree, "shape") else 0


def param_summary(params: Dict[str, Any], title: str = "params") -> str:
    """Formatted per-entry parameter table; returns the string."""
    rows = [(k, param_count(v)) for k, v in params.items()] \
        if isinstance(params, dict) else [("all", param_count(params))]
    total = sum(n for _, n in rows)
    width = max([len(k) for k, _ in rows] + [len(title)])
    lines = [f"{title:<{width}}  #params"]
    for k, n in sorted(rows, key=lambda r: -r[1]):
        lines.append(f"{k:<{width}}  {n:>12,}")
    lines.append(f"{'total':<{width}}  {total:>12,}")
    return "\n".join(lines)


def infinite_batches(
    arrays: Dict[str, np.ndarray],
    batch_size: int,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batches over row-aligned arrays; with
    shard_index/num_shards each process sees a disjoint interleaved subset
    (JAX's: numpy `default_rng(seed + shard_index)`, a fresh permutation of
    the shard when a batch would run past its end)."""
    n = len(next(iter(arrays.values())))
    local = np.arange(shard_index, n, num_shards)
    rng = np.random.default_rng(seed + shard_index)
    order = rng.permutation(local)
    pos = 0
    while True:
        if pos + batch_size > len(order):
            order = rng.permutation(local)
            pos = 0
        idx = order[pos: pos + batch_size]
        pos += batch_size
        yield {k: v[idx] for k, v in arrays.items()}


class Logger:
    """Tee stdout/stderr to a log file (reference dnnlib/util.py:58-130).

    Write-through: every write goes to the original stream AND the file;
    flush-on-write when `should_flush`. Use as a context manager or call
    close() to restore the original streams.
    """

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        import sys

        self.file = open(file_name, file_mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, text) -> None:
        if len(text) == 0:  # workaround for a bug in VSCode debugger noted
            return          # by the reference (util.py:87)
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        import sys

        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None


def open_url(url: str, cache_dir: Optional[str] = None, *, cache: bool = True,
             return_filename: bool = False):
    """Open a URL or path, with a simple on-disk download cache
    (reference dnnlib/util.py:398-492, minus the Google-Drive special cases).

    file:// URLs and plain paths are opened directly. http(s) downloads are
    cached under `cache_dir` (default ~/.cache/nerf_siren_tpu, the JAX
    package's) keyed by the URL's md5; environments without egress serve
    cache hits and raise a clear error on misses.
    """
    import glob
    import hashlib
    import io
    import os
    import re
    import urllib.request

    if url.startswith("file://"):
        url = url[len("file://"):]
    if "://" not in url:  # plain path
        return url if return_filename else open(url, "rb")
    assert url.startswith(("http://", "https://")), f"unsupported url: {url}"

    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "nerf_siren_tpu")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        hits = glob.glob(os.path.join(cache_dir, url_md5 + "_*"))
        if hits:
            return hits[0] if return_filename else open(hits[0], "rb")

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            data = resp.read()
    except Exception as e:  # zero-egress sandboxes land here on cache miss
        raise IOError(f"cannot download {url} and no cache entry exists "
                      f"in {cache_dir}: {e}") from e

    safe_name = re.sub(r"[^0-9a-zA-Z-._]", "_", url.split("/")[-1]) or "download"
    if cache:
        path = os.path.join(cache_dir, f"{url_md5}_{safe_name}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        if return_filename:
            return path
    if return_filename:
        raise ValueError("return_filename=True requires cache=True for http urls")
    return io.BytesIO(data)
