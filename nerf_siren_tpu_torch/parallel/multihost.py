"""Process groups: one process per device, explicit collectives.

Counterpart of `nerf_siren_tpu/parallel/multihost.py`. JAX drives every
chip of a host from one process and joins hosts with
`jax.distributed.initialize`; PyTorch's idiom is one process per device
(the reference's Lightning DDP, reference train.py:47-63), joined into a
`torch.distributed` process group: NCCL between cards, gloo between CPU
processes. `initialize_distributed` reads its three values from the
arguments, then from JAX's environment names (`NERF_TPU_COORDINATOR`,
`NERF_TPU_NUM_PROCESSES`, `NERF_TPU_PROCESS_ID`), then from torchrun's
(`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`; `LOCAL_RANK` picks
the card). Without a group the queries answer for one process.

`local_group` joins N ranks of one host (`train.py --num_chips N`) through
a file store made by `rank_store`, and leaves the group when its block
ends.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
from typing import Iterator, Optional

import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def init_method(coordinator_address: str) -> str:
    """A `torch.distributed` init method from a coordinator address: a URL
    (`tcp://...`, `file://...`, `env://`) as it is, `host:port` as TCP."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def backend_for(device_type: str) -> str:
    """NCCL for cards, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: Optional[str] = None) -> None:
    """Join this process to the group of `num_processes` (a no-op when it
    has joined one already). Each value comes from the argument, else from
    JAX's environment names, else from torchrun's; `device_type` (default:
    `cuda`, which raises when no card is visible) picks the backend, and on a card the
    process takes `local_device()`."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("NERF_TPU_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = "env://"   # torchrun's store (its agent's, under torchrun)
    if num_processes is None:
        num_processes = _env_int("NERF_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("NERF_TPU_PROCESS_ID", "RANK")
    if num_processes is None or process_id is None or coordinator_address is None:
        raise ValueError(
            "initialize_distributed needs a coordinator address, the process count and this "
            "process's id: pass them, or set NERF_TPU_COORDINATOR, NERF_TPU_NUM_PROCESSES "
            "and NERF_TPU_PROCESS_ID (or torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
            "and RANK)")
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: no CUDA device is visible; pass "
                           "device_type='cpu' (the CLIs' --device cpu) to join over gloo "
                           "on the CPU")
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend_for(device_type), init_method=init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints (rank 0)."""
    return process_index() == 0


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: `cuda:LOCAL_RANK` (0 without torchrun's
    variable), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def rank_threads(world: int) -> int:
    """The intra-op threads of each of `world` CPU ranks that share this
    process's threads."""
    return max(1, torch.get_num_threads() // world)


@contextlib.contextmanager
def rank_store() -> Iterator[str]:
    """The path of a file store in a fresh temporary directory, removed
    when the block ends."""
    store_dir = tempfile.mkdtemp(prefix="nerf_torch_ranks_")
    try:
        yield os.path.join(store_dir, "store")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


@contextlib.contextmanager
def local_group(device: torch.device, store: str, world: int, rank: int, threads: int = 1,
                timeout: Optional[datetime.timedelta] = None):
    """Join the group of `world` local ranks through the file store `store`
    as `rank` on `device` (on the CPU with `threads` intra-op threads) and
    yield its `DataParallel`; leave the group when the block ends, also on
    an error. A CUDA graph that captured the group's all-reduce holds the
    communicator, and `destroy_process_group` waits until the graph is
    freed: the graphs of every system built on the shard go first
    (`DataParallel.release_graphs`)."""
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel

    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend_for(device.type), init_method=f"file://{store}",
                            world_size=world, rank=rank, **kw)
    dp = DataParallel()
    try:
        yield dp
    finally:
        dp.release_graphs()
        dist.destroy_process_group()
