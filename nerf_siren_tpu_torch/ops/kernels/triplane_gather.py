"""Triplane gather (K5): plain PyTorch version and the CUDA kernel's wrapper.

Counterpart of `nerf_siren_tpu/ops/pallas/triplane_gather.py` (the TPU
kernel `_gather_kernel`, driven by `render/triplane.py::
make_kernel_plane_sampler`). The kernel is `csrc/triplane_gather.cu`. Its
contract is the math of the JAX sampler, `grid_sample_2d_packed` on all
three planes, not its TPU layout: the row-major tile table, the origins
quantised to 8 rows / 128 lanes, the one-hot y-matmul, the ray x depth
groups and the `valid` output with its miss list are not kept. A GPU
gathers any point directly, so the kernel samples every point.

Per point xyz and plane p (q = scale * xyz, scale = 2 / box_warp): plane
0 reads (q_x, q_y), plane 1 (q_x, q_z), plane 2 (q_z, q_x) (the inverses
of `render/triplane.py::generate_planes`), then `grid_sample_2d_packed`.

- `triplane_gather_ref`: the plain version, rounding as the kernel does.
- `triplane_gather`: the public wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. There is no
  backward (as in JAX): inputs that need a gradient are refused.
  `LAUNCHES` counts kernel launches (through `utils/tracing.py::count_launch`).
- `launch_plan`: the kernel's route and grid for a call (the corner load
  width, threads per point, blocks), a plain function so that the CPU
  tests can check that its threads cover every output once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nerf_siren_tpu_torch.ops.grid_sample import grid_sample_2d_packed
from nerf_siren_tpu_torch.ops.kernels.proxy_march import current_stream
from nerf_siren_tpu_torch.utils.tracing import count_launch

PLANE_AXES = ((0, 1), (0, 2), (2, 0))   # the (u, v) world axes of planes 0, 1, 2

LAUNCHES = {"gather": 0}

THREADS = 256                   # the kernel's block size
LOAD_BYTES = (16, 8, 4, 2)      # the corner load widths the kernel is built for, widest first


class LaunchPlan(NamedTuple):
    """Thread t of the grid takes point t // groups and channels
    [(t % groups) vec, (t % groups + 1) vec) of it on all three planes."""
    vec: int        # channels per corner load (a template argument of the kernel)
    load_bytes: int
    groups: int     # threads per point, C / vec
    threads: int    # per block
    blocks: int


def launch_plan(c: int, dtype: torch.dtype, m: int, table_ptr: int = 0) -> LaunchPlan:
    """The kernel's route for a (3, H+2, W+2, c) table of `dtype` at
    address `table_ptr` and m points: the widest corner load whose channel
    count divides c and to whose width the table is aligned (every row
    and corner then is), one thread per (point, channel group), point-major,
    and just enough blocks of THREADS."""
    elem = 2 if dtype == torch.bfloat16 else 4
    load_bytes = next(b for b in LOAD_BYTES
                      if b >= elem and c % (b // elem) == 0 and table_ptr % b == 0)
    vec = load_bytes // elem
    groups = c // vec
    blocks = -(-m * groups // THREADS)
    if blocks > 2**31 - 1:
        raise ValueError(f"triplane_gather: {m} points x {groups} channel groups exceed one grid")
    return LaunchPlan(vec, load_bytes, groups, THREADS, blocks)


def project_to_planes(q: torch.Tensor) -> torch.Tensor:
    """(..., 3) scaled points -> (3, ..., 2) plane-local (u, v). Built from
    slices, with no index tensor: a list index would copy it from the host,
    which a captured CUDA graph (the EG3D training step) refuses."""
    return torch.stack([torch.stack([q[..., a] for a in axes], dim=-1) for axes in PLANE_AXES])


def triplane_gather_ref(table: torch.Tensor, xyz: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of `triplane_gather`: (3, M, C) float32."""
    return grid_sample_2d_packed(table, project_to_planes(scale * xyz))


# triplane_gather_forward(table, is_bf16, H, W, C, vec, xyz, M, scale, out, blocks, stream)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _LL, ctypes.c_float, _P, _LL, _P]


@functools.cache
def _fn():
    """The launcher, built, loaded and bound once per process."""
    from nerf_siren_tpu_torch.ops.kernels import _build

    fn = _build.load("triplane_gather").triplane_gather_forward
    fn.argtypes = KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(table: torch.Tensor, xyz: torch.Tensor) -> None:
    if table.device != xyz.device:
        raise ValueError(f"triplane_gather: table on {table.device}, xyz on {xyz.device}")
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"triplane_gather: table must be bfloat16 or float32, got {table.dtype}")
    if table.ndim != 4 or table.shape[0] != len(PLANE_AXES) or min(table.shape[1:3]) < 3:
        raise ValueError(f"triplane_gather: table must be (3, H+2, W+2, C), got "
                         f"{tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("triplane_gather: table must be contiguous")
    if xyz.dtype != torch.float32 or xyz.ndim != 2 or xyz.shape[1] != 3 or not xyz.is_contiguous():
        raise ValueError(f"triplane_gather: xyz must be a contiguous (M, 3) float32 tensor, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")


def triplane_gather(table: torch.Tensor, xyz: torch.Tensor, scale: float) -> torch.Tensor:
    """Sample the three planes of a `pack_planes_for_sampling` table (3,
    H+2, W+2, C) at points xyz (M, 3) scaled by `scale` -> (3, M, C) f32."""
    if torch.is_grad_enabled() and (table.requires_grad or xyz.requires_grad):
        raise ValueError("triplane_gather has no backward: call it under torch.no_grad() "
                         "(training samples the planes through the plain path)")
    if xyz.device.type == "cpu":
        return triplane_gather_ref(table, xyz, scale)
    if xyz.device.type != "cuda":
        raise ValueError(f"triplane_gather: unsupported device {xyz.device}")
    _check_inputs(table, xyz)
    n_planes, hp, wp, c = table.shape
    m = xyz.shape[0]
    out = torch.empty((n_planes, m, c), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out
    plan = launch_plan(c, table.dtype, m, table.data_ptr())
    err = _fn()(table.data_ptr(), int(table.dtype == torch.bfloat16), hp - 2, wp - 2, c,
                plan.vec, xyz.data_ptr(), m, scale, out.data_ptr(), plan.blocks,
                current_stream(xyz.device))
    if err != 0:
        raise RuntimeError(f"triplane_gather_forward failed: cudaError {err}")
    count_launch(LAUNCHES, "gather")
    return out
