"""Density-proxy march (K3): pack, plain PyTorch version, and the CUDA kernel's wrappers.

Counterpart of `nerf_siren_tpu/ops/pallas/proxy_march.py` (the TPU kernels
`_opacity_kernel` / `_march_kernel`). The kernel is `csrc/proxy_march.cu`,
whose third epilogue is the proxy top-K (K6, `proxy_select.py`); this
module owns everything around the march and the library's binding:

- `pack_proxy_params`: the proxy's weights as the proxy kernels read them
  (K3 here and K6 in `proxy_select.py`): ``w1`` (H, 33) bf16 in torch layout
  with the embedding columns in reference order, ``b1`` (H,) float32,
  ``w2`` (H,) bf16, ``b2`` (1,) float32; H <= 128; and ``k3_w1t``:
  W1^T as the kernels' wgmma reads it (`pack_k3_w1t`, plain inverse
  `unpack_k3_w1t`): (NT, 64) bf16, NT = H rounded up to a width the kernel
  has (`k3_width`), its 48 embedding columns in the order in which the
  kernel's threads build the embedding in registers (`k3_columns`), in the
  128-byte swizzle.
- `proxy_scores_ref`: the plain version of the proxy's score with the
  kernels' rounding points (bf16 operands, float32 sums in input order, the
  bias added last). It equals `render.fast.apply_proxy` at bf16 up to that
  order. `proxy_score_bar`: how far a score summed in another order may
  lie from it.
- `proxy_opacity_ref` / `proxy_march_select_ref`: the plain version of the
  march. Candidates z_j = near + j * spacing (`candidate_points`); expected
  weights alpha * T under sigma = expm1(relu(score)); the opacity 1 - T;
  and the deterministic inverse CDF of the interior weights w[1:-1] with
  the reference `sample_pdf`'s edges, the CDF formed as S_i / S_total of
  the running sums S_i of w + 1e-5 (so its last entry is exactly 1). Both
  take the candidates' scores as given (`scores`) or score them with
  `proxy_scores_ref`. Every step of the march rounds as the kernel's does;
  the kernel sums the proxy in another order (the tensor cores'), so its
  scores lie within `proxy_score_bar` of the plain ones, and given its own
  scores (`proxy_march_scores`) the plain march equals its outputs bit for
  bit on the card. The tests and the smoke hold the outputs to the plain
  ones' bars on depths and opacity.
- `proxy_opacity` / `proxy_march_select`: the public wrappers. A CPU tensor
  goes to the plain version; a CUDA tensor launches the kernel or raises.
  They take any C >= 4: up to `MAX_CANDIDATES` a block's rows of scores
  stay in shared memory, above it each CTA's row lives in a device scratch
  of blocks x C floats (`scratch_for`). `LAUNCHES` counts kernel launches
  per wrapper (above MAX_CANDIDATES under '*_scratch'). `proxy_march_scores`
  reads the kernel's scores back (a reading for the tests and the smoke,
  not counted).

The TPU kernel's lane-major (8, N) rays, TILE_R padding, rotation
recurrence for sin and candidate-major survivor layout are not kept: rays
are (R, 8) for any R, and the survivors come back ray-major (R, K, 3), so
the field kernel takes one direction per ray.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.ops.kernels._build import count_launch
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import _bf16, _check, _swizzle128

PROXY_FREQS = 5
PROXY_IN = 3 * (2 * PROXY_FREQS + 1)   # 33
MAX_HIDDEN = 128
SMEM_MAX = 232448      # shared memory one block may use on an H100 (227 KB)
K3_MIN_CANDIDATES = 4  # the march needs two interior candidates (JAX asserts C >= 4)
K3_WIDTHS = (16, 32, 64, 96, 128)   # hidden widths of the kernel's wgmma wrappers
K3_COLUMNS = 48        # embedding columns of the kernel's A: 33, padded to three k16 steps
K3_ROW = 64            # bf16 per row of `k3_w1t`: one 128-byte swizzle row
# points per step of the plain score: bounds its temporaries, and on the CPU
# keeps a step's (N, H) running sums in cache (3x faster than 2^20 there)
_SCORE_CHUNK = {"cpu": 1 << 16, "cuda": 1 << 20}

# 'opacity' / 'select': the kernels whose rows of scores stay in shared memory;
# '*_scratch': the kernel above MAX_CANDIDATES, its rows in a device scratch
LAUNCHES = {"opacity": 0, "select": 0, "opacity_scratch": 0, "select_scratch": 0}


def rays_per_block(n_candidates: int) -> int:
    """Rays of one block of the kernels at C candidates (csrc/proxy_march.cu):
    64 up to C 64, 32 up to 128, 16 up to 256, then about 4096 scores a
    block, down to one ray from C 4096."""
    c = n_candidates
    return 64 if c <= 64 else 32 if c <= 128 else 16 if c <= 256 else max(1, 4096 // c)


def shared_bytes_at(width: int, n_candidates: int) -> int:
    """One CTA's dynamic shared memory at wgmma width `width` (`k3_width`)
    and C candidates, as csrc/proxy_march.cu lays it out: the W1^T tile,
    w2's B, b1, b2, then per ray of the block 8 + 4 floats and a row of C
    scores at an odd stride; 1024 bytes of alignment slack."""
    b = rays_per_block(n_candidates)
    return (1024 + width * 2 * K3_ROW + (width + 63) // 64 * 1024 + 4 * width + 16
            + b * 48 + 4 * b * (n_candidates | 1))


# The most candidates a ray whose row of scores stays in shared memory: the
# largest C whose one-ray block (from C 4096 on) fits SMEM_MAX at the widest
# hidden width, 53,103: the floats left beside the block's other bytes, at
# the odd row stride C | 1. Above it the kernels keep each CTA's row in a
# scratch of device memory (`scratch_for`), so they take any C up to MAX_C.
MAX_CANDIDATES = ((SMEM_MAX - shared_bytes_at(MAX_HIDDEN, 4096) + 4 * 4097) // 4 - 1) | 1
MAX_C = 1 << 30   # row offsets stay within 32 bits

Packed = Dict[str, torch.Tensor]


def pack_proxy_params(proxy, device=None) -> Packed:
    """A `render.fast.Proxy` -> the proxy kernels' weight dict."""
    device = proxy.l1.weight.device if device is None else torch.device(device)
    hidden = proxy.l1.weight.shape[0]
    if proxy.l1.weight.shape[1] != PROXY_IN or not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"proxy kernels take a (H<={MAX_HIDDEN}, {PROXY_IN}) first layer, "
                         f"got {tuple(proxy.l1.weight.shape)}")

    def f32(t):
        return t.detach().to(device, torch.float32).contiguous()

    w1 = f32(proxy.l1.weight).to(torch.bfloat16)
    return {"w1": w1, "b1": f32(proxy.l1.bias),
            "w2": f32(proxy.l2.weight)[0].to(torch.bfloat16).contiguous(),
            "b2": f32(proxy.l2.bias), "k3_w1t": pack_k3_w1t(w1)}


# ---- K3's W1^T tile ---------------------------------------------------------

def k3_width(hidden: int) -> int:
    """The kernel's wgmma width for H hidden units: H rounded up to K3_WIDTHS."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"proxy kernels take hidden 1..{MAX_HIDDEN}, got {hidden}")
    return next(w for w in K3_WIDTHS if w >= hidden)


def k3_slot(t: int, i: int, e: int) -> int:
    """The reference embedding column that thread t of a quad places as
    element e (0 low, 1 high) of its pair i of a row, or -1 for a zero.
    Pair i < 4 is (sin, cos) of angle q = 4 t + i = 3 k + r (coordinate r
    times 2^k) while q < 15; thread 3's pairs 3 and 4 are (x, y), (z, 0)."""
    if i < 4:
        q = 4 * t + i
        if q < 3 * PROXY_FREQS:
            k, r = divmod(q, 3)
            return 3 + 6 * k + r + 3 * e
        return e
    return 2 if (t, i, e) == (3, 4, 0) else -1


def k3_column(t: int, i: int, e: int) -> int:
    """The A column of element e of thread t's pair i: wgmma's register
    fragment puts pair i in k-step i // 2, 8 columns on for odd i."""
    return 16 * (i // 2) + 8 * (i % 2) + 2 * t + e


def k3_columns() -> Tuple[int, ...]:
    """For each of the kernel's K3_COLUMNS A columns, the reference
    embedding column it holds, or -1."""
    cols = [-1] * K3_COLUMNS
    for t in range(4):
        for i in range(6):
            for e in range(2):
                cols[k3_column(t, i, e)] = k3_slot(t, i, e)
    return tuple(cols)


def pack_k3_w1t(w1: torch.Tensor) -> torch.Tensor:
    """w1 (H, 33) bf16 -> K3's W1^T tile (k3_width(H), K3_ROW) bf16: row n
    holds hidden unit n's weights in `k3_columns` order (zeros in the
    padding columns and rows), in the 128-byte swizzle."""
    hidden = w1.shape[0]
    cols = torch.tensor(k3_columns(), device=w1.device)
    used = (cols >= 0).nonzero()[:, 0]
    dense = torch.zeros((k3_width(hidden), K3_ROW), dtype=w1.dtype, device=w1.device)
    dense[:hidden, used] = w1[:, cols[used]]
    return _swizzle128(dense).contiguous()


def unpack_k3_w1t(tile: torch.Tensor, hidden: int) -> torch.Tensor:
    """The plain inverse of `pack_k3_w1t`: w1 (hidden, 33)."""
    if tuple(tile.shape) != (k3_width(hidden), K3_ROW):
        raise ValueError(f"k3_w1t: expected {(k3_width(hidden), K3_ROW)}, "
                         f"got {tuple(tile.shape)}")
    cols = torch.tensor(k3_columns(), device=tile.device)
    used = (cols >= 0).nonzero()[:, 0]
    w1 = torch.empty((hidden, PROXY_IN), dtype=tile.dtype, device=tile.device)
    w1[:, cols[used]] = _swizzle128(tile)[:hidden, used]
    return w1


# ---- plain PyTorch version --------------------------------------------------

def _pre_ref(packed: Packed, flat: torch.Tensor):
    """(bf16 embedding, pre-activations W1 emb + b1) of points (N, 3),
    summed as the kernels sum."""
    w1, b1 = packed["w1"].float(), packed["b1"]
    emb = _bf16(positional_encoding(flat, PROXY_FREQS))
    acc = torch.zeros((emb.shape[0], w1.shape[0]), dtype=torch.float32, device=flat.device)
    for j in range(PROXY_IN):
        acc = acc + emb[:, j: j + 1] * w1[:, j]
    return emb, acc + b1


def proxy_scores_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Proxy score (...,) of points (..., 3), summed as the kernels sum."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    w2, b2 = packed["w2"].float(), packed["b2"]
    out = []
    step = _SCORE_CHUNK[flat.device.type]
    for i in range(0, flat.shape[0], step):
        h = _bf16(torch.relu(_pre_ref(packed, flat[i: i + step])[1]))
        score = torch.zeros(h.shape[0], dtype=torch.float32, device=xyz.device)
        for k in range(w2.shape[0]):
            score = score + h[:, k] * w2[k]
        out.append(score + b2)
    return torch.cat(out).reshape(shape)


def proxy_score_bar(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """(...,) how far a score of points (..., 3) summed in another order
    than `proxy_scores_ref`'s may lie from it, given the same bf16
    embedding and the same rounding points.

    A pre-activation a_k = W1_k emb + b1_k moves by at most
    D_k = d_k + 2^-21 (|a_k| + d_k), d_k = 2^-17 sum_j |emb_j W1_kj|: the
    plain 33-term float32 sum of exact products rounds 32 times (at most
    2^-19 of its terms' magnitude), the tensor cores' sum is allowed three
    times that (their adds align to the largest term and may truncate), and
    2^-21 |a_k| covers the b1 add's rounding in both and that of a_k +- D_k.
    bf16(relu(.)) is monotone, so h_k moves by at most
    m_k = max(bf16(relu(a_k + D_k)) - h_k, h_k - bf16(relu(a_k - D_k))):
    0 unless a rounding point of h_k lies within D_k of a_k, else about one
    bf16 step. The second sum's exact products h_k w2_k, summed in either
    order (H <= 128 terms), move by at most 2^-17 of their magnitude each,
    and b2's add by 2^-23 |score| each. So |d score| <= (1 + 2^-16)
    sum_k |w2_k| m_k + 2^-16 sum_k |h_k w2_k| + 2^-22 |score|. A bar that
    let every unit move by a bf16 step would also pass b1 rounded to bf16;
    this one does not."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    w1a, w2 = packed["w1"].float().abs(), packed["w2"].float()
    out = []
    step = _SCORE_CHUNK[flat.device.type]
    for i in range(0, flat.shape[0], step):
        emb, pre = _pre_ref(packed, flat[i: i + step])
        h = _bf16(torch.relu(pre))
        d = 2.0 ** -17 * (emb.abs() @ w1a.t())
        dd = d + 2.0 ** -21 * (pre.abs() + d)
        move = torch.maximum(_bf16(torch.relu(pre + dd)) - h, h - _bf16(torch.relu(pre - dd)))
        hw = h * w2
        out.append((1.0 + 2.0 ** -16) * (move * w2.abs()).sum(1) + 2.0 ** -16 * hw.abs().sum(1)
                   + 2.0 ** -22 * (hw.sum(1) + packed["b2"]).abs())
    return torch.cat(out).reshape(shape)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded as a true division (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds otherwise)."""
    return a / torch.tensor(float(b), device=a.device)


def _spacing(rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    return _div(rays[:, 7:8] - rays[:, 6:7], n_candidates - 1)


def candidate_points(rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """(R, C, 3): the points o + d z_j, z_j = near + j * spacing, that the
    march scores."""
    z = rays[:, 6:7] + torch.arange(n_candidates, dtype=torch.float32,
                                    device=rays.device) * _spacing(rays, n_candidates)
    return rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]


def proxy_march_scores_ref(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """Plain version of `proxy_march_scores`: (R, C) the candidates' scores."""
    return proxy_scores_ref(packed, candidate_points(rays, n_candidates))


def _march_ref(packed: Packed, rays: torch.Tensor, n_candidates: int,
               scores: Optional[torch.Tensor] = None):
    """(final transmittance (R, 1), running sums S (R, C-2) of the interior
    weights + 1e-5, spacing (R, 1)) under the candidates' scores (R, C),
    given or from `proxy_march_scores_ref`."""
    c = n_candidates
    d = rays[:, 3:6]
    near = rays[:, 6:7]
    spacing = _spacing(rays, c)
    dn = torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2] + d[:, 2:3] * d[:, 2:3])
    dz = spacing * dn
    score = proxy_march_scores_ref(packed, rays, c) if scores is None else scores
    alpha = 1.0 - torch.exp(-(torch.expm1(torch.relu(score)) * dz))
    trans, run = torch.ones_like(near), torch.zeros_like(near)
    cum = []
    for j in range(c):          # sequential, as the kernel (a scan would reorder)
        a = alpha[:, j: j + 1]
        if 1 <= j <= c - 2:
            run = run + (a * trans + 1e-5)
            cum.append(run)
        trans = trans * ((1.0 - a) + 1e-10)
    return trans, torch.cat(cum, dim=1), spacing


def proxy_opacity_ref(packed: Packed, rays: torch.Tensor, n_candidates: int,
                      scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `proxy_opacity`: (R,) 1 - final transmittance."""
    return 1.0 - _march_ref(packed, rays, n_candidates, scores)[0][:, 0]


def _u(n_keep: int, midpoint: bool, device) -> torch.Tensor:
    k = torch.arange(n_keep, dtype=torch.float32, device=device)
    return _div(k + 0.5, n_keep) if midpoint else _div(k, n_keep - 1)


def proxy_march_select_ref(packed: Packed, rays: torch.Tensor, n_candidates: int,
                           n_keep: int, midpoint: bool = False, return_density: bool = False,
                           scores: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Plain version of `proxy_march_select`."""
    r, c = rays.shape[0], n_candidates
    _, cum, spacing = _march_ref(packed, rays, c, scores)          # cum (R, C-2)
    near = rays[:, 6:7]
    mass = cum[:, -1:]
    cdf = torch.cat([torch.zeros_like(mass), cum / mass], dim=1)   # (R, C-1)
    u = _u(n_keep, midpoint, rays.device).expand(r, n_keep).contiguous()
    cnt = torch.searchsorted(cdf, u, right=True)                   # #{cdf <= u} >= 1
    below, above = cnt - 1, torch.clamp_max(cnt, c - 2)
    cb, ca = cdf.gather(1, below), cdf.gather(1, above)
    bb = near + (below.float() + 0.5) * spacing
    ba = near + (above.float() + 0.5) * spacing
    dcdf = ca - cb
    denom = torch.where(dcdf < 1e-5, torch.ones_like(dcdf), dcdf)
    z = bb + (u - cb) / denom * (ba - bb)
    xyz = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
    if not return_density:
        return z, xyz
    return z, xyz, dcdf / torch.clamp_min(ba - bb, 1e-7), mass[:, 0]


# ---- CUDA kernel ------------------------------------------------------------

def _lib():
    from nerf_siren_tpu_torch.ops.kernels import _build

    lib = _build.load("proxy_march")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.proxy_opacity_forward.argtypes = [p, p, p, p, i, p, ll, i, p, p, ll, p]
    lib.proxy_march_select_forward.argtypes = [p, p, p, p, i, p, ll, i, i, i, p, p, p, p, p, ll,
                                               p]
    lib.proxy_march_scores_forward.argtypes = [p, p, p, p, i, p, ll, i, p, p, p, ll, p]
    lib.proxy_select_forward.argtypes = [p, p, p, p, i, p, ll, i, i, p, p, ll, p]
    lib.proxy_select_scores_forward.argtypes = [p, p, p, p, i, p, ll, i, i, p, p, p, ll, p]
    lib.proxy_march_shared_bytes.argtypes = [i, i]
    lib.proxy_march_max_candidates.argtypes = []
    lib.proxy_march_scratch_rows.argtypes = [i, i, ctypes.c_longlong]
    lib.proxy_march_scratch_rows.restype = ctypes.c_longlong
    for fn in (lib.proxy_opacity_forward, lib.proxy_march_select_forward,
               lib.proxy_march_scores_forward, lib.proxy_select_forward,
               lib.proxy_select_scores_forward, lib.proxy_march_shared_bytes,
               lib.proxy_march_max_candidates):
        fn.restype = i
    return lib


def shared_bytes(hidden: int, n_candidates: int) -> int:
    """Dynamic shared memory of one CTA of the kernels at these sizes, in
    bytes, from the built library (the smoke's build report)."""
    n = _lib().proxy_march_shared_bytes(hidden, n_candidates)
    if n < 0:
        raise ValueError(f"proxy kernels do not take hidden {hidden}, C {n_candidates}")
    return n


def kernel_max_candidates() -> int:
    """The built library's shared-memory row cap (`MAX_CANDIDATES` mirrors it)."""
    return _lib().proxy_march_max_candidates()


def scratch_for(hidden: int, n_candidates: int, n_rays: int, device) -> Optional[torch.Tensor]:
    """The kernels' scratch above MAX_CANDIDATES: (rows, C | 1) float32, one
    row per CTA of the grid the library will launch (at most one per ray),
    so blocks x C floats, not rays x C; None at or below it."""
    if n_candidates <= MAX_CANDIDATES or n_rays == 0:
        return None
    with torch.cuda.device(device):
        rows = _lib().proxy_march_scratch_rows(hidden, n_candidates, n_rays)
    if rows <= 0:
        raise RuntimeError(f"proxy_march_scratch_rows failed: cudaError {-rows}")
    return torch.empty((rows, n_candidates | 1), dtype=torch.float32, device=device)


def scratch_args(scratch: Optional[torch.Tensor]) -> tuple:
    """(pointer, rows) of a `scratch_for` tensor for the kernels' call."""
    return (None, 0) if scratch is None else (scratch.data_ptr(), scratch.shape[0])


def check_range(what: str, name: str, value: int, least: int, most: int) -> None:
    """Raise a ValueError that names `value` unless least <= value <= most."""
    if not least <= value <= most:
        raise ValueError(f"{what} takes {least}..{most} {name}, got {value}")


def weight_args(packed: Packed, rays: torch.Tensor) -> list:
    """Validate rays and pack for the proxy kernels; their pointers and H."""
    if rays.device.type != "cuda":
        raise ValueError(f"proxy kernels: unsupported device {rays.device}")
    _check(rays, "rays", rays.device, torch.float32, (rays.shape[0], 8))
    hidden = packed["w1"].shape[0]
    check_range("proxy kernels", "hidden", hidden, 1, MAX_HIDDEN)
    bf, f32 = torch.bfloat16, torch.float32
    for k, dtype, shape in (("w1", bf, (hidden, PROXY_IN)), ("b1", f32, (hidden,)),
                            ("w2", bf, (hidden,)), ("b2", f32, (1,))):
        _check(packed[k], k, rays.device, dtype, shape)
    return [packed[k].data_ptr() for k in ("w1", "b1", "w2", "b2")] + [hidden]


def k3_args(packed: Packed, rays: torch.Tensor) -> list:
    """`weight_args` with the W1^T tile in place of w1."""
    args = weight_args(packed, rays)
    if "k3_w1t" not in packed:
        raise ValueError("k3_w1t: missing from the pack (pack_proxy_params makes it)")
    _check(packed["k3_w1t"], "k3_w1t", rays.device, torch.bfloat16,
           (k3_width(args[-1]), K3_ROW))
    return [packed["k3_w1t"].data_ptr()] + args[1:]


def current_stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def proxy_opacity(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """Per-ray proxy opacity (R,) over C uniform candidates: the culling
    prepass. rays: (R, 8) f32 [o, d, near, far]."""
    if rays.device.type == "cpu":
        return proxy_opacity_ref(packed, rays, n_candidates)
    check_range("proxy_opacity", "candidates", n_candidates, K3_MIN_CANDIDATES, MAX_C)
    args = k3_args(packed, rays)
    out = torch.empty(rays.shape[0], dtype=torch.float32, device=rays.device)
    scratch = scratch_for(args[-1], n_candidates, rays.shape[0], rays.device)
    err = _lib().proxy_opacity_forward(*args, rays.data_ptr(), rays.shape[0], n_candidates,
                                       out.data_ptr(), *scratch_args(scratch),
                                       current_stream(rays.device))
    if err != 0:
        raise RuntimeError(f"proxy_opacity_forward failed: cudaError {err}")
    count_launch(LAUNCHES, "opacity" if n_candidates <= MAX_CANDIDATES else "opacity_scratch")
    return out


def proxy_march_select(packed: Packed, rays: torch.Tensor, n_candidates: int, n_keep: int,
                       midpoint: bool = False,
                       return_density: bool = False) -> Tuple[torch.Tensor, ...]:
    """March C uniform candidates per ray under the proxy and place K depths
    by its deterministic inverse CDF. Returns (z (R, K) ascending, survivors
    xyz (R, K, 3)), and with `return_density` also the landing bin's
    normalised density (R, K) and the CDF's unnormalised mass W (R,), the
    two inputs of the ratio quadrature."""
    if n_keep < 2:
        raise ValueError(f"proxy_march_select needs n_keep >= 2, got {n_keep}")
    if rays.device.type == "cpu":
        return proxy_march_select_ref(packed, rays, n_candidates, n_keep, midpoint,
                                      return_density)
    check_range("proxy_march_select", "candidates", n_candidates, K3_MIN_CANDIDATES, MAX_C)
    args = k3_args(packed, rays)
    r, dev = rays.shape[0], rays.device
    z = torch.empty((r, n_keep), dtype=torch.float32, device=dev)
    xyz = torch.empty((r, n_keep, 3), dtype=torch.float32, device=dev)
    rho = torch.empty((r, n_keep), dtype=torch.float32, device=dev) if return_density else None
    mass = torch.empty(r, dtype=torch.float32, device=dev) if return_density else None
    scratch = scratch_for(args[-1], n_candidates, r, dev)
    err = _lib().proxy_march_select_forward(
        *args, rays.data_ptr(), r, n_candidates, n_keep, int(midpoint), z.data_ptr(),
        xyz.data_ptr(), rho.data_ptr() if return_density else None,
        mass.data_ptr() if return_density else None, *scratch_args(scratch),
        current_stream(dev))
    if err != 0:
        raise RuntimeError(f"proxy_march_select_forward failed: cudaError {err}")
    count_launch(LAUNCHES, "select" if n_candidates <= MAX_CANDIDATES else "select_scratch")
    return (z, xyz, rho, mass) if return_density else (z, xyz)


def proxy_march_scores(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """The candidates' scores (R, C) as the kernel computes and marches them
    (its opacity epilogue, built to store them too): a reading for the
    tests and the smoke, not on the renderer's path and not counted in
    LAUNCHES."""
    if rays.device.type == "cpu":
        return proxy_march_scores_ref(packed, rays, n_candidates)
    check_range("proxy_march_scores", "candidates", n_candidates, K3_MIN_CANDIDATES, MAX_C)
    args = k3_args(packed, rays)
    r, dev = rays.shape[0], rays.device
    scores = torch.empty((r, n_candidates), dtype=torch.float32, device=dev)
    opacity = torch.empty(r, dtype=torch.float32, device=dev)
    scratch = scratch_for(args[-1], n_candidates, r, dev)
    err = _lib().proxy_march_scores_forward(*args, rays.data_ptr(), r, n_candidates,
                                            scores.data_ptr(), opacity.data_ptr(),
                                            *scratch_args(scratch), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"proxy_march_scores_forward failed: cudaError {err}")
    return scores
