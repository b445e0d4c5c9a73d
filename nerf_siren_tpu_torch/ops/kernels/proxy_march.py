"""Density-proxy march (K3): pack, plain PyTorch version, and the CUDA kernel's wrappers.

Counterpart of `nerf_siren_tpu/ops/pallas/proxy_march.py` (the TPU kernels
`_opacity_kernel` / `_march_kernel`). The kernel is `csrc/proxy_march.cu`;
this module owns everything around it:

- `pack_proxy_params`: the proxy's weights as the proxy kernels read them
  (K3 here and K6 in `proxy_select.py`): ``w1`` (H, 33) bf16 in torch layout
  with the embedding columns in reference order, ``b1`` (H,) float32,
  ``w2`` (H,) bf16, ``b2`` (1,) float32; H <= 128.
- `proxy_scores_ref`: the plain version of the proxy's score with the
  kernels' rounding points and summation order (bf16 operands, float32
  sums in input order, the bias added last). It equals
  `render.fast.apply_proxy` at bf16 up to that order.
- `proxy_opacity_ref` / `proxy_march_select_ref`: the plain version of the
  march. Candidates z_j = near + j * spacing; expected weights alpha * T
  under sigma = expm1(relu(score)); the opacity 1 - T; and the
  deterministic inverse CDF of the interior weights w[1:-1] with the
  reference `sample_pdf`'s edges, the CDF formed as S_i / S_total of the
  running sums S_i of w + 1e-5 (so its last entry is exactly 1). Every
  step rounds as the kernel's does, so on the card the two agree bit for
  bit (the tests and the smoke hold them to looser bars all the same).
- `proxy_opacity` / `proxy_march_select`: the public wrappers. A CPU tensor
  goes to the plain version; a CUDA tensor launches the kernel or raises.
  `LAUNCHES` counts kernel launches per wrapper.

The TPU kernel's lane-major (8, N) rays, TILE_R padding and candidate-major
survivor layout are not kept: rays are (R, 8) for any R, and the survivors
come back ray-major (R, K, 3), so the field kernel takes one direction per
ray.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import _bf16, _check

PROXY_FREQS = 5
PROXY_IN = 3 * (2 * PROXY_FREQS + 1)   # 33
MAX_HIDDEN = 128
MAX_CANDIDATES = 256   # the CDF's running sums take (C - 2) x 128 floats of shared memory
_SCORE_CHUNK = 1 << 20  # points per step of the plain score (bounds its temporaries)

LAUNCHES = {"opacity": 0, "select": 0}

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

    return {"w1": f32(proxy.l1.weight).to(torch.bfloat16), "b1": f32(proxy.l1.bias),
            "w2": f32(proxy.l2.weight)[0].to(torch.bfloat16).contiguous(),
            "b2": f32(proxy.l2.bias)}


# ---- plain PyTorch version --------------------------------------------------

def proxy_scores_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Proxy score (...,) of points (..., 3), summed as the kernels sum."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    w1, b1 = packed["w1"].float(), packed["b1"]
    w2, b2 = packed["w2"].float(), packed["b2"]
    out = []
    for i in range(0, flat.shape[0], _SCORE_CHUNK):
        emb = _bf16(positional_encoding(flat[i: i + _SCORE_CHUNK], PROXY_FREQS))
        acc = torch.zeros((emb.shape[0], w1.shape[0]), dtype=torch.float32, device=xyz.device)
        for j in range(PROXY_IN):
            acc = acc + emb[:, j: j + 1] * w1[:, j]
        h = _bf16(torch.relu(acc + b1))
        score = torch.zeros(emb.shape[0], dtype=torch.float32, device=xyz.device)
        for k in range(w2.shape[0]):
            score = score + h[:, k] * w2[k]
        out.append(score + b2)
    return torch.cat(out).reshape(shape)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded as a true division (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds otherwise)."""
    return a / torch.tensor(float(b), device=a.device)


def _march_ref(packed: Packed, rays: torch.Tensor, n_candidates: int):
    """(final transmittance (R, 1), running sums S (R, C-2) of the interior
    weights + 1e-5, spacing (R, 1))."""
    c = n_candidates
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    spacing = _div(far - near, c - 1)
    dn = torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2] + d[:, 2:3] * d[:, 2:3])
    dz = spacing * dn
    z = near + torch.arange(c, dtype=torch.float32, device=rays.device) * spacing
    score = proxy_scores_ref(packed, o[:, None, :] + d[:, None, :] * z[..., None])
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


def proxy_opacity_ref(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """Plain version of `proxy_opacity`: (R,) 1 - final transmittance."""
    return 1.0 - _march_ref(packed, rays, n_candidates)[0][:, 0]


def _u(n_keep: int, midpoint: bool, device) -> torch.Tensor:
    k = torch.arange(n_keep, dtype=torch.float32, device=device)
    return _div(k + 0.5, n_keep) if midpoint else _div(k, n_keep - 1)


def proxy_march_select_ref(packed: Packed, rays: torch.Tensor, n_candidates: int,
                           n_keep: int, midpoint: bool = False,
                           return_density: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain version of `proxy_march_select`."""
    r, c = rays.shape[0], n_candidates
    _, cum, spacing = _march_ref(packed, rays, c)                  # cum (R, C-2)
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
    lib.proxy_opacity_forward.argtypes = [p, p, p, p, i, p, ll, i, p, p]
    lib.proxy_march_select_forward.argtypes = [p, p, p, p, i, p, ll, i, i, i, p, p, p, p, p]
    lib.proxy_opacity_forward.restype = lib.proxy_march_select_forward.restype = i
    return lib


def weight_args(packed: Packed, rays: torch.Tensor, n_candidates: int) -> list:
    """Validate rays and pack for the proxy kernels; their pointers and H."""
    if rays.device.type != "cuda":
        raise ValueError(f"proxy kernels: unsupported device {rays.device}")
    _check(rays, "rays", rays.device, torch.float32, (rays.shape[0], 8))
    hidden = packed["w1"].shape[0]
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"proxy kernels take hidden 1..{MAX_HIDDEN}, got {hidden}")
    if not 4 <= n_candidates <= MAX_CANDIDATES:
        raise ValueError(f"proxy kernels take 4..{MAX_CANDIDATES} candidates, got {n_candidates}")
    bf, f32 = torch.bfloat16, torch.float32
    for k, dtype, shape in (("w1", bf, (hidden, PROXY_IN)), ("b1", f32, (hidden,)),
                            ("w2", bf, (hidden,)), ("b2", f32, (1,))):
        _check(packed[k], k, rays.device, dtype, shape)
    return [packed[k].data_ptr() for k in ("w1", "b1", "w2", "b2")] + [hidden]


def current_stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def proxy_opacity(packed: Packed, rays: torch.Tensor, n_candidates: int) -> torch.Tensor:
    """Per-ray proxy opacity (R,) over C uniform candidates: the culling
    prepass. rays: (R, 8) f32 [o, d, near, far]."""
    if rays.device.type == "cpu":
        return proxy_opacity_ref(packed, rays, n_candidates)
    args = weight_args(packed, rays, n_candidates)
    out = torch.empty(rays.shape[0], dtype=torch.float32, device=rays.device)
    err = _lib().proxy_opacity_forward(*args, rays.data_ptr(), rays.shape[0], n_candidates,
                                       out.data_ptr(), current_stream(rays.device))
    if err != 0:
        raise RuntimeError(f"proxy_opacity_forward failed: cudaError {err}")
    LAUNCHES["opacity"] += 1
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
    args = weight_args(packed, rays, n_candidates)
    r, dev = rays.shape[0], rays.device
    z = torch.empty((r, n_keep), dtype=torch.float32, device=dev)
    xyz = torch.empty((r, n_keep, 3), dtype=torch.float32, device=dev)
    rho = torch.empty((r, n_keep), dtype=torch.float32, device=dev) if return_density else None
    mass = torch.empty(r, dtype=torch.float32, device=dev) if return_density else None
    err = _lib().proxy_march_select_forward(
        *args, rays.data_ptr(), r, n_candidates, n_keep, int(midpoint), z.data_ptr(),
        xyz.data_ptr(), rho.data_ptr() if return_density else None,
        mass.data_ptr() if return_density else None, current_stream(dev))
    if err != 0:
        raise RuntimeError(f"proxy_march_select_forward failed: cudaError {err}")
    LAUNCHES["select"] += 1
    return (z, xyz, rho, mass) if return_density else (z, xyz)
