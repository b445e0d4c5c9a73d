"""The fused NeRF field kernel (csrc/fused_mlp.cu) against its plain version.

Imports torch only, so it also runs where JAX is not installed. Tests marked
`cuda` need a CUDA card and skip without one; on the card run

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Tolerance of kernel vs plain: atol 2e-3, rtol 1e-2. Both take bf16
operands and accumulate in float32, so only the summation order differs
(a hidden activation may round to the neighbouring bf16 value).
"""
import numpy as np
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp

ATOL, RTOL = 2e-3, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(width=256, depth=8, device="cpu", seed=0):
    model = NeRF(NeRFConfig(depth=depth, width=width),
                 generator=torch.Generator().manual_seed(seed))
    return fused_mlp.pack_nerf_params(model, device)


def _points(n, n_dirs, seed=1):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n_dirs, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(xyz), torch.from_numpy(d)


def test_cpu_wrapper_runs_plain_version_without_launching():
    packed = _packed(width=128, depth=5)
    xyz, d = _points(37, 37)
    before = dict(fused_mlp.LAUNCHES)
    torch.testing.assert_close(fused_mlp.fused_nerf_sigma(packed, xyz),
                               fused_mlp.fused_sigma_ref(packed, xyz), rtol=0, atol=0)
    torch.testing.assert_close(fused_mlp.fused_nerf_full(packed, xyz, d),
                               fused_mlp.fused_full_ref(packed, xyz, d), rtol=0, atol=0)
    assert fused_mlp.LAUNCHES == before


def test_plain_full_per_ray_directions_equal_per_point():
    """samples_per_dir=S reads direction p // S: the same as repeating it."""
    packed = _packed(width=128, depth=5)
    xyz, d = _points(5 * 7, 5)
    per_ray = fused_mlp.fused_full_ref(packed, xyz, d, samples_per_dir=7)
    per_point = fused_mlp.fused_full_ref(packed, xyz, d.repeat_interleave(7, 0))
    torch.testing.assert_close(per_ray, per_point, rtol=0, atol=0)


def test_wrapper_rejects_non_cuda_devices():
    packed = _packed(width=128, depth=5)
    xyz = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_nerf_sigma(packed, xyz)


@pytest.mark.cuda
@pytest.mark.parametrize("n,samples_per_dir", [(1, 1), (127, 1), (1000, 1), (4099, 7)])
def test_kernel_matches_plain(cuda_device, n, samples_per_dir):
    packed = _packed(device=cuda_device)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    sig = fused_mlp.fused_nerf_sigma(packed, xyz)
    full = fused_mlp.fused_nerf_full(packed, xyz, d, samples_per_dir=samples_per_dir)
    torch.cuda.synchronize()
    assert sig.shape == (n, 1) and full.shape == (n, 4)
    torch.testing.assert_close(sig, fused_mlp.fused_sigma_ref(packed, xyz), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(
        full, fused_mlp.fused_full_ref(packed, xyz, d, samples_per_dir), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_render_rays_fused_on_kernel_matches_plain_field(cuda_device):
    """The eval renderer on the card (both passes on the kernel) against the
    same render on the CPU (plain field), atol 5e-3 as in chip_smoke.py."""
    from nerf_siren_tpu.config import RenderConfig
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    gen = torch.Generator().manual_seed(3)
    models = {k: NeRF(NeRFConfig(), generator=gen) for k in ("coarse", "fine")}
    rng = np.random.default_rng(4)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = torch.from_numpy(np.concatenate(
        [rng.normal(size=(96, 3)).astype(np.float32) * 0.3, d,
         np.full((96, 1), 2, np.float32), np.full((96, 1), 6, np.float32)], -1))
    cfg = RenderConfig(n_samples=16, n_importance=32, noise_std=0.0, white_back=True,
                       test_time=True)
    with torch.no_grad():
        ref = render_rays_fused(fused_mlp.pack_model_params(models, "cpu"), rays, cfg)
        got = render_rays_fused(fused_mlp.pack_model_params(models, cuda_device),
                                rays.to(cuda_device), cfg)
    for k in ref:
        torch.testing.assert_close(got[k].cpu(), ref[k], atol=5e-3, rtol=0, msg=k)


@pytest.mark.cuda
def test_kernel_counts_launches_and_skips_empty_input(cuda_device):
    packed = _packed(device=cuda_device)
    before = dict(fused_mlp.LAUNCHES)
    xyz, d = _points(300, 300)
    fused_mlp.fused_nerf_sigma(packed, xyz.to(cuda_device))
    fused_mlp.fused_nerf_full(packed, xyz.to(cuda_device), d.to(cuda_device))
    empty = fused_mlp.fused_nerf_sigma(packed, torch.zeros((0, 3), device=cuda_device))
    assert empty.shape == (0, 1)
    assert fused_mlp.LAUNCHES["sigma"] == before["sigma"] + 1
    assert fused_mlp.LAUNCHES["full"] == before["full"] + 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    packed = _packed(device=cuda_device)
    xyz = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="xyz"):
        fused_mlp.fused_nerf_sigma(packed, xyz.double())
    with pytest.raises(ValueError, match="xyz"):
        fused_mlp.fused_nerf_sigma(packed, torch.zeros((3, 8), device=cuda_device).t())
    with pytest.raises(ValueError, match="dirs"):
        fused_mlp.fused_nerf_full(packed, xyz, torch.zeros((3, 3), device=cuda_device))
    with pytest.raises(ValueError, match="width"):
        fused_mlp.fused_nerf_sigma(_packed(width=128, device=cuda_device), xyz)
    with pytest.raises(ValueError, match="w0e"):
        fused_mlp.fused_nerf_sigma({**packed, "w0e": packed["w0e"].cpu()}, xyz)
