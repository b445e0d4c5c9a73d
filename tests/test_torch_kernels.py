"""The hand-written CUDA kernels against their plain versions: the fused
NeRF field (K1, csrc/fused_mlp.cu), the fused training field's forward
and backward (K2, csrc/fused_mlp_train.cu), the proxy march (K3,
csrc/proxy_march.cu), the int8 field (K4, csrc/fused_mlp_int8.cu), K1's
and K4's wide kernel (csrc/fused_mlp_wide.cu: widths above 512, depths
above 16), the triplane gather (K5, csrc/triplane_gather.cu) and the proxy
top-K (K6, the TOPK epilogue of csrc/proxy_march.cu; K3 and K6 above
MAX_CANDIDATES on their device-scratch kernel); and on the card, the grouped
steps' CUDA graphs (the MLP field on K2, SIREN and d3; d3's graph on its
masked cloud, its loop on the valid prefix) against eager or
looped steps, a d3 fast tile on K3 and K1 against their plain versions,
a fast frame that makes no host synchronisation, EG3D's grouped steps on a graph against their loop and a fast EG3D tile
on K3 against K3's plain version.

Imports torch only, so it also runs where JAX is not installed. Tests marked
`cuda` need a CUDA card and skip without one; on the card run

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Tolerance of kernel vs plain: atol 2e-3, rtol 1e-2. Both take bf16
operands and accumulate in float32, so only the summation order differs
(a hidden activation may round to the neighbouring bf16 value). K2's
gradients: relative L2 below 1e-2 per tensor and every element within
5e-2 of the tensor's largest magnitude. The element bound is set by ReLU
masks that flip where a hidden activation rounds to the neighbouring bf16
value: on an H100, at N = 4099 the kernel's ReLU outputs differ from the
plain version's in up to 2332 entries of a layer (by one bf16 step) and 13
masks flip across the trunk, and the worst element is 2.01e-2 of its
tensor's largest
(9.8e-3 at N = 65,536). Run on the kernel's own stashed activations, the
plain gradient chain agrees within 6.7e-4 at both sizes (1.1e-3 at
N = 127), so that check holds the kernel to SAME_ELEM = 3e-3.
"""
import copy

import numpy as np
import pytest
import torch

from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2
from nerf_siren_tpu_torch.ops.kernels.proxy_march import MAX_CANDIDATES

ATOL, RTOL = 2e-3, 1e-2
SAME_ELEM = 3e-3   # K2 vs the plain gradient chain on the kernel's own activations


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(width=256, depth=8, device="cpu", seed=0, skips=(4,)):
    model = NeRF(NeRFConfig(depth=depth, width=width, skips=skips),
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


GRID_EDGE = -1   # n = 2 x (the card's SM count) x 128 + 5: past two rounds of the persistent grid


@pytest.mark.cuda
@pytest.mark.parametrize("n,samples_per_dir,depth,skips", [
    (1, 1, 8, (4,)), (63, 1, 8, (4,)), (64, 7, 8, (4,)), (127, 1, 8, (4,)),
    (128, 192, 8, (4,)), (129, 7, 8, (4,)), (1000, 1, 8, (4,)), (4099, 7, 8, (4,)),
    (4099, 192, 8, (1, 6)), (GRID_EDGE, 192, 8, (4,)), (GRID_EDGE, 1, 3, (1,)),
    (4099, 7, 3, (1,)), (129, 1, 3, (2,)), (1000, 7, 1, ()), (1, 192, 1, ())])
def test_kernel_matches_plain(cuda_device, n, samples_per_dir, depth, skips):
    """Tile (128 points) and persistent-grid edges, depths 1 / 3 / 8 with
    the embedding taken at varied layers (the next tile's embedding is
    formed at another point of the layer loop for each), one direction per
    1, 7 or 192 points."""
    if n == GRID_EDGE:
        n = 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 128 + 5
    packed = _packed(depth=depth, device=cuda_device, skips=skips)
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
@pytest.mark.parametrize("width", [128, 384, 512])
@pytest.mark.parametrize("n,samples_per_dir,depth,skips", [
    (1, 1, 8, (4,)), (63, 7, 8, (4,)), (129, 192, 8, (4,)), (4099, 7, 8, (4,)),
    (GRID_EDGE, 16, 8, (4,)), (4099, 192, 3, (1,)), (1000, 1, 1, ())])
def test_kernel_matches_plain_at_every_width(cuda_device, width, n, samples_per_dir, depth,
                                             skips):
    """K1 at the widths beside 256 (128: the same schedule, n128 / n64
    products; 384 and 512: two warpgroups on a 64-point tile, half the
    columns each), both passes, at tile and persistent-grid edges."""
    if n == GRID_EDGE:
        n = 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 128 + 5
    packed = _packed(width=width, depth=depth, device=cuda_device, skips=skips)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    before = dict(fused_mlp.LAUNCHES)
    sig = fused_mlp.fused_nerf_sigma(packed, xyz)
    full = fused_mlp.fused_nerf_full(packed, xyz, d, samples_per_dir=samples_per_dir)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == {**before, "sigma": before["sigma"] + 1,
                                  "full": before["full"] + 1}
    assert sig.shape == (n, 1) and full.shape == (n, 4)
    torch.testing.assert_close(sig, fused_mlp.fused_sigma_ref(packed, xyz), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(
        full, fused_mlp.fused_full_ref(packed, xyz, d, samples_per_dir), atol=ATOL, rtol=RTOL)
    assert torch.equal(sig, fused_mlp.fused_nerf_sigma(packed, xyz))   # a fixed summation order


@pytest.mark.cuda
def test_render_rays_fused_on_kernel_matches_plain_field(cuda_device):
    """The eval renderer on the card (both passes on the kernel) against the
    same render on the CPU (plain field), atol 5e-3 as in chip_smoke.py."""
    from nerf_siren_tpu_torch.config import RenderConfig
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


def test_k1_ablation_variants_apply_to_the_kernel_source():
    """Every text edit of the ablation tool still finds its place in
    csrc/fused_mlp.cu, and each variant differs from the kernel."""
    from nerf_siren_tpu_torch import k1_ablation
    from nerf_siren_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "fused_mlp.cu").read_text()
    found = k1_ablation.variants(src)
    assert found.pop("as built") == src
    assert len(found) == 5 and all(text != src for text in found.values())


def test_k2_ablation_variants_apply_to_the_kernel_source():
    """Every text edit of K2's ablation tool still finds its place in
    csrc/fused_mlp_train.cu, and each variant differs from the kernel."""
    from nerf_siren_tpu_torch import k2_ablation
    from nerf_siren_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "fused_mlp_train.cu").read_text()
    found = k2_ablation.variants(src)
    assert found.pop("as built") == src
    assert len(found) == 6 and all(text != src for text in found.values())


@pytest.mark.cuda
def test_kernel_launches_are_bit_identical(cuda_device):
    """A fixed tile schedule and summation order: two launches agree bit for bit."""
    packed = _packed(device=cuda_device)
    xyz, d = _points(20_000, 20_000 // 64 + 1)
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    for run in (lambda: fused_mlp.fused_nerf_sigma(packed, xyz),
                lambda: fused_mlp.fused_nerf_full(packed, xyz, d, samples_per_dir=64)):
        assert torch.equal(run(), run())


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
    # the widths it takes: every multiple of 128 (once 256 only, then 128-512): 640
    # runs on the wide kernel, 192 is refused, as JAX's pack refuses it
    with pytest.raises(ValueError, match="width"):
        fused_mlp.fused_nerf_sigma(_packed(width=192, depth=3, skips=(1,),
                                           device=cuda_device), xyz)
    p640 = _packed(width=640, depth=3, skips=(1,), device=cuda_device)
    torch.testing.assert_close(fused_mlp.fused_nerf_sigma(p640, xyz),
                               fused_mlp.fused_sigma_ref(p640, xyz), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="k1_stream"):
        fused_mlp.fused_nerf_sigma({**packed, "k1_stream": packed["k1_stream"].cpu()}, xyz)
    with pytest.raises(ValueError, match="k1_stream"):
        fused_mlp.fused_nerf_sigma({k: v for k, v in packed.items() if k != "k1_stream"}, xyz)
    with pytest.raises(ValueError, match="b3"):
        fused_mlp.fused_nerf_sigma({**packed, "b3": packed["b3"].cpu()}, xyz)


def assert_grads_close(got, ref, msg=""):
    """K2 gradient tolerance (module docstring)."""
    assert set(got) == set(ref), msg
    for k, b in ref.items():
        a = got[k]
        assert a.shape == b.shape and torch.isfinite(a).all(), f"{msg} {k}"
        rel = float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))
        scale = float(b.abs().max())
        assert rel < 1e-2, f"{msg} {k}: relative L2 {rel:.3e}"
        assert float((a - b).abs().max()) <= 5e-2 * scale + 1e-30, f"{msg} {k}"


def _train_packed(device, seed=0):
    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(seed)).to(device)
    return k2.pack_train_params(model.state_dict())


@pytest.mark.cuda
@pytest.mark.parametrize("n,samples_per_dir", [(65536, 64), (4099, 7), (1, 1)] + [
    (n, s) for n in (1, 127, 129, 65536 + 37) for s in (1, 64, 192) if (n, s) != (1, 1)] + [
    (24576, 24), (24576 + 13, 24)])
def test_train_kernels_match_plain(cuda_device, n, samples_per_dir):
    """K2 against the plain version, at tile edges (127, 129: one warpgroup's
    block of 64 points past N; 65,536 + 37: a second round of the
    persistent grid), one direction per 1, 64 or 192 points, and at the
    culled step's shape (1024 rays x 24 points, one direction per 24, and
    an odd count beside it); then the
    plain gradient chain run on the activations the backward's tile kernel
    stashed, read back through the stash layout (so on its own ReLU masks),
    against the kernel, within SAME_ELEM of each tensor's largest
    magnitude. The counts of activations that differ and of masks that
    flip, and the worst element of both comparisons, are printed (-s)."""
    packed = _train_packed(cuda_device)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    dy = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 4)).astype(np.float32))
    dy = dy.to(cuda_device)
    out = k2.fused_train_fwd(packed, xyz, d, samples_per_dir)
    grads, (ex, hs, feat, demb, hd) = k2.fused_train_bwd_activations(
        packed, xyz, d, dy, samples_per_dir)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, k2.fused_train_fwd_ref(packed, xyz, d, samples_per_dir),
                               atol=ATOL, rtol=RTOL)
    plain = k2.fused_train_bwd_ref(packed, xyz, d, dy, samples_per_dir)
    same = k2.backward_ref_from(packed, (ex, hs, feat, demb, hd, out[:, :3]), dy)

    r_ex, r_hs, _, r_feat, r_demb, r_hd, _ = k2._forward_ref(packed, xyz, d, samples_per_dir)
    rows = []
    for name, a, b in ([("emb", ex, r_ex), ("demb", demb, r_demb)]
                       + [(f"h{i}", a, b) for i, (a, b) in enumerate(zip(hs, r_hs))]
                       + [("feat", feat, r_feat), ("hd", hd, r_hd)]):
        flips = int(((a > 0) != (b > 0)).sum()) if name[0] == "h" else 0
        rows.append(f"{name}: {int((a != b).sum())} differ, {flips} masks flip")
    print(f"\n[n={n}] kernel vs plain activations: " + "; ".join(rows))

    def worst(ref):
        return max((float((grads[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30), k)
                   for k, v in ref.items())

    print(f"[n={n}] worst element over its tensor's largest: vs plain {worst(plain)}, "
          f"vs plain on the kernel's activations {worst(same)}")
    assert_grads_close(grads, plain, f"n={n}")
    assert worst(same)[0] <= SAME_ELEM, worst(same)
    again = k2.fused_train_bwd(packed, xyz, d, dy, samples_per_dir)
    assert all(torch.equal(again[k], grads[k]) for k in grads), "a second call differs"


@pytest.mark.cuda
def test_train_backward_is_deterministic_and_counts_launches(cuda_device):
    packed = _train_packed(cuda_device)
    xyz, d = _points(3000, 3000)
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    dy = torch.ones((3000, 4), device=cuda_device)
    before = dict(k2.LAUNCHES)
    a = k2.fused_train_bwd(packed, xyz, d, dy)
    b = k2.fused_train_bwd(packed, xyz, d, dy)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert k2.LAUNCHES["bwd"] == before["bwd"] + 2


@pytest.mark.cuda
def test_fused_field_train_autograd_on_the_card(cuda_device):
    """The autograd Function on CUDA tensors launches K2 and gives the
    gradients of its plain backward."""
    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    xyz, d = _points(2048, 32)
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    before = dict(k2.LAUNCHES)
    out = k2.fused_field_train(model, xyz, d, samples_per_dir=64)
    out.square().sum().backward()
    assert k2.LAUNCHES["fwd"] == before["fwd"] + 1 and k2.LAUNCHES["bwd"] == before["bwd"] + 1
    packed = k2.pack_train_params(model.state_dict())
    ref = k2.grads_to_state_dict(k2.fused_train_bwd_ref(packed, xyz, d, 2 * out.detach(), 64))
    assert_grads_close({k: p.grad for k, p in model.named_parameters()}, ref)


@pytest.mark.cuda
def test_train_kernels_reject_what_they_do_not_take(cuda_device):
    packed = _train_packed(cuda_device)
    xyz = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="dirs"):
        k2.fused_train_fwd(packed, xyz, torch.zeros((3, 3), device=cuda_device))
    with pytest.raises(ValueError, match="dy"):
        k2.fused_train_bwd(packed, xyz, xyz, torch.zeros((8, 3), device=cuda_device))
    with pytest.raises(ValueError, match="w_feat"):
        k2.fused_train_fwd({**packed, "w_feat": packed["w_feat"].float()}, xyz, xyz)
    assert k2._lib().nerf_train_stream_elems() == k2.K2_STREAM_NUMEL   # one schedule on both sides
    dy = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="k2_stream"):
        k2.fused_train_bwd({k: v for k, v in packed.items() if k != "k2_stream"}, xyz, xyz, dy)
    with pytest.raises(ValueError, match="k2_stream"):
        k2.fused_train_bwd({**packed, "k2_stream": packed["k2_stream"][:-64]}, xyz, xyz, dy)
    with pytest.raises(ValueError, match="k2_stream"):
        k2.fused_train_bwd({**packed, "k2_stream": packed["k2_stream"].cpu()}, xyz, xyz, dy)
    with pytest.raises(ValueError, match="w3"):
        k2.fused_train_bwd({**packed, "w3": packed["w3"].t()}, xyz, xyz, dy)


# The forward's heads against float64 heads on the backward's stashed h_7 and
# hd. The products of bf16 values are exact in float32, so the kernel's
# heads differ from the exact sums only by float32 rounding along its
# summation chain, of depth d: each thread sums its 64 (sigma) or 32 (rgb
# pre-activation) columns as pairs (2 roundings a pair), a quad sum adds 2
# levels and the bias 1, so d = 67 for sigma and 35 for rgb. The bar is
# gamma_d * S with gamma_d = d u / (1 - d u), u = 2^-24 and S the sum of the
# terms' magnitudes; rgb's is a quarter of its pre-activation's (the
# sigmoid's slope) plus 1e-6 for expf and the division. An activation that
# differs by one bf16 step moves a head by |w h| 2^-8 for that term alone,
# about four times the bar for a term of average size.
HEAD_DEPTHS = {"sigma": 67, "rgb": 35}


def _head_bar(depth, terms, bias):
    u = 2.0 ** -24
    return depth * u / (1 - depth * u) * (terms.abs().sum(-1) + bias.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("n,samples_per_dir", [(65536, 64), (4099, 7), (129, 192)])
def test_train_forward_heads_sit_on_the_backward_recompute(cuda_device, n, samples_per_dir):
    """The forward runs the backward's recompute: its sigma and rgb lie
    within the float32 reordering bar of the plain heads applied to the
    h_7 and hd that the backward's tile kernel stashed."""
    packed = _train_packed(cuda_device)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    dy = torch.ones((n, 4), device=cuda_device)
    out = k2.fused_train_fwd(packed, xyz, d, samples_per_dir)
    _, (_, hs, _, _, hd) = k2.fused_train_bwd_activations(packed, xyz, d, dy, samples_per_dir)
    torch.cuda.synchronize()
    f64 = {k: packed[k].double() for k in ("w_sigma", "b_sigma", "w_rgb", "b_rgb")}
    s_terms = hs[-1].double() * f64["w_sigma"]
    sigma = s_terms.sum(-1) + f64["b_sigma"]
    s_bar = _head_bar(HEAD_DEPTHS["sigma"], s_terms, f64["b_sigma"])
    r_terms = hd.double()[:, None, :] * f64["w_rgb"][None]          # (n, 3, WD)
    rgb = torch.sigmoid(r_terms.sum(-1) + f64["b_rgb"])
    r_bar = 0.25 * _head_bar(HEAD_DEPTHS["rgb"], r_terms, f64["b_rgb"]) + 1e-6
    s_d = (out[:, 3].double() - sigma).abs()
    r_d = (out[:, :3].double() - rgb).abs()
    print(f"\n[n={n}] forward heads vs float64 heads on the stashed h_7, hd: sigma worst "
          f"{float((s_d / s_bar).max()):.3f} of its bar, rgb {float((r_d / r_bar).max()):.3f}")
    assert bool((s_d <= s_bar).all()), float((s_d / s_bar).max())
    assert bool((r_d <= r_bar).all()), float((r_d / r_bar).max())


@pytest.mark.cuda
def test_train_forward_is_deterministic_and_counts_launches(cuda_device):
    packed = _train_packed(cuda_device)
    xyz, d = _points(20_000, 20_000 // 64 + 1)
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    before = dict(k2.LAUNCHES)
    a = k2.fused_train_fwd(packed, xyz, d, 64)
    b = k2.fused_train_fwd(packed, xyz, d, 64)
    assert torch.equal(a, b)
    assert k2.LAUNCHES["fwd"] == before["fwd"] + 2


@pytest.mark.cuda
def test_train_forward_reads_the_stream_prefix_it_is_given(cuda_device):
    """The forward takes the pack's k2_stream or raises naming it, and both
    sides hold one prefix length."""
    packed = _train_packed(cuda_device)
    xyz = torch.zeros((8, 3), device=cuda_device)
    assert k2._lib().nerf_train_forward_stream_elems() == k2.K2_FWD_STREAM_NUMEL
    with pytest.raises(ValueError, match="k2_stream"):
        k2.fused_train_fwd({k: v for k, v in packed.items() if k != "k2_stream"}, xyz, xyz)
    with pytest.raises(ValueError, match="k2_stream"):
        k2.fused_train_fwd({**packed, "k2_stream": packed["k2_stream"][:k2.K2_FWD_STREAM_NUMEL]},
                           xyz, xyz)


# ---- K3 proxy march, K6 proxy top-K, K4 int8 field ----------------------------
# Tolerances of kernel vs plain: K3 scores the proxy on the tensor cores, so
# its float32 sums run in another order than the plain version's and its
# scores lie within `proxy_score_bar` of the plain scores (a pre-activation
# moved by float32 rounding may round its hidden activation to the
# neighbouring bf16 value); given its own scores (`proxy_march_scores`) the
# plain march equals its outputs bit for bit. Against the plain version
# end to end the bars are tests/test_proxy_march.py's (depths: median
# |dz| < 0.005 and 99th percentile < 0.05 of far - near; opacity: median
# < 2e-3, max < 0.05). K6 scores on K3's stage: its scores (read back by
# `proxy_select_scores`) lie within `proxy_score_bar` of the plain ones, the
# plain selection on them equals its depths bit for bit and in order, and
# where a ray keeps another set than the plain version every candidate
# swapped across the cut is a near tie: the plain scores of the two lie
# within their bars' sum (`cut_swaps`). K4: rgb atol 2e-2, sigma atol 5e-2 +
# rtol 2e-2 (tests/test_fused_int8.py), and under 1e-3 of the int8 inputs of
# its layers rounded apart (0 on an H100).

def _proxy_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(np.concatenate(
        [rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32), d,
         np.full((n, 1), 2.0, np.float32), np.full((n, 1), 6.0, np.float32)], -1))


def _proxy_pack(hidden, device, seed=3):
    from nerf_siren_tpu_torch.ops.kernels.proxy_march import pack_proxy_params
    from nerf_siren_tpu_torch.render.fast import init_proxy

    return pack_proxy_params(init_proxy(hidden, generator=torch.Generator().manual_seed(seed)),
                             device)


def test_proxy_and_int8_wrappers_run_plain_versions_on_the_cpu():
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    pp, rays = _proxy_pack(48, "cpu"), _proxy_rays(33)
    before = (dict(k3.LAUNCHES), dict(k6.LAUNCHES), dict(k4.LAUNCHES))
    assert torch.equal(k3.proxy_opacity(pp, rays, 16), k3.proxy_opacity_ref(pp, rays, 16))
    for a, b in zip(k3.proxy_march_select(pp, rays, 16, 8, True, True),
                    k3.proxy_march_select_ref(pp, rays, 16, 8, True, True)):
        assert torch.equal(a, b)
    assert torch.equal(k6.proxy_select(pp, rays, 32, 8), k6.proxy_select_ref(pp, rays, 32, 8))
    model = NeRF(NeRFConfig(depth=5, width=128), generator=torch.Generator().manual_seed(0))
    p8 = k4.pack_nerf_params_int8(model)
    xyz, d = _points(37, 37)
    assert torch.equal(k4.fused_nerf_full_int8(p8, xyz, d), k4.fused_full_int8_ref(p8, xyz, d))
    assert torch.equal(k4.fused_nerf_sigma_int8(p8, xyz), k4.fused_sigma_int8_ref(p8, xyz))
    assert (dict(k3.LAUNCHES), dict(k6.LAUNCHES), dict(k4.LAUNCHES)) == before


K3_SHAPES = [(1, 16, 8, 48, False), (130, 32, 16, 96, True), (4099, 32, 16, 96, False),
             (2048, 64, 5, 128, True), (77, 5, 4, 96, True), (301, 37, 16, 100, False),
             (65, 256, 16, 1, True), (200, 256, 3, 128, False), (129, 96, 40, 96, True),
             (70, 64, 300, 48, False),
             # above 256: 8 rays a block at C 512, one ray a block from C 4096
             (300, 512, 16, 96, True), (33, 1000, 24, 128, False), (20, 4096, 32, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k,hidden,midpoint", K3_SHAPES)
def test_proxy_march_kernels_match_plain(cuda_device, n, c, k, hidden, midpoint):
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    pp, rays = _proxy_pack(hidden, cuda_device), _proxy_rays(n).to(cuda_device)
    before = dict(k3.LAUNCHES)
    opac = k3.proxy_opacity(pp, rays, c)
    z, xyz, rho, mass = k3.proxy_march_select(pp, rays, c, k, midpoint, True)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == {**before, "opacity": before["opacity"] + 1,
                           "select": before["select"] + 1}
    ref_opac = k3.proxy_opacity_ref(pp, rays, c)
    rz, rxyz, rrho, rmass = k3.proxy_march_select_ref(pp, rays, c, k, midpoint, True)
    e = (opac - ref_opac).abs()
    dz = (z - rz).abs() / 4.0
    print(f"\n[n={n} C={c} K={k}] opacity max|d| {float(e.max()):.3e}; depth max|d| "
          f"{float(dz.max()) * 4:.3e}, {int((z != rz).sum())} of {z.numel()} differ")
    assert float(e.median()) < 2e-3 and float(e.max()) < 0.05
    assert float(dz.median()) < 0.005 and float(torch.quantile(dz.flatten(), 0.99)) < 0.05
    assert bool((z[:, 1:] >= z[:, :-1] - 1e-5).all())
    torch.testing.assert_close(xyz, rays[:, None, :3] + rays[:, None, 3:6] * z[..., None],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(mass, rmass, atol=1e-5, rtol=1e-4)
    rel = (rho - rrho).abs() / rrho.abs().clamp_min(1e-3)
    assert float(rel.median()) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k,hidden,midpoint", K3_SHAPES)
def test_proxy_march_scores_within_bar_and_plain_march_on_them_is_bit_equal(
        cuda_device, n, c, k, hidden, midpoint):
    """K3's scores read back lie within `proxy_score_bar` of the plain
    scores; the plain march on them equals both kernels' outputs bit for
    bit."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    pp, rays = _proxy_pack(hidden, cuda_device), _proxy_rays(n).to(cuda_device)
    got = k3.proxy_march_scores(pp, rays, c)
    ref = k3.proxy_march_scores_ref(pp, rays, c)
    bar = k3.proxy_score_bar(pp, k3.candidate_points(rays, c))
    d = (got - ref).abs()
    over = torch.where(d > 0, d / bar, torch.zeros((), device=d.device))
    print(f"\n[n={n} C={c} H={hidden}] scores: {int((got != ref).sum())} of {got.numel()} differ, "
          f"max|d| {float(d.max()):.3e}, max |d| / bar {float(over.max()):.3e}")
    assert got.shape == (n, c) and bool(torch.isfinite(got).all())
    assert bool((d <= bar).all())
    opac = k3.proxy_opacity(pp, rays, c)
    assert torch.equal(opac, k3.proxy_opacity_ref(pp, rays, c, scores=got))
    outs = k3.proxy_march_select(pp, rays, c, k, midpoint, True)
    for a, b in zip(outs, k3.proxy_march_select_ref(pp, rays, c, k, midpoint, True,
                                                    scores=got)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_proxy_march_rays_are_independent_of_their_batch(cuda_device):
    """A ray's outputs do not depend on its place in the batch or on R: a
    subset (another block and tile position for every ray) gives the same
    bits as the full batch, and two calls give the same bits."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    pp, rays = _proxy_pack(96, cuda_device), _proxy_rays(5000, seed=7).to(cuda_device)
    idx = torch.randperm(5000, generator=torch.Generator().manual_seed(0))[:1237].to(cuda_device)
    sub = rays[idx].contiguous()
    for c in (16, 37):
        full = k3.proxy_march_select(pp, rays, c, 16, True, True)
        assert all(torch.equal(a, b) for a, b in
                   zip(full, k3.proxy_march_select(pp, rays, c, 16, True, True)))
        for a, b in zip(full, k3.proxy_march_select(pp, sub, c, 16, True, True)):
            assert torch.equal(a[idx], b)
        opac = k3.proxy_opacity(pp, rays, c)
        assert torch.equal(opac, k3.proxy_opacity(pp, rays, c))
        assert torch.equal(opac[idx], k3.proxy_opacity(pp, sub, c))
        assert torch.equal(k3.proxy_march_scores(pp, rays, c)[idx],
                           k3.proxy_march_scores(pp, sub, c))


@pytest.mark.cuda
def test_proxy_march_kernels_take_no_rays(cuda_device):
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    pp, rays = _proxy_pack(96, cuda_device), _proxy_rays(0).to(cuda_device)
    before = dict(k3.LAUNCHES)
    assert k3.proxy_opacity(pp, rays, 32).shape == (0,)
    z, xyz, rho, mass = k3.proxy_march_select(pp, rays, 32, 16, True, True)
    torch.cuda.synchronize()
    assert (z.shape, xyz.shape, rho.shape, mass.shape) == ((0, 16), (0, 16, 3), (0, 16), (0,))
    assert k3.proxy_march_scores(pp, rays, 32).shape == (0, 32)
    assert k3.LAUNCHES == {**before, "opacity": before["opacity"] + 1,
                           "select": before["select"] + 1}


@pytest.mark.cuda
def test_proxy_opacity_at_the_candidate_cap_and_refused_above_it(cuda_device):
    """At MAX_CANDIDATES (one ray a block in 227 KB of shared memory; the
    library's own cap is the same) and above it (once refused; now each
    CTA's row of scores in a device scratch: `proxy_march_huge_kernel`, at
    MAX_CANDIDATES + 1 and 65,536) K3 opacity and select match their plain
    versions, and the plain march on the kernel's own scores equals them
    bit for bit; launches above the cap count under '*_scratch'."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    cap = MAX_CANDIDATES
    assert k3.kernel_max_candidates() == cap >= 16384
    assert k3.shared_bytes(128, cap) == k3.shared_bytes_at(128, cap) <= k3.SMEM_MAX
    assert k3.shared_bytes(128, cap + 1) < 32768   # the row is not in shared memory
    pp, rays = _proxy_pack(128, cuda_device), _proxy_rays(3).to(cuda_device)
    for c in (cap, cap + 1, 65536):
        before = dict(k3.LAUNCHES)
        opac = k3.proxy_opacity(pp, rays, c)
        sel = k3.proxy_march_select(pp, rays, c, 16, True, True)
        scores = k3.proxy_march_scores(pp, rays, c)
        torch.cuda.synchronize()
        key = "" if c <= cap else "_scratch"
        assert k3.LAUNCHES == {**before, f"opacity{key}": before[f"opacity{key}"] + 1,
                               f"select{key}": before[f"select{key}"] + 1}
        assert torch.equal(opac, k3.proxy_opacity_ref(pp, rays, c, scores=scores))
        for got, want in zip(sel, k3.proxy_march_select_ref(pp, rays, c, 16, True, True,
                                                           scores=scores)):
            assert torch.equal(got, want)
        e = (opac - k3.proxy_opacity_ref(pp, rays, c)).abs()
        assert float(e.max()) < 0.05


# (R, C, K, H): C 1-256 and 512, 4096, K from 1 to C, every wgmma width (H 1 and 16 -> 16,
# 48 -> 64, 96, 100 and 128 -> 128); "edge": one ray past the blocks of a
# full persistent grid at C 64, H 96 (4 CTAs an SM, 64 rays a block)
K6_SHAPES = [(1, 1, 1, 48), (70, 1, 1, 1), (70, 2, 2, 16), (70, 3, 1, 100), (4099, 3, 3, 96),
             (4099, 8, 8, 128), (4099, 32, 16, 96), (70, 32, 1, 48), (4099, 64, 16, 48),
             ("edge", 64, 16, 96), (1, 64, 64, 100), (257, 256, 3, 128), (70, 256, 256, 16),
             (301, 37, 5, 1), (300, 512, 16, 96), (20, 4096, 64, 128),
             # above MAX_CANDIDATES: rows in a device scratch, K arg-max passes
             (20, 65536, 16, 96), (3, 53104, 300, 128), (70, 60000, 1, 16)]


def _k6_rays(n, device):
    if n == "edge":
        n = torch.cuda.get_device_properties(device).multi_processor_count * 4 * 64 + 1
    return _proxy_rays(n, seed=2).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k,hidden", K6_SHAPES)
def test_proxy_select_kernel_matches_plain(cuda_device, n, c, k, hidden):
    """K6 against its plain version: (a) its scores, read back, within
    `proxy_score_bar` of the plain scores; (b) the plain selection on its
    own scores equal to its depths bit for bit and in order (and the
    readback kernel's depths to `proxy_select`'s); (c) where a ray keeps
    another set than the plain version, every swap across the cut a near
    tie within the two bars' sum. One launch counted a call, none for the
    readback."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    pp, rays = _proxy_pack(hidden, cuda_device, seed=1), _k6_rays(n, cuda_device)
    key = "select" if c <= MAX_CANDIDATES else "select_scratch"
    before = k6.LAUNCHES[key]
    got = k6.proxy_select(pp, rays, c, k)
    scores, z = k6.proxy_select_scores(pp, rays, c, k)
    torch.cuda.synchronize()
    assert k6.LAUNCHES[key] == before + 1
    assert got.shape == (rays.shape[0], k) and scores.shape == (rays.shape[0], c)
    zc = k6.candidate_depths(rays, c)
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * zc[..., None]
    ref, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)
    d = (scores - ref).abs()
    over = torch.where(d > 0, d / bar, torch.zeros((), device=d.device))
    n_sets, worst = k6.cut_swaps(ref, bar, scores, k)
    print(f"\n[n={rays.shape[0]} C={c} K={k} H={hidden}] scores: {int((d > 0).sum())} of "
          f"{d.numel()} differ, max |d| / bar {float(over.max()):.3e}; {n_sets} rays keep "
          f"another set, worst swap / bars {worst:.3e}")
    assert bool(torch.isfinite(scores).all()) and bool((d <= bar).all())
    assert torch.equal(z, got)
    assert torch.equal(got, k6.proxy_select_ref(pp, rays, c, k, scores=scores))
    assert worst <= 1.0
    if c == 1:
        assert torch.equal(got, rays[:, 6:7])


@pytest.mark.cuda
def test_proxy_select_is_deterministic_and_rays_independent_of_their_batch(cuda_device):
    """(d) Two calls give the same bits, and a ray's depths (and scores) do
    not depend on its place in the batch: a subset lands every ray in
    another block and tile."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    pp, rays = _proxy_pack(96, cuda_device), _proxy_rays(5000, seed=7).to(cuda_device)
    idx = torch.randperm(5000, generator=torch.Generator().manual_seed(0))[:1237].to(cuda_device)
    sub = rays[idx].contiguous()
    for c, k in ((3, 2), (64, 16), (200, 7)):
        full = k6.proxy_select(pp, rays, c, k)
        assert torch.equal(full, k6.proxy_select(pp, rays, c, k))
        assert torch.equal(full[idx], k6.proxy_select(pp, sub, c, k))
        scores = k6.proxy_select_scores(pp, rays, c, k)[0]
        assert torch.equal(scores[idx], k6.proxy_select_scores(pp, sub, c, k)[0])


@pytest.mark.cuda
def test_proxy_select_takes_no_rays_and_refuses_what_it_does_not_take(cuda_device):
    from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6

    pp = _proxy_pack(48, cuda_device)
    before = k6.LAUNCHES["select"]
    assert k6.proxy_select(pp, _proxy_rays(0).to(cuda_device), 32, 16).shape == (0, 16)
    assert k6.LAUNCHES["select"] == before + 1
    rays = _proxy_rays(8).to(cuda_device)
    cap = MAX_CANDIDATES
    # once refused above the cap: now the scratch kernel, the plain selection on its scores
    scores, z = k6.proxy_select_scores(pp, rays, cap + 1, 16)
    assert torch.equal(z, k6.proxy_select(pp, rays, cap + 1, 16))
    assert torch.equal(z, k6.proxy_select_ref(pp, rays, cap + 1, 16, scores=scores))
    with pytest.raises(ValueError, match="n_keep 17 of 16"):
        k6.proxy_select(pp, rays, 16, 17)
    with pytest.raises(ValueError, match="n_keep 0 of 16"):
        k6.proxy_select(pp, rays, 16, 0)
    with pytest.raises(ValueError, match="k3_w1t"):
        k6.proxy_select({k: v for k, v in pp.items() if k != "k3_w1t"}, rays, 16, 4)
    with pytest.raises(ValueError, match="rays"):
        k6.proxy_select(pp, rays[:, :7].contiguous(), 16, 4)
    assert k6.LAUNCHES["select"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,samples_per_dir,depth,skips", [
    (1, 1, 8, (4,)), (63, 7, 8, (4,)), (64, 16, 8, (4,)), (127, 1, 8, (4,)),
    (128, 192, 8, (4,)), (129, 7, 8, (4,)), (1000, 1, 8, (4,)), (4099, 7, 8, (4,)),
    (GRID_EDGE, 16, 8, (4,)), (1, 192, 3, (1,)), (129, 16, 3, (1,)), (4099, 192, 3, (1,)),
    (GRID_EDGE, 1, 3, (1,))])
def test_int8_kernel_matches_plain(cuda_device, n, samples_per_dir, depth, skips):
    """Tile (128 points) and persistent-grid edges, the reference depth and
    depth 3 with the skip at 1, one direction per 1, 7, 16 or 192 points."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    if n == GRID_EDGE:
        n = 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 128 + 5
    model = NeRF(NeRFConfig(depth=depth, skips=skips),
                 generator=torch.Generator().manual_seed(0)).to(cuda_device)
    p8 = k4.pack_nerf_params_int8(model)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    before = dict(k4.LAUNCHES)
    sig = k4.fused_nerf_sigma_int8(p8, xyz)
    full = k4.fused_nerf_full_int8(p8, xyz, d, samples_per_dir)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == {**before, "sigma": before["sigma"] + 1,
                           "full": before["full"] + 1}
    ref = k4.fused_full_int8_ref(p8, xyz, d, samples_per_dir)
    torch.testing.assert_close(full[:, :3], ref[:, :3], atol=2e-2, rtol=0)
    torch.testing.assert_close(full[:, 3:], ref[:, 3:], atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(sig, k4.fused_sigma_int8_ref(p8, xyz), atol=5e-2, rtol=2e-2)
    got_q, ref_q = k4.int8_trunk_inputs(p8, xyz), k4.int8_trunk_inputs_ref(p8, xyz)
    flips = (got_q != ref_q).sum(dim=(1, 2))
    print(f"\n[n={n}] int8 inputs rounded apart per layer: {flips.tolist()} of {n * 256} each; "
          f"full max|d| {(full - ref).abs().amax(0).tolist()}")
    assert int(flips.sum()) <= 1e-3 * got_q.numel() + 1


@pytest.mark.cuda
def test_int8_kernel_launches_are_bit_identical(cuda_device):
    """A fixed tile schedule and summation order: two launches agree bit for bit."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    p8 = k4.pack_nerf_params_int8(
        NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(0)).to(cuda_device))
    xyz, d = _points(20_000, 20_000 // 16)
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    for run in (lambda: k4.fused_nerf_sigma_int8(p8, xyz),
                lambda: k4.fused_nerf_full_int8(p8, xyz, d, samples_per_dir=16)):
        assert torch.equal(run(), run())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 384, 512])
@pytest.mark.parametrize("n,samples_per_dir,depth,skips", [
    (1, 1, 8, (4,)), (63, 7, 8, (4,)), (129, 16, 8, (4,)), (4099, 192, 8, (4,)),
    (GRID_EDGE, 16, 8, (4,)), (4099, 7, 3, (1,))])
def test_int8_kernel_matches_plain_at_every_width(cuda_device, width, n, samples_per_dir, depth,
                                                  skips):
    """K4 at the widths beside 256 (384 and 512: the point's scale from the
    row maxima of both warpgroups' halves), both passes, against its plain
    version within `test_int8_kernel_matches_plain`'s bars; the int8 layer
    inputs that round apart counted; two launches bit-identical."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    if n == GRID_EDGE:
        n = 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 128 + 5
    model = NeRF(NeRFConfig(depth=depth, width=width, skips=skips),
                 generator=torch.Generator().manual_seed(0)).to(cuda_device)
    p8 = k4.pack_nerf_params_int8(model)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    before = dict(k4.LAUNCHES)
    sig = k4.fused_nerf_sigma_int8(p8, xyz)
    full = k4.fused_nerf_full_int8(p8, xyz, d, samples_per_dir)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == {**before, "sigma": before["sigma"] + 1,
                           "full": before["full"] + 1}
    ref = k4.fused_full_int8_ref(p8, xyz, d, samples_per_dir)
    torch.testing.assert_close(full[:, :3], ref[:, :3], atol=2e-2, rtol=0)
    torch.testing.assert_close(full[:, 3:], ref[:, 3:], atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(sig, k4.fused_sigma_int8_ref(p8, xyz), atol=5e-2, rtol=2e-2)
    got_q, ref_q = k4.int8_trunk_inputs(p8, xyz), k4.int8_trunk_inputs_ref(p8, xyz)
    assert got_q.shape == ref_q.shape == (depth, n, width)
    flips = (got_q != ref_q).sum(dim=(1, 2))
    print(f"\n[width={width} n={n}] int8 inputs rounded apart per layer: {flips.tolist()} of "
          f"{n * width} each; full max|d| {(full - ref).abs().amax(0).tolist()}")
    assert int(flips.sum()) <= 1e-3 * got_q.numel() + 1
    assert torch.equal(full, k4.fused_nerf_full_int8(p8, xyz, d, samples_per_dir))


# the wide kernel (csrc/fused_mlp_wide.cu): widths above 512, a width whose
# last column block is 128 (640) and whose direction branch ends in 64 (640)
# or 192 (896) columns, and depths past the resident kernels' 16 layers
WIDE_FIELDS = [(640, 8, (4,)), (896, 3, (1,)), (1024, 8, (4,)), (128, 20, (4,)),
               (256, 24, (4, 13)), (2048, 2, ())]


@pytest.mark.cuda
@pytest.mark.parametrize("width,depth,skips", WIDE_FIELDS)
@pytest.mark.parametrize("n,samples_per_dir", [(1, 1), (129, 7), (GRID_EDGE, 16)])
def test_wide_kernel_matches_plain(cuda_device, width, depth, skips, n, samples_per_dir):
    """K1 and K4 on the wide kernel, both passes, against their plain
    versions (K1 within ATOL / RTOL, K4 within `test_int8_kernel_matches_plain`'s
    bars, its int8 layer inputs that round apart at most 1e-3 of them),
    counted under 'sigma_wide' / 'full_wide'; two launches bit-identical."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4

    if n == GRID_EDGE:
        n = 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 128 + 5
    model = NeRF(NeRFConfig(depth=depth, width=width, skips=skips),
                 generator=torch.Generator().manual_seed(3)).to(cuda_device)
    p16, p8 = fused_mlp.pack_nerf_params(model), k4.pack_nerf_params_int8(model)
    assert not fused_mlp.resident(width, depth) and not k4.resident(p8, True)
    xyz, d = _points(n, -(-n // samples_per_dir))
    xyz, d = xyz.to(cuda_device), d.to(cuda_device)
    for mod, pack, sig_fn, full_fn, sig_ref, full_ref, bars in (
            (fused_mlp, p16, fused_mlp.fused_nerf_sigma, fused_mlp.fused_nerf_full,
             fused_mlp.fused_sigma_ref, fused_mlp.fused_full_ref, None),
            (k4, p8, k4.fused_nerf_sigma_int8, k4.fused_nerf_full_int8,
             k4.fused_sigma_int8_ref, k4.fused_full_int8_ref, (2e-2, 5e-2, 2e-2))):
        before = dict(mod.LAUNCHES)
        sig, full = sig_fn(pack, xyz), full_fn(pack, xyz, d, samples_per_dir)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == {**before, "sigma_wide": before["sigma_wide"] + 1,
                                "full_wide": before["full_wide"] + 1}
        ref = full_ref(pack, xyz, d, samples_per_dir)
        if bars is None:
            torch.testing.assert_close(sig, sig_ref(pack, xyz), atol=ATOL, rtol=RTOL)
            torch.testing.assert_close(full, ref, atol=ATOL, rtol=RTOL)
        else:
            torch.testing.assert_close(full[:, :3], ref[:, :3], atol=bars[0], rtol=0)
            torch.testing.assert_close(full[:, 3:], ref[:, 3:], atol=bars[1], rtol=bars[2])
            torch.testing.assert_close(sig, sig_ref(pack, xyz), atol=bars[1], rtol=bars[2])
        assert torch.equal(full, full_fn(pack, xyz, d, samples_per_dir))
    got_q, ref_q = k4.int8_trunk_inputs(p8, xyz), k4.int8_trunk_inputs_ref(p8, xyz)
    assert got_q.shape == ref_q.shape == (depth, n, width)
    flips = int((got_q != ref_q).sum())
    print(f"\n[width={width} depth={depth} n={n}] int8 inputs rounded apart: {flips} of "
          f"{got_q.numel()}")
    assert flips <= 1e-3 * got_q.numel() + 1


@pytest.mark.cuda
def test_fast_render_on_kernels_matches_plain(cuda_device):
    """render_rays_fast's kernel route on the card (K3 + K1, and K4) against
    the same render on the CPU (plain versions): per output, median |d| <
    2e-3 and 99th percentile < 0.05 (tests/test_proxy_march.py's bars)."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.render.fast import render_rays_fast

    models = {"fine": NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(4))}
    rays = _proxy_rays(300, seed=5)
    proxy_cpu, proxy_gpu = _proxy_pack(96, "cpu"), _proxy_pack(96, cuda_device)
    for pack in (fused_mlp.pack_model_params, k4.pack_model_params_int8):
        kw = dict(n_candidates=32, n_keep=16, select="pdf", white_back=True,
                  scene_aabb=([-2.0] * 3, [2.0] * 3))
        with torch.no_grad():
            ref = render_rays_fast(None, None, rays, packed_params=pack(models, "cpu"),
                                   packed_proxy=proxy_cpu, **kw)
            got = render_rays_fast(None, None, rays.to(cuda_device),
                                   packed_params=pack(models, cuda_device),
                                   packed_proxy=proxy_gpu, **kw)
        for k, v in ref.items():
            err = (got[k].cpu() - v).abs()
            assert float(err.median()) < 2e-3 and float(torch.quantile(err.flatten(), .99)) < .05, k


@pytest.mark.cuda
def test_proxy_and_int8_kernels_reject_what_they_do_not_take(cuda_device):
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3

    pp, rays = _proxy_pack(48, cuda_device), _proxy_rays(8).to(cuda_device)
    with pytest.raises(ValueError, match="rays"):
        k3.proxy_opacity(pp, rays[:, :7].contiguous(), 16)
    with pytest.raises(ValueError, match="candidates"):
        k3.proxy_opacity(pp, rays, 3)
    with pytest.raises(ValueError, match="w1"):
        k3.proxy_opacity({**pp, "w1": pp["w1"].float()}, rays, 16)
    with pytest.raises(ValueError, match="k3_w1t"):
        k3.proxy_march_select({k: v for k, v in pp.items() if k != "k3_w1t"}, rays, 16, 8)
    with pytest.raises(ValueError, match="k3_w1t"):
        k3.proxy_opacity({**pp, "k3_w1t": pp["k3_w1t"][:16].contiguous()}, rays, 16)
    p8 = k4.pack_nerf_params_int8(NeRF(NeRFConfig()).to(cuda_device))
    xyz = torch.zeros((4, 3), device=cuda_device)
    # the widths it takes: every multiple of 128 (640 on the wide kernel); 192 refused
    wide = NeRF(NeRFConfig(depth=3, width=192, skips=(1,))).to(cuda_device)
    with pytest.raises(ValueError, match="width"):
        k4.fused_nerf_sigma_int8(k4.pack_nerf_params_int8(wide), xyz)
    wide = k4.pack_nerf_params_int8(NeRF(NeRFConfig(depth=3, width=640, skips=(1,))).to(
        cuda_device))
    torch.testing.assert_close(k4.fused_nerf_sigma_int8(wide, xyz),
                               k4.fused_sigma_int8_ref(wide, xyz), atol=5e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="q1"):
        k4.fused_nerf_sigma_int8({**p8, "q1": p8["q1"].float()}, xyz)
    before = dict(k4.LAUNCHES)
    with pytest.raises(ValueError, match="k4_stream"):
        k4.fused_nerf_sigma_int8({k: v for k, v in p8.items() if k != "k4_stream"}, xyz)
    with pytest.raises(ValueError, match="k4_stream"):
        k4.fused_nerf_sigma_int8({**p8, "k4_stream": p8["k4_stream"][:-16]}, xyz)
    with pytest.raises(ValueError, match="k4_stream"):
        k4.fused_nerf_full_int8({**p8, "k4_stream": p8["k4_stream"].cpu()}, xyz, xyz)
    assert k4.LAUNCHES == before


# ---- K5 triplane gather -----------------------------------------------------------
# Kernel vs plain: the same float32 steps in the same order (no FMA contraction)
# on the same bf16 or float32 table, so no element may differ. Both against
# F.grid_sample on the float32 copy of the planes: within 1e-5 of the table's
# largest magnitude (F.grid_sample forms its weights in another order).

K5_BOX = 15.0


def _k5_table(c, hw, dtype, device, seed=0):
    from nerf_siren_tpu_torch.render.triplane import pack_planes_for_sampling

    planes = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(1, 3, c, hw, hw)).astype(np.float32))
    return pack_planes_for_sampling(planes, dtype)[0].to(device)


def _k5_points(n, seed=1):
    """Camera points (rays from radius 4 marching 0.1..10), border points
    (within 1.05 of the box's half side) and far out-of-plane points."""
    rng = np.random.default_rng(seed)
    k = n // 3
    d = rng.normal(size=(k, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = np.array([4.0, 0.0, 2.0]) + d * rng.uniform(0.1, 10.0, (k, 1))
    border = rng.uniform(-1.05, 1.05, (k, 3)) * K5_BOX / 2
    far = rng.uniform(-3, 3, (n - 2 * k, 3)) * K5_BOX
    return torch.from_numpy(np.concatenate([cam, border, far]).astype(np.float32))


def test_triplane_gather_wrapper_runs_the_plain_version_on_the_cpu():
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    table, xyz = _k5_table(8, 16, torch.bfloat16, "cpu"), _k5_points(99)
    before = dict(k5.LAUNCHES)
    assert torch.equal(k5.triplane_gather(table, xyz, 2 / K5_BOX),
                       k5.triplane_gather_ref(table, xyz, 2 / K5_BOX))
    assert k5.LAUNCHES == before


@pytest.mark.parametrize("m", [1, 127, 4099])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [1, 6, 8, 12, 32])
def test_triplane_gather_launch_plan_covers_every_output_once(c, dtype, m):
    """K5's grid as the kernel walks it: thread t takes point t // groups
    and channels [(t % groups) vec, + vec) on each of the 3 planes. Every
    output element is written exactly once, no block is idle, the load is
    the widest that divides C, and a warp's stores to one plane are one
    contiguous run of the output."""
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    plan = k5.launch_plan(c, dtype, m)
    elem = 2 if dtype == torch.bfloat16 else 4
    assert plan.vec * elem == plan.load_bytes and plan.vec * plan.groups == c
    assert all(c % (b // elem) for b in k5.LOAD_BYTES if b > plan.load_bytes)
    t = np.arange(plan.blocks * plan.threads)
    point, group = t // plan.groups, t % plan.groups
    live = point < m
    assert live.sum() == m * plan.groups and (~live).sum() < plan.threads
    off = ((np.arange(3)[:, None, None] * m + point[None, :, None]) * c
           + group[None, :, None] * plan.vec + np.arange(plan.vec))   # (plane, thread, vec)
    written = np.bincount(off[:, live].reshape(-1), minlength=3 * m * c)
    assert written.shape == (3 * m * c,) and (written == 1).all()
    for w0 in range(0, int(live.sum()) - 31, 32):            # warps with every lane live
        for p in range(3):
            run = np.sort(off[p, w0:w0 + 32].reshape(-1))
            assert (np.diff(run) == 1).all()


def test_triplane_gather_launch_plan_narrows_the_load_to_the_table_alignment():
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    bf16, f32 = torch.bfloat16, torch.float32
    assert k5.launch_plan(32, bf16, 262_144, 0x7f0000000000)[:4] == (8, 16, 4, 256)
    assert k5.launch_plan(32, bf16, 262_144).blocks == 4096
    assert k5.launch_plan(32, f32, 10)[:3] == (4, 16, 8)
    assert k5.launch_plan(12, bf16, 10)[:3] == (4, 8, 3)
    assert k5.launch_plan(6, f32, 10)[:3] == (2, 8, 3)
    assert k5.launch_plan(32, bf16, 10, table_ptr=8)[:2] == (4, 8)
    assert k5.launch_plan(32, bf16, 10, table_ptr=2)[:2] == (1, 2)
    assert k5.launch_plan(32, f32, 10, table_ptr=4)[:2] == (1, 4)
    with pytest.raises(ValueError, match="exceed one grid"):
        k5.launch_plan(32, bf16, 2**40)


def test_k3_ablation_variants_apply_to_the_kernel_source():
    """Every text edit of the K3 ablation tool still finds its place in
    csrc/proxy_march.cu, and each variant differs from the kernel."""
    from nerf_siren_tpu_torch import k3_ablation
    from nerf_siren_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "proxy_march.cu").read_text()
    found = k3_ablation.variants(src)
    assert found.pop("as built") == src
    assert len(found) == 4 and all(text != src for text in found.values())
    assert "sincosf(" not in found["no sincosf"]
    assert "wgmma_rs<NT>(" not in found["no products"]
    assert "wgmma_rs<8>(" not in found["no products"]
    assert "march_block<EPI>(a" not in found["no march"]
    assert k3_ablation.chunk_rays("cpu").shape == (k3_ablation.CHUNK, 8)
    k6 = k3_ablation.k6_variants(src)
    assert k6.pop("as built") == src
    assert len(k6) == 4 and all(text != src for text in k6.values())
    assert "RANK_P = 1;" in k6["one rank a thread"]
    assert k6["no sincosf"] == found["no sincosf"] and k6["no products"] == found["no products"]
    assert "topk_block(a" not in k6["no top-K"] and "march_block<EPI>(a" in k6["no top-K"]
    assert k3_ablation.chunk_rays("cpu", 1000).shape == (1000, 8)


def test_k5_ablation_variants_apply_to_the_kernel_source():
    """Every text edit of the K5 ablation tool still finds its place in
    csrc/triplane_gather.cu, and each variant differs from the kernel."""
    from nerf_siren_tpu_torch import k5_ablation
    from nerf_siren_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "triplane_gather.cu").read_text()
    found = k5_ablation.variants(src)
    assert found.pop("as built") == src
    assert len(found) == 4 and all(text != src for text in found.values())
    assert "cache_hint" not in found["no load policy"] and "__stcs" not in found["neither hint"]
    assert k5_ablation.chunk_points("cpu").shape == (k5_ablation.CHUNK * k5_ablation.DEPTHS, 3)


def _k5_check_kernel(table, xyz, c):
    import torch.nn.functional as F
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    n = xyz.shape[0]
    before = k5.LAUNCHES["gather"]
    got = k5.triplane_gather(table, xyz, 2 / K5_BOX)
    torch.cuda.synchronize()
    assert k5.LAUNCHES["gather"] == before + 1
    ref = k5.triplane_gather_ref(table, xyz, 2 / K5_BOX)
    assert got.shape == ref.shape == (3, n, c)
    assert int((got != ref).sum()) == 0
    planes = table[:, 1:-1, 1:-1, :].float().permute(0, 3, 1, 2)
    grid = k5.project_to_planes(xyz * (2 / K5_BOX))[:, None]
    lib = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)[:, :, 0].permute(0, 2, 1)
    scale = float(table.float().abs().max())
    assert float((got - lib).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4099, 262_144])
@pytest.mark.parametrize("c,dtype", [(32, torch.bfloat16), (8, torch.bfloat16),
                                     (32, torch.float32), (12, torch.bfloat16),
                                     (6, torch.float32), (1, torch.bfloat16),
                                     (3, torch.float32)])
def test_triplane_gather_kernel_matches_plain(cuda_device, n, c, dtype):
    """Every route: 16-byte loads (C 32, 8 bf16; C 32 f32), 8-byte (C 12
    bf16; C 6 f32), 4-byte (C 3 f32) and 2-byte (C 1 bf16)."""
    table = _k5_table(c, 256 if c == 32 else 64, dtype, cuda_device)
    _k5_check_kernel(table, _k5_points(n).to(cuda_device), c)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,load_bytes", [(1, 2), (2, 4), (4, 8)])
def test_triplane_gather_kernel_on_a_table_off_the_16_byte_grid(cuda_device, shift, load_bytes):
    """A contiguous table that starts `shift` bf16 elements into its
    storage takes the narrower load its address allows."""
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    full = _k5_table(32, 64, torch.bfloat16, cuda_device)
    store = torch.zeros(full.numel() + shift, dtype=torch.bfloat16, device=cuda_device)
    table = store[shift:].view(full.shape)
    table.copy_(full)
    assert table.is_contiguous()
    assert k5.launch_plan(32, table.dtype, 1, table.data_ptr()).load_bytes == load_bytes
    _k5_check_kernel(table, _k5_points(4099).to(cuda_device), 32)


@pytest.mark.cuda
def test_triplane_gather_kernel_rejects_what_it_does_not_take(cuda_device):
    from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5

    table, xyz = _k5_table(8, 16, torch.bfloat16, cuda_device), _k5_points(9).to(cuda_device)
    with pytest.raises(ValueError, match="table"):
        k5.triplane_gather(table.half(), xyz, 0.1)
    with pytest.raises(ValueError, match="table"):
        k5.triplane_gather(table[:2].contiguous(), xyz, 0.1)
    with pytest.raises(ValueError, match="xyz"):
        k5.triplane_gather(table, xyz.double(), 0.1)
    with pytest.raises(ValueError, match="xyz"):
        k5.triplane_gather(table, xyz.t().contiguous().t(), 0.1)
    with pytest.raises(ValueError, match="no backward"):
        k5.triplane_gather(table, xyz.clone().requires_grad_(), 0.1)
    assert k5.triplane_gather(table, xyz[:0], 0.1).shape == (3, 0, 8)


@pytest.mark.cuda
def test_eg3d_render_on_the_kernel_matches_the_gather_route(cuda_device):
    """EG3DSystem.render on the card: the kernel route equals the gather
    route (the same planes, K5 equal to its plain version), and a CPU
    re-render of the card's table within 1e-4 (float32 reductions in
    another order)."""
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    cfg = TriPlaneConfig(z_dim=32, w_dim=32, plane_resolution=32, channel_base=1024,
                         channel_max=32, rendering=RenderingOptions(
                             depth_resolution=16, depth_resolution_importance=16,
                             ray_start=2.0, ray_end=6.0, box_warp=8.0))
    model = EG3DSystem(cfg).init_model(torch.Generator().manual_seed(0)).to(cuda_device)
    d = np.random.default_rng(3).normal(size=(300, 3)) * 0.2
    d[:, 2] = -1.0                         # from z = 4 towards the origin
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to([0.0, 0.0, 4.0], d.shape)
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32)).to(cuda_device)
    kernel, gather = EG3DSystem(cfg, "kernel"), EG3DSystem(cfg, "gather")
    packed = kernel.frame_planes(model)
    got = kernel.render_packed(model, packed, rays, chunk=128)
    want = gather.render_packed(model, packed, rays, chunk=128)
    cpu_model = EG3DSystem(cfg).init_model(torch.Generator().manual_seed(0))
    cpu = gather.render_packed(cpu_model, packed.cpu(), rays.cpu(), chunk=128)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        torch.testing.assert_close(got[k].cpu(), cpu[k], atol=1e-4, rtol=0, msg=k)


# A group's graph and the eager steps run the same kernels and the same
# device-scalar update and read bit-equal on an H100; the bars leave room
# for a last bit that a reduction might order otherwise, three orders below
# a group without its last update (0.17).
GROUP_LOSS_RTOL = 1e-6   # each grouped step's loss against the eager step's
GROUP_CHANGE_GAP = 1e-4  # change_gap of a group's weights against the eager steps'


def change_gap(start, got, want):
    """The largest, over the parameters, of ||(got - start) - (want - start)||
    / ||want - start||: how far the change a run made from `start` lies
    from the change the reference run made, relative to that change."""
    return max(float((g - w).norm() / (w - s).norm().clamp_min(1e-30))
               for s, g, w in zip(start, got, want))


def _param_list(state):
    from nerf_siren_tpu_torch.training.system import parameters

    return [p.detach().clone() for _, _, p in parameters(state.models)]


def _train_system(device, n_samples=64, n_importance=128, perturb=1.0, batch_size=1024,
                  backend="fused"):
    from nerf_siren_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    return NeRFSystem(RenderConfig(n_samples=n_samples, n_importance=n_importance,
                                   perturb=perturb, noise_std=perturb, white_back=True),
                      TrainConfig(lr=5e-4, decay_step=(20,), decay_gamma=0.1,
                                  batch_size=batch_size), NeRFConfig(), 1000, backend, device)


def _copy_state(system, state, device):
    return system.state_for(copy.deepcopy(state.models))


def _synthetic_rays(shape, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn(*shape, 3, generator=g, device=device), dim=-1)
    o = -4.0 * d + 0.3 * torch.randn(*shape, 3, generator=g, device=device)
    near_far = torch.tensor([2.0, 6.0], device=device).expand(*shape, 2)
    return torch.cat([o, d, near_far], -1), torch.rand(*shape, 3, generator=g, device=device)


@pytest.mark.cuda
def test_grouped_fused_steps_on_a_graph_match_eager_steps(cuda_device):
    """Two groups of 7 `fused` steps (1024 rays, 64 + 128 samples, perturb 1,
    noise 1, Adam) as one captured CUDA graph replayed twice, against 14
    eager `train_step`s from the same weights, seed and batches. K2 runs
    inside the graph: each wrapper is called twice a step at capture (and
    twice in the warm-up step before it), never at a replay. Bars: each
    step's loss within a relative GROUP_LOSS_RTOL, and after each group
    every parameter's change within GROUP_CHANGE_GAP of the eager steps'
    (`change_gap`); the eager step runs the same device-scalar update as
    the graph. A control must fail the same bar: a group whose last update
    has lr 0 (the last row of its scalar table)."""
    _grouped_vs_eager(_train_system(cuda_device), cuda_device)


@pytest.mark.cuda
def test_grouped_culled_fused_steps_on_a_graph_match_eager_steps(cuda_device):
    """The same on `culled_fused` (K2 at 1024 rays x 24 points, the proxy
    in the optimizer and in `change_gap`; its proxy loss per step within
    GROUP_LOSS_RTOL of the eager step's too)."""
    _grouped_vs_eager(_train_system(cuda_device, backend="culled_fused"), cuda_device)


def _grouped_vs_eager(system, cuda_device):
    n = 7
    eager = system.init_state(0)
    grouped, control = _copy_state(system, eager, cuda_device), _copy_state(system, eager,
                                                                             cuda_device)
    start = _param_list(eager)
    rays, rgbs = _synthetic_rays((2 * n, 1024), cuda_device)
    want, want_params, want_extra = [], [], []
    for i in range(2 * n):
        eager, m = system.train_step(eager, {"rays": rays[i], "rgbs": rgbs[i]}, seed=7)
        want.append(float(m["train/loss"]))
        want_extra.append([float(m[f"train/{k}_loss"]) for k in system.GROUP_LOSSES])
        if i % n == n - 1:
            want_params.append(_param_list(eager))
    got, got_extra, gaps = [], [], []
    for grp in range(2):
        before = dict(k2.LAUNCHES)
        sl = slice(grp * n, (grp + 1) * n)
        grouped, m = system.train_scan_batches(grouped, rays[sl], rgbs[sl], seed=7)
        launched = {k: k2.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"fwd": 2 * n + 2, "bwd": 2 * n + 2} if grp == 0
                            else {"fwd": 0, "bwd": 0}), launched
        assert float(m["train/loss"]) == float(system.last_group.steps[-1, 0])
        got += system.last_group.steps[:, 0].tolist()
        got_extra += system.last_group.steps[:, 2:].tolist()
        gaps.append(change_gap(start, _param_list(grouped), want_params[grp]))
    assert grouped.step == eager.step == 2 * n
    loss_rel = max(abs(b - a) / abs(a) for a, b in zip(want + sum(want_extra, []),
                                                       got + sum(got_extra, [])))

    table = system.optimizer.scalar_table

    def last_lr_zero(state, k):
        rows = table(state, k)
        rows[-1, 0] = 0.0
        return rows

    system.optimizer.scalar_table = last_lr_zero
    try:
        system.train_scan_batches(control, rays[:n], rgbs[:n], seed=7)
    finally:
        system.optimizer.scalar_table = table
    control_gap = change_gap(start, _param_list(control), want_params[0])
    print(f"grouped vs eager: max relative loss difference {loss_rel:.3e} (bar "
          f"{GROUP_LOSS_RTOL}), change gap after each group {gaps} (bar {GROUP_CHANGE_GAP}), "
          f"the control's {control_gap:.3e}")
    assert loss_rel <= GROUP_LOSS_RTOL, loss_rel
    assert max(gaps) <= GROUP_CHANGE_GAP, gaps
    assert control_gap > GROUP_CHANGE_GAP, control_gap


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pool", "importance"])
def test_pool_groups_on_a_graph_match_their_loop_on_the_card(cuda_device, kind):
    """`train_scan` (perturb 1, noise 1) and `train_scan_importance`
    (perturb 0, noise 0, so that rays drawn twice in a batch write back the
    same error whichever lands) on a pool of 16384 rays, two groups of 5
    steps of 1024 rays: the captured graph, whose gather from the pool (and
    cumulative sum, search and error write-back) runs inside it, against
    the same `StepGroup` body run as a plain loop on the card on the same
    draws. Bars: those of the batches' graph; the second group is a replay
    and calls no K2 wrapper."""
    from nerf_siren_tpu_torch.training.graphs import StepGroup

    n, b, alpha, frac = 5, 1024, 1.0, 0.2
    system = _train_system(cuda_device, 32, 32, 1.0 if kind == "pool" else 0.0, b)
    looped = system.init_state(0)
    grouped = _copy_state(system, looped, cuda_device)
    start = _param_list(looped)
    pool_rays, pool_rgbs = _synthetic_rays((16384,), cuda_device, seed=5)
    pool = {"pool_rays": pool_rays, "pool_rgbs": pool_rgbs}
    run = (system.train_scan if kind == "pool" else
           lambda *a, **kw: system.train_scan_importance(*a, alpha=alpha, uniform_frac=frac,
                                                         **kw))
    loss_rel, gaps = 0.0, []
    for grp in range(2):
        inputs = system.group_inputs(looped, kind, pool, 11, n, b, frac)
        want = StepGroup(system, looped, kind, n, alpha).loop(inputs)[:, 0].tolist()
        system.optimizer.advance(looped.opt_state, n)
        looped.step += n
        before = dict(k2.LAUNCHES)
        grouped, _ = run(grouped, pool_rays, pool_rgbs, 11, n_steps=n, batch_size=b)
        launched = {k: k2.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"fwd": 2 * n + 2, "bwd": 2 * n + 2} if grp == 0
                            else {"fwd": 0, "bwd": 0}), launched
        got = system.last_group.steps[:, 0].tolist()
        loss_rel = max([loss_rel] + [abs(g - w) / abs(w) for g, w in zip(got, want)])
        gaps.append(change_gap(start, _param_list(grouped), _param_list(looped)))
    print(f"{kind}: graph vs loop: max relative loss difference {loss_rel:.3e}, change gap "
          f"after each group {gaps}")
    assert loss_rel <= GROUP_LOSS_RTOL, loss_rel
    assert max(gaps) <= GROUP_CHANGE_GAP, gaps


# ---- the SIREN field and the semantic stack ------------------------------------

def _field_system(device, field):
    """The jnp systems of the SIREN field and of d3 (PointNet, capacity
    8192) at the published widths: 1024 rays, 64 + 128 samples, perturb 1,
    noise 1, Adam."""
    from nerf_siren_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    render = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, noise_std=1.0,
                          white_back=True)
    if field == "d3":
        return NeRF3DSystem(render, TrainConfig(lr=5e-4, decay_step=(20,), batch_size=1024,
                                                loss_type="msenll"),
                            NeRFConfig(), 1000, point_capacity=8192, device=device)
    return NeRFSystem(render, TrainConfig(lr=5e-4, decay_step=(20,), batch_size=1024),
                      NeRFConfig(), 1000, device=device, field_type="siren")


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["d3", "siren"])
def test_grouped_steps_of_d3_and_siren_on_a_graph_match_their_loop(cuda_device, field):
    """Two groups of 5 steps (d3: with class targets) as one captured CUDA
    graph, against the same `StepGroup` body run as a plain loop on the
    card on the same draws. The second group is a replay, run under
    `torch.cuda.set_sync_debug_mode("error")` (a host sync raises). No K2
    wrapper is called (both train the plain field). Bars: the batches'
    graph's; a control group whose last row has lr 0 must fail the change
    gap. d3 with no_grad_on_nerf: the NeRF parameters bit-unchanged in both
    runs, PointNet's moved."""
    import copy

    from nerf_siren_tpu_torch.training.graphs import StepGroup

    n, b = 5, 1024
    system = _field_system(cuda_device, field)
    looped = system.init_state(0)

    def fresh():
        return system.state_for({k: copy.deepcopy(m) for k, m in looped.models.items()})

    grouped, control = fresh(), fresh()
    start = _param_list(looped)
    rays, rgbs = _synthetic_rays((2 * n, b), cuda_device)
    cls = torch.randint(0, 6, (2 * n, b), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(2))
    loss_rel, gaps = 0.0, []
    for grp in range(2):
        sl = slice(grp * n, (grp + 1) * n)
        batch = {"rays": rays[sl], "rgbs": rgbs[sl], **({"cls": cls[sl]} if field == "d3"
                                                        else {})}
        inputs = system.group_inputs(looped, "batches", batch, 11, n, b)
        want = StepGroup(system, looped, "batches", n).loop(inputs)[:, 0].tolist()
        system.optimizer.advance(looped.opt_state, n)
        looped.step += n
        before = dict(k2.LAUNCHES)
        if grp == 0:
            kw = {"cls_b": cls[sl]} if field == "d3" else {}
            grouped, _ = system.train_scan_batches(grouped, rays[sl], rgbs[sl], 11, **kw)
        else:
            inputs = system.group_inputs(grouped, "batches", batch, 11, n, b)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                system.last_group.run(inputs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            system.optimizer.advance(grouped.opt_state, n)
            grouped.step += n
        assert k2.LAUNCHES == before
        got = system.last_group.steps[:, 0].tolist()
        loss_rel = max([loss_rel] + [abs(g - w) / abs(w) for g, w in zip(got, want)])
        gaps.append(change_gap(start, _param_list(grouped), _param_list(looped)))
    table = system.optimizer.scalar_table

    def last_lr_zero(state, k):
        rows = table(state, k)
        rows[-1, 0] = 0.0
        return rows

    system.optimizer.scalar_table = last_lr_zero
    try:
        kw = {"cls_b": cls[:n]} if field == "d3" else {}
        system.train_scan_batches(control, rays[:n], rgbs[:n], 11, **kw)
    finally:
        system.optimizer.scalar_table = table
    once = fresh()
    system.train_scan_batches(once, rays[:n], rgbs[:n], 11, **kw)
    control_gap = change_gap(start, _param_list(control), _param_list(once))
    print(f"{field}: graph vs loop: max relative loss difference {loss_rel:.3e}, change gap "
          f"after each group {gaps}, the control's {control_gap:.3e}")
    assert loss_rel <= GROUP_LOSS_RTOL, loss_rel
    assert max(gaps) <= GROUP_CHANGE_GAP, gaps
    assert control_gap > GROUP_CHANGE_GAP, control_gap
    if field == "d3":
        from nerf_siren_tpu_torch.training.system import parameters

        for state in (looped, grouped):
            keys = [k for k, _, _ in parameters(state.models)]
            same = [torch.equal(a, p) for a, p in zip(start, _param_list(state))]
            assert all(s for k, s in zip(keys, same) if k != "points")
            moved = [not s for k, s in zip(keys, same) if k == "points"]
            assert sum(moved) >= len(moved) // 2, moved


# d3's grouped steps (the masked cloud) against their loop (the valid prefix):
# the d3 cell's `loss_gap` limit (benchmark/workloads/d3_pointnet_blender.
# train.json), whose plain reference runs PointNet on the valid points alone.
# From the same weights the two paths differ by their sums' order alone;
# after an update Adam's first step, lr x sign(g) an element, moves the
# elements whose gradient is round-off by 2 lr (up to 2.9e-6 of the loss
# over 3 steps on an H100); a capped cloud (capacity 8192, another function)
# must fail
D3_LOSS_RTOL = 1e-5


@pytest.mark.cuda
def test_grouped_d3_steps_keep_the_masked_cloud_on_a_graph(cuda_device):
    """A group of 3 d3 steps whose clouds hold every sample (capacity 1024 x
    192, so part of each cloud is padding) as one captured CUDA graph: every
    PointNet call of the capture runs all K slots with the mask (the eager
    pass's host read of the valid count would break the capture), while
    the warm-up step and the same body as a plain loop run the valid prefix
    alone, with no mask. A replay runs under
    `torch.cuda.set_sync_debug_mode("error")`. The graph's losses against
    the loop's: the first (same weights) within GROUP_LOSS_RTOL, every one
    within D3_LOSS_RTOL; the loop of a capped cloud must exceed that."""
    from nerf_siren_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.graphs import StepGroup
    from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem

    n, b = 3, 1024

    def d3_system(capacity):
        return NeRF3DSystem(RenderConfig(n_samples=64, n_importance=128, perturb=1.0,
                                         noise_std=1.0, white_back=True),
                            TrainConfig(lr=5e-4, decay_step=(20,), batch_size=b,
                                        loss_type="msenll"),
                            NeRFConfig(), 1000, point_capacity=capacity, device=cuda_device)

    system, capped_system = d3_system(b * 192), d3_system(8192)
    looped = system.init_state(0)
    grouped, capped = (s.state_for({k: copy.deepcopy(m) for k, m in looped.models.items()})
                       for s in (system, capped_system))
    calls = []

    def record(module, args):
        pts, mask = args
        calls.append((torch.cuda.is_current_stream_capturing(), pts.shape[0],
                      None if mask is None else int(mask.shape[0])))

    rays, rgbs = _synthetic_rays((n, b), cuda_device)
    cls = torch.randint(0, 6, (n, b), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(2))
    batch = {"rays": rays, "rgbs": rgbs, "cls": cls}
    inputs = capped_system.group_inputs(capped, "batches", batch, 11, n, b)
    other = StepGroup(capped_system, capped, "batches", n).loop(inputs)[:, 0].tolist()
    inputs = system.group_inputs(looped, "batches", batch, 11, n, b)
    hook = looped.models["points"].register_forward_pre_hook(record)
    want = StepGroup(system, looped, "batches", n).loop(inputs)[:, 0].tolist()
    hook.remove()
    hook = grouped.models["points"].register_forward_pre_hook(record)
    grouped, _ = system.train_scan_batches(grouped, rays, rgbs, 11, cls_b=cls)
    hook.remove()
    got = system.last_group.steps[:, 0].tolist()
    loop_calls, warm_calls, graph_calls = calls[:2 * n], calls[2 * n:2 * n + 2], calls[2 * n + 2:]
    slots = [b * 64, b * 192]                 # K of the coarse and the fine cloud
    assert [c[0] for c in calls] == [False] * (2 * n + 2) + [True] * (2 * n)
    assert all(mask is None and 0 < rows < k for (_, rows, mask), k
               in zip(loop_calls + warm_calls, slots * (n + 1)))
    assert [(rows, mask) for _, rows, mask in graph_calls] == [(k, k) for k in slots * n]
    inputs = system.group_inputs(grouped, "batches", batch, 11, n, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        system.last_group.run(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loss_rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    capped_rel = abs(other[0] - want[0]) / abs(want[0])
    print(f"d3, every sample in the cloud: graph (masked) vs loop (valid prefix): relative loss "
          f"difference by step {[f'{v:.3e}' for v in loss_rel]}; a capped cloud's first step "
          f"{capped_rel:.3e}; the loop's PointNet rows {[c[1] for c in loop_calls]} of {slots}")
    assert loss_rel[0] <= GROUP_LOSS_RTOL, loss_rel
    assert max(loss_rel) <= D3_LOSS_RTOL, loss_rel
    assert capped_rel > D3_LOSS_RTOL, capped_rel


# class ids of a d3 fast tile on the kernels must equal the plain versions'
# wherever the plain top-two margin of the composited log-probabilities
# exceeds this (chip_smoke.py phase 20's bar: on an H100 the ids of its
# 800² frame differed at 13 pixels, the largest margin among them 0.042)
CLS_MARGIN = 0.1


@pytest.mark.cuda
def test_d3_fast_tile_on_the_kernels_matches_the_plain_versions(cuda_device, monkeypatch):
    """One 2048-ray d3 fast tile (`eval.make_semantic_renderer`, C 32, K 16,
    capacity 8192, threshold 0) on K3 select and K1 against the same tile
    with both replaced by their plain versions on the card: class ids equal
    wherever the plain top-two margin exceeds CLS_MARGIN, rgb within the
    fast path's bars (median < 2e-3, 99th percentile < 0.05)."""
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import FastSetup, get_opts, make_semantic_renderer
    from nerf_siren_tpu_torch.models.pointnet import PointNetDenseCls
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.render import fast as fast_mod

    models = {"fine": NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(4)),
              "points": PointNetDenseCls(6, 6, generator=torch.Generator().manual_seed(5))}
    models = {k: m.to(cuda_device) for k, m in models.items()}
    rays = _proxy_rays(2048, seed=5).to(cuda_device)
    hp = get_opts(["--root_dir", ".", "--ckpt_path", "x", "--renderer", "fast", "--mode", "d3",
                   "--cls_threshold", "0", "--chunk", "2048"])
    aabb = (np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32))
    fast = FastSetup("fine", None, aabb, fused_mlp.pack_model_params(
        {"fine": models["fine"]}, cuda_device), _proxy_pack(96, cuda_device))
    render = make_semantic_renderer(models, RenderConfig(chunk=2048, test_time=True),
                                    renderer="fast", n_classes=6, cls_threshold=0.0, fast=fast,
                                    hparams=hp)
    before = dict(k3.LAUNCHES), dict(fused_mlp.LAUNCHES)
    with torch.no_grad():
        got = render(rays)
        assert k3.LAUNCHES["select"] == before[0]["select"] + 1
        assert fused_mlp.LAUNCHES["full"] == before[1]["full"] + 1
        monkeypatch.setattr(fast_mod, "proxy_march_select", k3.proxy_march_select_ref)
        monkeypatch.setattr(fast_mod, "field_kernels",
                            lambda packed: (fused_mlp.fused_sigma_ref, fused_mlp.fused_full_ref))
        ref = render(rays)
    top = ref["cls_fine"].topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    diff = got["cls_fine"].argmax(-1) != ref["cls_fine"].argmax(-1)
    print(f"d3 fast tile: class ids differ at {int(diff.sum())} of 2048 rays, the largest "
          f"plain margin among them {float(margin[diff].max()) if diff.any() else 0.0:.3e}")
    assert not bool((diff & (margin > CLS_MARGIN)).any())
    err = (got["rgb_fine"] - ref["rgb_fine"]).abs()
    assert float(err.median()) < 2e-3 and float(torch.quantile(err.flatten(), .99)) < .05


def _box_rays(n, seed):
    """Rays from radius 4 towards the origin, spread so that about half of
    them miss a box of half side 0.6 (near 2, far 6)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.normal(size=(n, 3)) * 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.tensor(np.concatenate([o, d, np.full((n, 2), (2.0, 6.0))], -1),
                        dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["--fast_adaptive", "0.1", "32"]],
                         ids=["defaults", "adaptive"])
def test_fast_frame_makes_no_host_synchronisation(cuda_device, flags, monkeypatch):
    """A frame of three 32,768-ray tiles through `eval.make_fast_renderer`
    at the CLI's defaults (C 32, K 16, K3 and K1), and with
    `--fast_adaptive`, after a warm-up frame, runs under
    `torch.cuda.set_sync_debug_mode("error")` (a host sync raises) with
    tracing on: the box is read on the card in every tile
    (`fast.box_resident` 3, no `fast.box_copies`), and the frame equals,
    bit for bit, the one whose tiles are handed the host box."""
    from nerf_siren_tpu_torch import eval as port_eval
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.utils import tracing

    hp = port_eval.get_opts(["--root_dir", ".", "--ckpt_path", "x", "--renderer", "fast",
                             *flags])
    models = {"fine": NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(4)).to(
        cuda_device)}
    aabb = (np.full(3, -0.6, np.float32), np.full(3, 0.6, np.float32))
    fast = port_eval.FastSetup("fine", None, aabb,
                               fused_mlp.pack_model_params(models, cuda_device),
                               _proxy_pack(96, cuda_device))
    cfg = RenderConfig(chunk=hp.chunk, test_time=True)
    rays = _box_rays(2 * hp.chunk + 4321, seed=6).to(cuda_device)
    render = port_eval.make_fast_renderer(models, cfg, fast, hp)
    with torch.no_grad():
        render(rays)   # warm-up: builds and loads the kernels
        torch.cuda.synchronize()
        tracing.reset()
        tracing.enable()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = render(rays)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.disable()
        counts = tracing.counters()
        tracing.reset()
        monkeypatch.setattr(port_eval, "fast_box", lambda ms, setup: setup.aabb)
        want = port_eval.make_fast_renderer(models, cfg, fast, hp)(rays)
    assert counts["fast.box_resident"] == 3 and "fast.box_copies" not in counts
    assert 0 < counts["fast.rays_in_box"] < rays.shape[0]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- EG3D training and the fast EG3D renderer ------------------------------------

def _eg3d_cfg():
    """A narrowed EG3D renderer (planes 64² x 3 x 32, channel_base 4096,
    channel_max 128, z 64, 32 + 32 samples) at the CLI's ray range and box."""
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig

    return TriPlaneConfig(z_dim=64, w_dim=64, plane_resolution=64, channel_base=4096,
                          channel_max=128, rendering=RenderingOptions(
                              depth_resolution=32, depth_resolution_importance=32,
                              white_back=True))


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms within the test (warnings only
    where cuBLAS's workspace is unset: one stream's GEMMs repeat anyway)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*deterministic.*")
        yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_grouped_eg3d_steps_on_a_graph_match_their_loop(cuda_device, deterministic):
    """Two groups of 5 EG3D steps (512 rays, Adam with weight decay, so the
    buffers move too) as one captured CUDA graph, against the same
    `StepGroup` body run as a plain loop on the card on the same draws; the
    second group is a replay under `torch.cuda.set_sync_debug_mode("error")`
    (a host sync raises). Under `torch.use_deterministic_algorithms`: the
    default algorithms' atomics (cuDNN weight gradients, the plain gather's
    scatter-add) make even two loops differ (chip_smoke.py phase 21 prints
    that spread). Bars: the batches' graph's, over every optimized tensor,
    `w_avg` included."""
    import copy

    from nerf_siren_tpu_torch.config import TrainConfig
    from nerf_siren_tpu_torch.training.eg3d_system import MODEL, EG3DSystem
    from nerf_siren_tpu_torch.training.graphs import StepGroup
    from nerf_siren_tpu_torch.training.system import parameters

    n, b = 5, 512
    system = EG3DSystem(_eg3d_cfg(), train_cfg=TrainConfig(lr=5e-4, weight_decay=1e-4),
                        device=cuda_device)
    looped = system.init_state(0)
    grouped = system.state_for({MODEL: copy.deepcopy(looped.models[MODEL])})
    start = _param_list(looped)
    rays, rgbs = _synthetic_rays((2 * n, b), cuda_device)
    loss_rel, gaps = 0.0, []
    for grp in range(2):
        sl = slice(grp * n, (grp + 1) * n)
        batch = {"rays": rays[sl], "rgbs": rgbs[sl]}
        inputs = system.group_inputs(looped, "batches", batch, 11, n, b)
        want = StepGroup(system, looped, "batches", n).loop(inputs)[:, 0].tolist()
        system.optimizer.advance(looped.opt_state, n)
        looped.step += n
        if grp == 0:
            grouped, _ = system.train_scan_batches(grouped, rays[sl], rgbs[sl], 11)
        else:
            inputs = system.group_inputs(grouped, "batches", batch, 11, n, b)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                system.last_group.run(inputs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            system.optimizer.advance(grouped.opt_state, n)
            grouped.step += n
        got = system.last_group.steps[:, 0].tolist()
        loss_rel = max([loss_rel] + [abs(g - w) / abs(w) for g, w in zip(got, want)])
        gaps.append(change_gap(start, _param_list(grouped), _param_list(looped)))
    w_avg = [i for i, (_, name, _) in enumerate(parameters(looped.models))
             if name.endswith("w_avg")]
    w_gap = change_gap([start[i] for i in w_avg], [_param_list(grouped)[i] for i in w_avg],
                       [_param_list(looped)[i] for i in w_avg])
    names = [name for _, name, _ in parameters(looped.models)]
    now_g, now_l = _param_list(grouped), _param_list(looped)
    worst = max(range(len(start)), key=lambda i: float(
        (now_g[i] - now_l[i]).norm() / (now_l[i] - start[i]).norm().clamp_min(1e-30)))
    print(f"eg3d: graph vs loop: max relative loss difference {loss_rel:.3e}, change gap "
          f"after each group {gaps} (largest at {names[worst]}), w_avg's {w_gap:.3e}")
    assert loss_rel <= GROUP_LOSS_RTOL, loss_rel
    assert max(gaps) <= GROUP_CHANGE_GAP and w_gap <= GROUP_CHANGE_GAP, (gaps, w_gap)


@pytest.mark.cuda
def test_fast_eg3d_tile_on_k3_matches_the_plain_version(cuda_device, monkeypatch):
    """One 4096-ray fast EG3D tile (C 32, K 16, mid, delta) on K3 select
    against the same tile with K3 select's plain version on the card, within
    chip_smoke.py phase 22's bars: rgb median < 2e-3 and 99th percentile <
    5e-2 of max(1, max|ref|); depth median < 5e-3 and 99th percentile < 5e-2
    of each ray's far - near; opacity median < 2e-3, max < 5e-2."""
    from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
    from nerf_siren_tpu_torch.render import triplane_fast as tf
    from nerf_siren_tpu_torch.render.fast import init_proxy
    from nerf_siren_tpu_torch.render.triplane import EG3DRenderer

    cfg = _eg3d_cfg()
    model = EG3DRenderer(cfg, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    proxy = init_proxy(96, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    render = tf.make_fast_eg3d_renderer(model, cfg, proxy=proxy)
    rays = _proxy_rays(4096, seed=6).to(cuda_device)
    before = k3.LAUNCHES["select"]
    got = render(rays)
    assert k3.LAUNCHES["select"] == before + 1
    monkeypatch.setattr(tf, "proxy_march_select", k3.proxy_march_select_ref)
    ref = render(rays)
    assert k3.LAUNCHES["select"] == before + 1
    rays8 = tf.fast_rays8(rays, cfg.rendering)
    span = (rays8[:, 7] - rays8[:, 6]).clamp_min(1e-6)
    d_rgb = ((got["rgb_fine"] - ref["rgb_fine"]).abs()
             / max(1.0, float(ref["rgb_fine"].abs().max()))).flatten()
    d_z = (got["depth_fine"] - ref["depth_fine"]).abs() / span
    d_o = (got["opacity_fine"] - ref["opacity_fine"]).abs()
    print(f"fast EG3D tile: rgb {float(d_rgb.median()):.3e} / {float(d_rgb.quantile(.99)):.3e}, "
          f"depth {float(d_z.median()):.3e} / {float(d_z.quantile(.99)):.3e}, opacity "
          f"{float(d_o.median()):.3e} / {float(d_o.max()):.3e}")
    assert float(d_rgb.median()) < 2e-3 and float(d_rgb.quantile(.99)) < 5e-2
    assert float(d_z.median()) < 5e-3 and float(d_z.quantile(.99)) < 5e-2
    assert float(d_o.median()) < 2e-3 and float(d_o.max()) < 5e-2
