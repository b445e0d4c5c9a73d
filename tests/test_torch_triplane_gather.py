"""The triplane gather K5 (`nerf_siren_tpu_torch/ops/kernels/triplane_gather.py`,
`render/triplane.py::make_kernel_plane_sampler`) on the CPU, where its
wrapper runs the plain version: against the JAX package's jnp sampler
(`sample_from_packed_planes`) and its Pallas sampler
(`make_kernel_plane_sampler`, `ops/pallas/triplane_gather.py`, run in
interpret mode with small tiles, as tests/test_triplane_gather.py runs it),
on camera points, points around the plane borders and incoherent points,
on the same planes. The kernel itself is held to this plain version on the
card (tests/test_torch_kernels.py, chip_smoke.py).

Tolerances:
- SAMPLE_TOL 1e-5 of the table's largest magnitude against the jnp
  sampler (f32 and bf16 tables), against the Pallas sampler on an f32
  table, and against `F.grid_sample` on the f32 copy of a bf16 table;
- on a bf16 table the Pallas kernel rounds its bilinear y-weights to bf16
  (its one-hot y-matmul takes operands of the table's type), a TPU layout
  detail that is not K5's contract: those points agree within 2^-9 of the
  table's largest magnitude (a bf16 rounding of weights that sum to 1);
  the points it re-samples through its jnp fallback agree within
  SAMPLE_TOL;
- `importance_render` through the samplers, f32 table: 1e-4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5
from nerf_siren_tpu_torch.render import triplane as T

SAMPLE_TOL = 1e-5
RENDER_TOL = 1e-4
BOX = 8.0
R, S = 64, 16                       # rays x samples of the point sets
TILES = dict(rb=8, sb=4, tile_h=16, tile_px=16, miss_cap_frac=1.0)


def planes_np(c=32, hw=32, seed=0):
    return np.random.default_rng(seed).normal(size=(1, 3, c, hw, hw)).astype(np.float32)


def points(kind, seed=1):
    """(1, R*S, 3) ray-major points."""
    rng = np.random.default_rng(seed)
    if kind == "camera":   # an 8x8 frame of rays marching S depths
        side = int(np.sqrt(R))
        ii, jj = np.meshgrid(np.arange(side), np.arange(side))
        d = np.stack([(ii.reshape(-1) - side / 2) / 40.0, (jj.reshape(-1) - side / 2) / 40.0,
                      -np.ones(R)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        tt = np.linspace(0.5, 4.5, S)
        pts = np.array([0, 0, 2.5]) + d[:, None, :] * tt[None, :, None]
    elif kind == "border":   # within 1.05 of the box's half side: edges and beyond
        pts = rng.uniform(-1.05, 1.05, (R * S, 3)) * BOX / 2
    else:                    # incoherent: no two neighbours close
        pts = rng.uniform(-4, 4, (R * S, 3))
    return pts.reshape(1, R * S, 3).astype(np.float32)


def scaled_err(got, want, table):
    """max |got - want| over the table's largest magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max()) / float(table.float().abs().max())


def tables(dtype, c=32, hw=32):
    p = planes_np(c, hw)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (T.pack_planes_for_sampling(torch.from_numpy(p), dtype),
            J.pack_planes_for_sampling(jnp.asarray(p), jd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["camera", "border", "incoherent"])
@pytest.mark.parametrize("c", [8, 32])
def test_plain_version_matches_jax_jnp_sampler(dtype, kind, c):
    tp, jp = tables(dtype, c, 16)
    pts = points(kind)
    got = k5.triplane_gather_ref(tp[0], torch.from_numpy(pts[0]), 2.0 / BOX)
    assert got.shape == (3, R * S, c) and got.dtype == torch.float32
    want = jax.jit(J.sample_from_packed_planes, static_argnums=2)(jp, jnp.asarray(pts), BOX)
    assert scaled_err(got[None], want, tp) <= SAMPLE_TOL
    # the route --plane_sampler gather takes is the same function
    assert torch.equal(T.sample_from_packed_planes(tp, torch.from_numpy(pts), BOX)[0], got)


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "camera"), (torch.bfloat16, "camera"),
                                        (torch.float32, "incoherent")])
def test_kernel_sampler_matches_jax_pallas_sampler(dtype, kind):
    """JAX's Pallas sampler (interpret mode, jitted) on the same table.
    Camera points stay inside their tiles (tests/test_triplane_gather.py
    counts 0 missed groups for these points and tiles); on the bf16 table
    its bf16 y-weights set them apart from the jnp path, so a nonzero gap
    shows that its kernel ran. Incoherent points leave their tiles and are
    re-sampled by its jnp fallback, which the port equals."""
    tp, jp = tables(dtype)
    pts = points(kind)
    want = jax.jit(lambda jp, x: J.make_kernel_plane_sampler(jp, BOX, R, S, **TILES)(x))(
        jp, jnp.asarray(pts))
    with torch.no_grad():
        got = T.make_kernel_plane_sampler(tp, BOX)(torch.from_numpy(pts))
    err = scaled_err(got, want, tp)
    if kind == "camera" and dtype == torch.bfloat16:
        assert 0.0 < err <= 2.0 ** -9, err
    else:
        assert err <= SAMPLE_TOL, err


def test_wrapper_on_the_cpu_runs_the_plain_version_without_launching():
    tp, _ = tables(torch.bfloat16, 8, 16)
    xyz = torch.from_numpy(points("border")[0])
    before = dict(k5.LAUNCHES)
    got = k5.triplane_gather(tp[0], xyz, 0.25)
    assert torch.equal(got, k5.triplane_gather_ref(tp[0], xyz, 0.25))
    assert k5.LAUNCHES == before
    assert k5.triplane_gather(tp[0], xyz[:0], 0.25).shape == (3, 0, 8)


def test_wrapper_refuses_inputs_that_need_a_gradient():
    tp, _ = tables(torch.float32, 8, 16)
    xyz = torch.from_numpy(points("camera")[0]).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        k5.triplane_gather(tp[0], xyz, 0.25)
    with torch.no_grad():
        k5.triplane_gather(tp[0], xyz, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        k5.triplane_gather(tp[0].to("meta"), xyz.detach().to("meta"), 0.25)


def test_sampler_takes_one_frame_of_three_planes():
    tp, _ = tables(torch.float32, 8, 16)
    with pytest.raises(ValueError, match="table"):
        T.make_kernel_plane_sampler(torch.cat([tp, tp]), BOX)


def test_plain_version_matches_f_grid_sample_on_the_bf16_planes():
    """F.grid_sample on the f32 copy of the bf16 planes (the library call
    chip_smoke.py times beside K5) computes the same function."""
    tp, _ = tables(torch.bfloat16, 32, 16)
    xyz = torch.from_numpy(points("border")[0])
    got = k5.triplane_gather_ref(tp[0], xyz, 2.0 / BOX)
    planes = tp[0, :, 1:-1, 1:-1, :].float().permute(0, 3, 1, 2)        # (3, C, H, W)
    grid = k5.project_to_planes(xyz * (2.0 / BOX))[:, None]              # (3, 1, M, 2)
    lib = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)[:, :, 0].permute(0, 2, 1)   # (3, M, C)
    assert scaled_err(got, lib, tp) <= SAMPLE_TOL


def test_importance_render_through_the_samplers_matches_jax():
    """The coarse + fine render with the K5 sampler (its plain version
    here) against JAX's render with its Pallas sampler, f32 table."""
    tp, jp = tables(torch.float32)
    rng = np.random.default_rng(3)
    dec = {"fc1": {"weight": rng.standard_normal((64, 32)).astype(np.float32),
                   "bias": np.zeros(64, np.float32)},
           "fc2": {"weight": rng.standard_normal((4, 64)).astype(np.float32),
                   "bias": np.full(4, 0.5, np.float32)}}
    side = 8
    ii, jj = np.meshgrid(np.arange(side), np.arange(side))
    d = np.stack([(ii.reshape(-1) - side / 2) / 40.0, (jj.reshape(-1) - side / 2) / 40.0,
                  -np.ones(R)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([0, 0, 2.5], np.float32), d.shape).copy()
    kw = dict(depth_resolution=16, depth_resolution_importance=16, ray_start=0.5,
              ray_end=4.5, box_warp=BOX)
    want = jax.jit(lambda jp, dec, o, d: J.importance_render(
        jp, dec, o, d, J.RenderingOptions(**kw), packed=True,
        sampler=J.make_kernel_plane_sampler(jp, BOX, R, **TILES)))(
        jp, dec, jnp.asarray(o)[None], jnp.asarray(d)[None])
    decoder = T.OSGDecoder(32)
    decoder.load_state_dict({f"{k}.{n}": torch.from_numpy(v) for k, p in dec.items()
                             for n, v in p.items()})
    with torch.no_grad():
        got = T.importance_render(tp, decoder, torch.from_numpy(o)[None],
                                  torch.from_numpy(d)[None], T.RenderingOptions(**kw),
                                  packed=True, sampler=T.make_kernel_plane_sampler(tp, BOX))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=RENDER_TOL, rtol=0)
