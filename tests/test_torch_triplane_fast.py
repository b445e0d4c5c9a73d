"""The port's fast EG3D renderer (`render/triplane_fast.py`, `python -m
nerf_siren_tpu_torch.eval_eg3d --renderer fast`) against the JAX
package's, on the CPU: the port on K3's plain version, JAX on its Pallas
kernel in interpret mode with the ray tile shrunk to 128 on both sides
(256-ray calls are two whole tiles; `test_depth_clip_matches_jax_where_
jax_pads` renders 200), the TINY triplane config of tests/test_triplane_fast.py
(planes 16^2 x 8, box_warp 4, ray_start 'auto') and numpy-drawn weights.
Both renderers take one proxy that JAX distilled (`proxy=`), since the
two packages' random streams differ; the CLIs take it through their
`distill_proxy`.

Tolerances (tests/test_torch_fast_render.py's render bars, per output of
scale max(1, max |ref|)): median |d| < 2e-3 and 99th percentile < 0.05;
the `ratio` quadrature median < 5e-3 and 95% within 0.05. bf16 proxy
operands with float32 sums in another order move the proxy's scores, and
with them the CDF and the survivors, by O(eps); `ratio` takes the landing
bin's density, which jumps where a depth crosses a bin edge. The port's
auto-cull renderer against its plain renderer on the same rays: each ray
bit-equal to the plain frame's or culled to background, a culled ray
empty in the plain frame (opacity < 1e-5); the dense bypass bit-equal.
"""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu.render import triplane_fast as JF
from nerf_siren_tpu.training.checkpoints import save_checkpoint
from nerf_siren_tpu_torch.convert import eg3d_from_jax
from nerf_siren_tpu_torch.render import triplane as T
from nerf_siren_tpu_torch.render import triplane_fast as TF
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_eg3d_eval import CFG as CLI_CFG, OPTS as CLI_OPTS, TINY_FLAGS
from tests.test_torch_fast_render import close
from tests.test_torch_proxy_march import port_proxy
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_stylegan2 import numpy_eg3d_tree

TINY = dict(z_dim=32, w_dim=32, plane_resolution=16, plane_channels=8, mapping_layers=2,
            channel_base=512, channel_max=32)
OPTS = dict(depth_resolution=24, depth_resolution_importance=16, ray_start="auto",
            ray_end=10.0, box_warp=4.0)
FAST = dict(n_candidates=16, n_keep=8)
JAX_TILE = 128


@pytest.fixture(scope="module", autouse=True)
def small_tiles():
    """JAX's tile at 128 (keeps interpreter-mode runs fast), and the port's
    at the same: the port adds 0 to its depth clip where JAX's call pads.
    JAX's proxy march reads TILE_R when it traces, so its jit caches are
    cleared on both sides: an executable another module traced at another
    tile (256 in several) would lay out its points for that tile."""
    old = jpm.TILE_R, TF.TILE_R
    jpm.TILE_R = TF.TILE_R = JAX_TILE
    jax.clear_caches()
    yield
    jpm.TILE_R, TF.TILE_R = old
    jax.clear_caches()


def camera_rays(n_side: int, n_miss: int = 0):
    """tests/test_triplane_fast.py's rays: n_side^2 from z = -4 through the
    box, then n_miss that miss it."""
    lin = np.linspace(-0.35, 0.35, n_side, dtype=np.float32)
    dx, dy = np.meshgrid(lin, lin)
    d = np.stack([dx.ravel(), dy.ravel(), np.ones(n_side * n_side, np.float32)], axis=1)
    o = np.zeros_like(d)
    o[:, 2] = -4.0
    miss_d = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (n_miss, 1))
    miss_o = np.tile(np.asarray([[0.0, 10.0, -4.0]], np.float32), (n_miss, 1))
    return np.concatenate([np.concatenate([o, d], 1), np.concatenate([miss_o, miss_d], 1)])


def port_model(tree, cfg):
    model = T.EG3DRenderer(cfg)
    model.load_state_dict(eg3d_from_jax(tree))
    return model


@pytest.fixture(scope="module")
def scene():
    """The JAX tree, both configs, the port's model and a proxy JAX distilled."""
    jcfg = J.TriPlaneConfig(**TINY, rendering=J.RenderingOptions(**OPTS))
    cfg = T.TriPlaneConfig(**TINY, rendering=T.RenderingOptions(**OPTS))
    tree = numpy_eg3d_tree(jcfg, seed=3)
    planes = jax.jit(lambda p: J.triplane_planes(p, jcfg, J.triplane_mapping(p, jcfg, p["z"])))(
        tree)
    half = 0.5 * OPTS["box_warp"]
    proxy = jfast.distill_proxy(JF.triplane_sigma_fn(planes, tree["decoder"], OPTS["box_warp"]),
                                [-half] * 3, [half] * 3, jax.random.PRNGKey(7), steps=30,
                                batch=2048)
    proxy = jax.tree_util.tree_map(np.asarray, proxy)
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, model=port_model(tree, cfg), proxy=proxy,
                planes=planes)


def test_sigma_fn_matches_jax(scene):
    tree, planes = scene["tree"], scene["planes"]
    pts = np.random.default_rng(1).uniform(-2.2, 2.2, (500, 3)).astype(np.float32)
    want = JF.triplane_sigma_fn(planes, tree["decoder"], 4.0)(jnp.asarray(pts))
    model = scene["model"]
    with torch.no_grad():
        got = TF.triplane_sigma_fn(model.planes(model.mapping(model.z)), model.decoder,
                                   4.0)(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4 * float(
        np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("quadrature,placement", [("delta", "mid"), ("delta", "edges"),
                                                  ("ratio", "mid")])
def test_fast_frame_on_a_shared_proxy_matches_jax(scene, quadrature, placement):
    """248 rays through the box and 8 that miss it, on float32 tables."""
    kw = dict(FAST, quadrature=quadrature, placement=placement)
    rays = camera_rays(16 - 1, n_miss=256 - 15 * 15)
    want = JF.make_fast_eg3d_renderer(scene["tree"], scene["jcfg"], proxy=scene["proxy"],
                                      table_dtype=jnp.float32, **kw)(jnp.asarray(rays))
    render = TF.make_fast_eg3d_renderer(scene["model"], scene["cfg"],
                                        proxy=port_proxy(scene["proxy"]),
                                        table_dtype=torch.float32, **kw)
    got = render(torch.from_numpy(rays))
    assert set(got) == set(want)
    close(got, want, kw, ratio=quadrature == "ratio")
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    assert float(got["opacity_fine"][-8:].abs().max()) < 1e-5   # the misses composite nothing


def test_fast_renderer_distils_its_own_proxy(scene):
    """Without `proxy=` the renderer distils one from its generator; the
    frame agrees broadly with the exact render (JAX's plumbing bar, > 22 dB
    on this smooth random scene)."""
    model, cfg = scene["model"], scene["cfg"]
    render = TF.make_fast_eg3d_renderer(model, cfg, distill_steps=30, distill_batch=2048,
                                        generator=torch.Generator().manual_seed(7),
                                        table_dtype=torch.float32, **FAST)
    rays = torch.from_numpy(camera_rays(16))
    fast = render(rays)
    with torch.no_grad():
        exact = T.eg3d_render(model, rays[:, :3], rays[:, 3:6])
    mse = float(((fast["rgb_fine"] - exact["rgb_fine"]) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-12)) > 22.0
    assert render.proxy.l1.weight.shape == (96, 33)


def _sparse(n_miss_blocks, block=32, n_side=16):
    """n_side^2 camera rays, then n_miss_blocks blocks of rays that miss."""
    return torch.from_numpy(camera_rays(n_side, n_miss=n_miss_blocks * block))


def test_auto_cull_equals_the_plain_frame_and_takes_the_dense_bypass(scene, monkeypatch):
    """Blocks of 32 rays, a TILE_R of 32 (quanta of one block): a frame of 8
    camera blocks and 8 miss blocks renders every block first, then culls
    the miss blocks. The next frame, dense (16 camera blocks), still has the
    sparse frame's budget: it culls visible blocks (the temporal scheme's
    transition frame, as JAX's), measures the dense budget, and the frames
    after it take the bypass, bit-equal to the plain renderer."""
    monkeypatch.setattr(TF, "TILE_R", 32)
    model, cfg = scene["model"], scene["cfg"]
    proxy = port_proxy(scene["proxy"])
    kw = dict(FAST, proxy=proxy, table_dtype=torch.float32)
    plain = TF.make_fast_eg3d_renderer(model, cfg, **kw)
    auto = TF.make_fast_eg3d_renderer(model, cfg, cull="auto", block=32, **kw)
    sparse, dense = _sparse(8), torch.from_numpy(camera_rays(16, n_miss=0))
    dense = torch.cat([dense, dense.flip(0)])   # 16 blocks, all through the box
    trace = []
    for i, rays in enumerate((sparse, sparse, dense, dense, dense)):
        ref, out = plain(rays), auto(rays)
        trace.append((auto.last_active_frac, auto.last_plain))
        same = torch.ones(rays.shape[0], dtype=torch.bool)
        for k in ref:
            d = (out[k] - ref[k]).abs()
            same &= (d.amax(-1) if d.dim() == 2 else d) == 0
        bg = ((out["rgb_fine"] == 0).all(-1) & (out["depth_fine"] == 0)
              & (out["opacity_fine"] == 0))
        assert bool((same | bg).all()), i
        if i != 2:   # a culled ray was empty in the plain frame
            assert float(ref["opacity_fine"][~same].abs().max() if (~same).any() else 0.0) < 1e-5
        if auto.last_plain:
            assert bool(same.all()), i
    assert trace[0] == (1.0, False)
    assert trace[1] == (10 / 16, False), trace   # 8 blocks x margin 1.2, whole quanta
    assert trace[2] == (10 / 16, False), trace   # the transition frame
    assert trace[3] == trace[4] == (1.0, True), trace   # dense: the bypass


def test_auto_cull_first_frames_match_jax_on_the_fog_scene(scene, monkeypatch):
    """JAX's own auto-cull test on the dense random scene, held against
    JAX's auto-cull renderer: its first frame (every ray) and its bypass
    frame, on the same block quanta (TILE_R 128 on both sides)."""
    monkeypatch.setattr(TF, "TILE_R", JAX_TILE)
    kw = dict(FAST, proxy=scene["proxy"])
    rays = camera_rays(16, n_miss=0)
    jauto = JF.make_fast_eg3d_renderer(scene["tree"], scene["jcfg"], cull="auto",
                                       table_dtype=jnp.float32, **kw)
    auto = TF.make_fast_eg3d_renderer(scene["model"], scene["cfg"], cull="auto",
                                      table_dtype=torch.float32,
                                      **dict(kw, proxy=port_proxy(scene["proxy"])))
    for frame in range(2):
        want = jauto(jnp.asarray(rays))
        got = auto(torch.from_numpy(rays))
        close(got, want, f"frame {frame}")
        assert (auto.last_active_frac, auto.last_plain) == (jauto.last_active_frac,
                                                           jauto.last_plain), frame


def test_depth_clip_matches_jax_where_jax_pads(scene, monkeypatch):
    """200 rays (196 through the box, 4 that miss it) with the tile at 128 on
    both sides, so JAX pads every call with 56 zero rays, whose depths pull
    its clip's floor to 0: the plain renderer, and the auto-cull renderer's
    first frame (culled, every block active, the padding block among them)
    and its second (the dense bypass). The misses have no opacity, so their
    depth is the clip's floor: 0 in JAX. Before the repair the port clipped
    over the real rays only and read the nearest survivor depth there
    (2.0, the box's near depth, on each miss in all three frames, outside the
    render bars); now they are equal, and the frames within the bars."""
    rays = camera_rays(14, n_miss=4)
    kw = dict(FAST, table_dtype=jnp.float32, proxy=scene["proxy"])
    pkw = dict(kw, table_dtype=torch.float32, proxy=port_proxy(scene["proxy"]))
    want = JF.make_fast_eg3d_renderer(scene["tree"], scene["jcfg"], **kw)(jnp.asarray(rays))
    got = TF.make_fast_eg3d_renderer(scene["model"], scene["cfg"], **pkw)(
        torch.from_numpy(rays))
    frames = [("plain", got, want)]
    jauto = JF.make_fast_eg3d_renderer(scene["tree"], scene["jcfg"], cull="auto", **kw)
    auto = TF.make_fast_eg3d_renderer(scene["model"], scene["cfg"], cull="auto", **pkw)
    for frame in range(2):
        want = jauto(jnp.asarray(rays))
        got = auto(torch.from_numpy(rays))
        assert auto.last_plain == jauto.last_plain == (frame == 1), frame
        frames.append((f"auto frame {frame}", got, want))
    for name, got, want in frames:
        close(got, want, name)
        miss = np.asarray(want["depth_fine"])[-4:]
        assert (miss == 0).all(), name
        np.testing.assert_array_equal(got["depth_fine"][-4:].numpy(), miss, err_msg=name)


# ---- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory, scene):
    """The Blender sphere scene and a JAX-saved checkpoint of the CLI's tiny
    config (32 plane channels)."""
    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=16)
    jcfg = J.TriPlaneConfig(**CLI_CFG, rendering=J.RenderingOptions(**CLI_OPTS))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "eg3d.msgpack")
    save_checkpoint(ckpt, {"eg3d_renderer": numpy_eg3d_tree(jcfg, seed=5, noise=True)})
    return root, ckpt


def _run(main, opts, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(opts)
    finally:
        os.chdir(old)


@pytest.mark.parametrize("cull", [[], ["--fast_cull", "auto"]], ids=["plain", "auto"])
def test_eval_eg3d_fast_cli_matches_jax(tmp_path, scene, cli_scene, monkeypatch, cull):
    """`eval_eg3d --renderer fast --device cpu` against JAX's CLI on the same
    checkpoint and proxy: frames within the render bars, PSNR within 0.1 dB."""
    from eval_eg3d import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu_torch.eval_eg3d import get_opts, main

    root, ckpt = cli_scene
    monkeypatch.setattr(JF, "distill_proxy", lambda *a, **k: scene["proxy"])
    monkeypatch.setattr(TF, "distill_proxy", lambda *a, **k: port_proxy(scene["proxy"]))
    args = ["--root_dir", root, "--img_wh", "16", "16", "--ckpt_path", ckpt, "--scene_name", "f",
            "--chunk", "128", "--renderer", "fast", "--fast_candidates", "16", "--fast_keep",
            "8", *cull] + TINY_FLAGS
    (tmp_path / "jax").mkdir()
    want_psnr = _run(jax_main, jax_opts(args), tmp_path / "jax")
    got_psnr = _run(main, get_opts(args + ["--device", "cpu"]), tmp_path)
    names = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "results" / "blender" / "f" / "*")))
    assert names == ["000.png", "001.png", "f.gif"]
    for name in names[:2]:
        a = imageio.imread(tmp_path / "results" / "blender" / "f" / name).astype(float) / 255
        b = imageio.imread(tmp_path / "jax" / "results" / "blender" / "f" / name).astype(
            float) / 255
        err = np.abs(a - b)
        assert np.median(err) < 2e-3 and np.percentile(err, 99) < 0.05, name
    assert np.isfinite(got_psnr) and abs(got_psnr - want_psnr) < 0.1


def test_eval_eg3d_renders_above_k3s_limit_on_the_cpu(cli_scene, tmp_path):
    """Above MAX_CANDIDATES (the shared-memory row's cap; K3 takes the count
    on the card from a device scratch) the plain version renders on the CPU
    (a 2 x 2 image at MAX_CANDIDATES + 1)."""
    from nerf_siren_tpu_torch.eval_eg3d import get_opts, main
    from nerf_siren_tpu_torch.ops.kernels.proxy_march import MAX_CANDIDATES

    root, ckpt = cli_scene
    base = ["--root_dir", root, "--ckpt_path", ckpt, "--renderer", "fast"]
    hp = get_opts(base + ["--img_wh", "2", "2", "--fast_candidates", str(MAX_CANDIDATES + 1),
                          "--fast_distill_steps", "2", "--fast_distill_batch", "256",
                          "--scene_name", "k3", "--device", "cpu"] + TINY_FLAGS)
    assert np.isfinite(_run(main, hp, tmp_path))
