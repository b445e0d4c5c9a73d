"""EG3D training in the port (`models/stylegan2.py`'s `w_avg_ema`, random
noise and discriminator, `render/triplane.py::importance_render` with its
draws, `training/eg3d_system.py`, the train CLI's `--mode eg3d`) against
the JAX package's, on the TINY triplane config of tests/test_triplane.py
(z/w 32, planes 16^2 x 8 channels, channel_base 512, channel_max 32, 8 + 8
samples) and numpy-drawn weights crossed over with `convert.py`.

JAX's step is always stochastic: it folds the step into its key, splits
it into the synthesis and render keys, and the render key into four
(strata, pdf, noise 1, noise 2). The tests draw JAX's uniforms from that
chain (`jax_draws`) and hand them to the port as pre-drawn draws, so one
stochastic step is held, not only the deterministic render.

Tolerances (float32 on both sides, the sums in another order):
- `w_avg_ema`, `minibatch_stddev`: 1e-6 of the output's scale;
- the synthesis with random noise, the discriminator, `importance_render`
  on shared planes: 1e-4 of the output's scale (the 14-layer stack's bar,
  tests/test_torch_stylegan2.py);
- a step's loss: relative 1e-5; each gradient tensor: 1e-3 of its largest
  magnitude (the backward runs through both stacks and the plain gather's
  scatter, and a sample whose coordinate lands within rounding of a texel
  edge moves its weights);
- the updated tree after one Adam step: Adam's first step moves an element
  by lr whatever the size of its gradient, so an element whose gradient is
  within the gradient bar of zero may move the other way; every element
  with a gradient above 1e-2 of its tensor's largest is held to 1e-4 x lr
  of JAX's, and `w_avg` (zero gradient, the EMA after the update) to
  1e-5 of its scale;
- the weight-decay case: `w_avg` after two steps at 1e-5 of its scale (its
  gradient is zero: only the decay and the EMA move it), every
  `noise_const` under the updated tree's rule (its gradient runs through
  the const noise term);
- the port's grouped loop against its eager steps: bit-equal;
- a port-trained checkpoint rendered by JAX's `EG3DSystem.render` against
  the port's render: 2e-3 (tests/test_torch_eg3d_eval.py's bar: each
  package packs its own bf16 table).
"""
import copy
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.models import stylegan2 as JS
from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu.training import checkpoints as jckpt
from nerf_siren_tpu.training.eg3d_system import EG3DSystem as JEG3DSystem
from nerf_siren_tpu.training.losses import mse_loss as jmse
from nerf_siren_tpu.training.system import TrainState as JTrainState
from nerf_siren_tpu_torch.config import TrainConfig
from nerf_siren_tpu_torch.convert import eg3d_from_jax, eg3d_to_jax
from nerf_siren_tpu_torch.models import stylegan2 as T
from nerf_siren_tpu_torch.render import triplane as TT
from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint, load_eg3d_ckpt
from nerf_siren_tpu_torch.training.eg3d_system import MODEL, OUTPUTS, EG3DSystem
from nerf_siren_tpu_torch.training.graphs import NOISE
from nerf_siren_tpu_torch.training.system import parameters
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_stylegan2 import TINY, numpy_eg3d_tree

EXACT_TOL = 1e-6
NET_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
LR = 0.1   # large, so that the EMA's order shows (test_w_avg_ema_reads_the_pre_step_mapping)
OPTS = dict(depth_resolution=8, depth_resolution_importance=8, ray_start=2.0, ray_end=6.0,
            box_warp=8.0, white_back=True)
N_RAYS = 64


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol} x scale {scale:.3e}"


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def configs(plane_channels=TINY["plane_channels"], **opts):
    o, c = dict(OPTS, **opts), dict(TINY, plane_channels=plane_channels)
    return (J.TriPlaneConfig(**c, rendering=J.RenderingOptions(**o)),
            TT.TriPlaneConfig(**c, rendering=TT.RenderingOptions(**o)))


def port_model(tree, cfg):
    model = TT.EG3DRenderer(cfg)
    model.load_state_dict(eg3d_from_jax(tree))
    return model


def camera_rays(n, seed):
    """n rays from around (0, 0, -4) into the box of side 8, unit directions,
    with rgb targets."""
    rng = np.random.default_rng(seed)
    rays = np.zeros((n, 8), np.float32)
    rays[:, :3] = rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, -4.0]
    d = rng.normal(size=(n, 3)) * 0.25 + [0.0, 0.0, 1.0]
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 6:8] = [2.0, 6.0]
    return rays, rng.uniform(size=(n, 3)).astype(np.float32)


def jax_draws(key, n_rays, opts, step=None):
    """The four draws of JAX's importance render from `key` (the render key;
    with `step`, the step's key chain from the train key: fold_in, then the
    synthesis / render split), as the port's `Draws`."""
    if step is not None:
        key = jax.random.split(jax.random.fold_in(key, step))[1]
    k_strat, k_pdf, k_n1, k_n2 = jax.random.split(key, 4)
    s, i = opts.depth_resolution, opts.depth_resolution_importance
    draws = {"strat_u": jax.random.uniform(k_strat, (1, n_rays, s, 1))[..., 0],
             "pdf_u": jax.random.uniform(k_pdf, (n_rays, i))}
    if opts.density_noise > 0:
        draws["sigma_coarse"] = jax.random.normal(k_n1, (1, n_rays * s, 1))[..., 0]
        draws["sigma_fine"] = jax.random.normal(k_n2, (1, n_rays * i, 1))[..., 0]
    return {k: t(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def scene():
    jcfg, cfg = configs()
    tree = numpy_eg3d_tree(jcfg, seed=5, noise=True)
    return jcfg, cfg, tree


# ---- the StyleGAN2 pieces ------------------------------------------------------

def test_w_avg_ema_matches_jax(scene):
    jcfg, cfg, tree = scene
    w = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    mapping = port_model(tree, cfg).backbone.mapping
    want = JS.w_avg_ema(tree["backbone"]["mapping"], jcfg.backbone.mapping, jnp.asarray(w))
    close(mapping.w_avg_ema(t(w)), want, EXACT_TOL)


def test_random_noise_replays_the_jax_key_chain(scene):
    """noise_mode 'random': one key per block, split in two for conv0 and
    conv1 (the const block's conv1 takes the first), (B, 1, res, res)
    normal draws; the port takes the same draws pre-drawn."""
    jcfg, cfg, tree = scene
    syn = jcfg.backbone.synthesis
    ws = np.random.default_rng(2).standard_normal((2, syn.num_ws, 32)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, w: JS.apply_synthesis_network(p, syn, w, noise_mode="random",
                                                           rng=key))(
        tree["backbone"]["synthesis"], jnp.asarray(ws))
    noise = {}
    for res, k in zip(syn.block_resolutions, jax.random.split(key, len(syn.block_resolutions))):
        k0, k1 = jax.random.split(k, 2)
        names = (("conv1", k0),) if res == 4 else (("conv0", k0), ("conv1", k1))
        for name, kk in names:
            noise[f"b{res}.{name}"] = t(jax.random.normal(kk, (2, 1, res, res)))
    synthesis = port_model(tree, cfg).backbone.synthesis
    assert {k: v.shape for k, v in noise.items()} == {
        k: torch.Size(s) for k, s in synthesis.noise_shapes(2).items()}
    with torch.no_grad():
        got = synthesis(t(ws), noise_mode="random", noise=noise)
        const = synthesis(t(ws), noise_mode="const")
        drawn = synthesis(t(ws), noise_mode="random", generator=torch.Generator().manual_seed(1))
        redrawn = synthesis(t(ws), noise_mode="random",
                            noise=synthesis.draw_noise(torch.Generator().manual_seed(1), 2))
    close(got, want, NET_TOL)
    assert float((got - const).abs().max()) > 100 * NET_TOL * float(np.abs(want).max())
    assert torch.equal(drawn, redrawn)   # a generator draws `noise_shapes` in their order


@pytest.mark.parametrize("n", [4, 6, 8])
def test_minibatch_stddev_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((n, 6, 4, 4)).astype(np.float32)
    close(T.minibatch_stddev(t(x), 4, 2), JS.minibatch_stddev(jnp.asarray(x), 4, 2), EXACT_TOL)


def test_discriminator_matches_jax():
    dcfg = JS.DiscriminatorConfig(img_resolution=16, channel_base=512, channel_max=32)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda k: JS.init_discriminator(k, dcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  shapes)
    net = T.Discriminator(T.DiscriminatorConfig(img_resolution=16, channel_base=512,
                                                channel_max=32))
    assert set(net.state_dict()) == set(eg3d_from_jax(tree))
    net.load_state_dict(eg3d_from_jax(tree))
    img = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: JS.apply_discriminator(p, dcfg, x))(tree, jnp.asarray(img))
    with torch.no_grad():
        got = net(t(img))
    assert got.shape == (4, 1)
    close(got, want, NET_TOL)


# ---- importance_render with JAX's draws --------------------------------------

@pytest.mark.parametrize("limits", ["numeric", "auto"])
def test_importance_render_on_jax_draws_matches_jax(scene, limits):
    """Stratified depths, the pdf's u and density noise from JAX's key
    split, on shared float32 planes."""
    _, _, tree = scene
    extra = dict(density_noise=0.5) if limits == "numeric" else dict(ray_start="auto")
    jcfg, cfg = configs(**extra)
    rng = np.random.default_rng(4)
    planes = rng.standard_normal((1, 3, 8, 16, 16)).astype(np.float32)
    rays, _ = camera_rays(N_RAYS, 5)
    if limits == "auto":
        rays[:4, 3:6] = [[1.0, 0.0, 0.0]] * 4                      # rays that miss the box
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda pl, dec, r: J.importance_render(
        pl, dec, r[None, :, :3], r[None, :, 3:6], jcfg.rendering, key))(
        jnp.asarray(planes), tree["decoder"], jnp.asarray(rays))
    model = port_model(tree, cfg)
    with torch.no_grad():
        got = TT.importance_render(t(planes), model.decoder, t(rays[None, :, :3]),
                                   t(rays[None, :, 3:6]), cfg.rendering,
                                   draws=jax_draws(key, N_RAYS, jcfg.rendering))
        det = TT.importance_render(t(planes), model.decoder, t(rays[None, :, :3]),
                                   t(rays[None, :, 3:6]), cfg.rendering)
    for name, g, w in zip(OUTPUTS, got, want):
        close(g, w, NET_TOL, str(name))
    assert float((got[3] - det[3]).abs().max()) > 1e-3   # the draws moved the render


# ---- one stochastic step against JAX's ---------------------------------------

def jax_state(jsys, tree):
    params = {"eg3d_renderer": jax.tree_util.tree_map(jnp.asarray, tree)}
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jsys.tx.init(params))


def port_state(system, tree):
    return system.state_for({MODEL: port_model(tree, system.cfg)})


def tree_of(state):
    return eg3d_to_jax(state.models[MODEL].state_dict())


def flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def one_step(scene):
    """JAX's train_step (Adam, lr LR) and its gradients, and the port's
    step on JAX's replayed draws, from the same tree and batch."""
    jcfg, cfg, tree = scene
    rays, rgbs = camera_rays(N_RAYS, 7)
    key = jax.random.PRNGKey(8)
    jsys = JEG3DSystem(JRenderConfig(), JTrainConfig(lr=LR), steps_per_epoch=10,
                       triplane_cfg=jcfg)

    def loss(params, r, c, step_rng):
        out = J.eg3d_render(params["eg3d_renderer"], jcfg, r[:, :3], r[:, 3:6],
                            noise_mode="const", rng=step_rng)
        return jmse(out, c)["sum"]

    jgrads = jax.jit(jax.grad(loss))(jax_state(jsys, tree).params, jnp.asarray(rays),
                                     jnp.asarray(rgbs), jax.random.fold_in(key, 0))
    jnew, jm = jsys.train_step(jax_state(jsys, tree), {"rays": rays, "rgbs": rgbs}, key)
    system = EG3DSystem(cfg, train_cfg=TrainConfig(lr=LR), steps_per_epoch=10, device="cpu")
    state = port_state(system, tree)
    draws = jax_draws(key, N_RAYS, jcfg.rendering, step=0)
    losses, _, grads = system.loss_and_grads(state, t(rays), t(rgbs), noise=draws)
    state, m = system.train_step(state, {"rays": rays, "rgbs": rgbs}, seed=0, noise=draws)
    names = [n for _, n, _ in parameters(state.models)]
    return dict(jgrads=eg3d_from_jax(jgrads["eg3d_renderer"]), jnew=jnew, jm=jm, state=state,
                m=m, losses=losses, grads=dict(zip(names, grads)), rays=rays, rgbs=rgbs,
                draws=draws, system=system, tree=tree)


def test_one_stochastic_step_loss_and_gradients_match_jax(one_step):
    s = one_step
    np.testing.assert_allclose(float(s["losses"]["sum"].detach()), float(s["jm"]["train/loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(s["m"]["train/loss"]), float(s["jm"]["train/loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(s["m"]["train/psnr"]), float(s["jm"]["train/psnr"]),
                               rtol=LOSS_RTOL)
    assert set(s["grads"]) == set(s["jgrads"])
    for name, g in s["grads"].items():
        close(g, s["jgrads"][name].numpy(), GRAD_TOL, name)
    # JAX differentiates every leaf: a noise_const through its const noise
    # term (the strengths here are 0.1-0.5), w_avg not at all (no truncation)
    assert not s["grads"]["backbone.mapping.w_avg"].any()
    assert all(s["grads"][n].abs().max() > 0 for n in s["grads"] if n.endswith("noise_const"))


def test_one_stochastic_step_updates_the_tree_as_jax(one_step):
    s = one_step
    got = eg3d_from_jax(tree_of(s["state"]))
    want = eg3d_from_jax(jax.tree_util.tree_map(np.asarray, s["jnew"].params["eg3d_renderer"]))
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("w_avg"):
            close(got[name], w.numpy(), 1e-5, name)
            continue
        g = s["jgrads"][name].abs()
        firm = g > 1e-2 * float(g.max()) if g.numel() else g.bool()
        d = (got[name] - w).abs()
        assert float(d[firm].max() if firm.any() else 0.0) <= 1e-4 * LR, name
        assert float(d.max()) <= 2.0 * LR + 1e-6, name
    assert int(s["state"].step) == 1


def test_w_avg_ema_reads_the_pre_step_mapping(one_step):
    """The EMA from the mapping after the update (the wrong order) misses
    JAX's `w_avg` by far more than the bar: the test sees the order."""
    s = one_step
    jw = np.asarray(s["jnew"].params["eg3d_renderer"]["backbone"]["mapping"]["w_avg"])
    model = s["state"].models[MODEL]
    with torch.no_grad():
        w_post = model.mapping_pre_broadcast(model.z)
        start = t(s["tree"]["backbone"]["mapping"]["w_avg"])
        mean = w_post.mean(0)
        wrong = mean + model.backbone.mapping.cfg.w_avg_beta * (start - mean)
    got = model.backbone.mapping.w_avg
    close(got, jw, 1e-5, "w_avg")
    assert float((wrong - t(jw)).abs().max()) > 10 * 1e-5 * float(np.abs(jw).max())


def test_two_steps_with_weight_decay_move_the_buffers_as_jax(scene):
    """JAX's optimizer runs over the whole tree: weight decay moves `w_avg`
    (before the EMA reads it) and every `noise_const`. Two steps."""
    jcfg, cfg, tree = scene
    key = jax.random.PRNGKey(9)
    tkw = dict(lr=LR, weight_decay=1e-2)
    jsys = JEG3DSystem(JRenderConfig(), JTrainConfig(**tkw), steps_per_epoch=10,
                       triplane_cfg=jcfg)
    system = EG3DSystem(cfg, train_cfg=TrainConfig(**tkw), steps_per_epoch=10, device="cpu")
    jstate, state = jax_state(jsys, tree), port_state(system, tree)
    for step in range(2):
        rays, rgbs = camera_rays(N_RAYS, 20 + step)
        jstate, _ = jsys.train_step(jstate, {"rays": rays, "rgbs": rgbs}, key)
        state, _ = system.train_step(state, {"rays": rays, "rgbs": rgbs}, seed=0,
                                     noise=jax_draws(key, N_RAYS, jcfg.rendering, step=step))
    got = eg3d_from_jax(tree_of(state))
    want = eg3d_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params["eg3d_renderer"]))
    start = eg3d_from_jax(tree)
    names = [n for n in want if n.endswith(("w_avg", "noise_const"))]
    assert len(names) == 1 + 5   # the mapping's w_avg, b4.conv1 and conv0/conv1 of b8, b16
    for name in names:
        if name.endswith("w_avg"):
            close(got[name], want[name].numpy(), 1e-5, name)
        else:   # two Adam steps: elements move by ~lr each, in the gradient's direction
            d = (got[name] - want[name]).abs()
            assert float(d.max()) <= 4.0 * LR + 1e-6, name
            assert float(d.median()) <= 1e-4 * LR, name
        assert not torch.equal(got[name], start[name]), name


# ---- the grouped steps on the CPU loop ----------------------------------------

@pytest.fixture(scope="module")
def small_system(scene):
    _, cfg, tree = scene
    system = EG3DSystem(cfg, train_cfg=TrainConfig(lr=LR, batch_size=32), steps_per_epoch=10,
                        device="cpu")
    return system, tree


def _equal_states(a, b):
    pa, pb = parameters(a.models), parameters(b.models)
    return all(torch.equal(x, y) for (_, _, x), (_, _, y) in zip(pa, pb)) and all(
        torch.equal(x, y) for k in a.opt_state if isinstance(a.opt_state[k], list)
        for x, y in zip(a.opt_state[k], b.opt_state[k]))


@pytest.mark.parametrize("kind", ["batches", "pool", "importance"])
def test_grouped_steps_equal_train_steps_on_the_same_indices(small_system, kind):
    """`train_scan_batches`, `train_scan` and `train_scan_importance` (with
    uniform_frac 1, so its indices are the drawn uniform ones) on the CPU
    loop, against as many `train_step`s on the group's rays and draws: the
    weights, the moments, `w_avg` and the losses bit-equal."""
    system, tree = small_system
    n, b = 3, 32
    rays, rgbs = camera_rays(96, 30)
    eager, grouped = port_state(system, tree), port_state(system, tree)
    if kind == "batches":
        idx = [torch.arange(i * b, (i + 1) * b) for i in range(n)]
        inputs = system.group_inputs(eager, "batches", {"rays": t(rays[:n * b].reshape(n, b, 8)),
                                                        "rgbs": t(rgbs[:n * b].reshape(n, b, 3))},
                                     1, n, b)
        grouped, gm = system.train_scan_batches(grouped, rays[:n * b].reshape(n, b, 8),
                                                rgbs[:n * b].reshape(n, b, 3), seed=1)
    else:
        inputs = system.group_inputs(eager, kind, system._pool(rays, rgbs), 1, n, b,
                                     uniform_frac=1.0)
        idx = list(inputs["idx" if kind == "pool" else "idx_uni"])
        if kind == "pool":
            grouped, gm = system.train_scan(grouped, rays, rgbs, seed=1, n_steps=n,
                                            batch_size=b)
        else:
            grouped, gm = system.train_scan_importance(grouped, rays, rgbs, seed=1, n_steps=n,
                                                       batch_size=b, uniform_frac=1.0)
    losses = []
    for i in range(n):
        draws = {k[len(NOISE):]: v[i] for k, v in inputs.items() if k.startswith(NOISE)}
        eager, m = system.train_step(eager, {"rays": rays[idx[i]], "rgbs": rgbs[idx[i]]},
                                     seed=1, noise=draws)
        losses.append(m["train/loss"])
    assert eager.step == grouped.step == n
    assert _equal_states(eager, grouped)
    assert torch.equal(system.last_group.steps[:, 0], torch.stack(losses))
    assert torch.equal(gm["train/loss"], losses[-1])


# ---- the CLI and its checkpoints -----------------------------------------------

CLI_ARGS = ["--mode", "eg3d", "--dataset_name", "blender", "--img_wh", "16", "16",
            "--N_samples", "8", "--N_importance", "8", "--batch_size", "512", "--lr", "1e-3",
            "--eg3d_plane_res", "16", "--eg3d_channel_base", "512", "--eg3d_channel_max", "32",
            "--eg3d_z_dim", "32", "--eg3d_ray_start", "2.0", "--eg3d_ray_end", "6.0",
            "--eg3d_box_warp", "8.0", "--num_epochs", "1", "--device", "cpu"]


def _in(cwd, fn, *args):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One epoch (3 steps of 512 rays) of `--mode eg3d` with
    `--steps_per_dispatch` 1 and 3."""
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import main

    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=16)
    cwd = tmp_path_factory.mktemp("run")
    runs = {}
    for spd in (1, 3):
        state = _in(cwd, main, get_opts(["--root_dir", root, *CLI_ARGS, "--exp_name",
                                         f"spd{spd}", "--steps_per_dispatch", str(spd)]))
        (path,) = glob.glob(str(cwd / "ckpts" / f"spd{spd}" / "*.msgpack"))
        runs[spd] = (state, path)
    return root, runs


def test_train_cli_eg3d_eager_and_grouped_write_the_same_checkpoint(cli_runs):
    _, runs = cli_runs
    (s1, p1), (s3, p3) = runs[1], runs[3]
    assert s1.step == s3.step == 3
    assert os.path.basename(p1) == os.path.basename(p3) == "epoch=0-step=3.msgpack"
    a, b = load_checkpoint(p1), load_checkpoint(p3)
    assert set(a["params"]) == {"eg3d_renderer"}
    la, lb = jax.tree_util.tree_leaves(a["params"]), jax.tree_util.tree_leaves(b["params"])
    assert len(la) == len(lb) == len(jax.tree_util.tree_leaves(tree_of(s1)))
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree_util.tree_leaves(a["opt_state"]["mu"]),
                    jax.tree_util.tree_leaves(b["opt_state"]["mu"])):
        np.testing.assert_array_equal(x, y)


def test_port_trained_checkpoint_renders_in_jax(cli_runs):
    """JAX's `load_ckpt` reads the port's tree (w_avg, noise_const and z
    included) bit for bit, and its `EG3DSystem.render` of it agrees with the
    port's render within 2e-3."""
    from nerf_siren_tpu.datasets.blender import BlenderDataset

    root, runs = cli_runs
    state, path = runs[1]
    jcfg, cfg = configs(plane_channels=32)   # the CLI's planes: 32 channels
    shapes = numpy_eg3d_tree(jcfg, seed=0)
    loaded = jckpt.load_ckpt(shapes, path, "eg3d_renderer")
    for (pa, x), (pb, y) in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                                jax.tree_util.tree_flatten_with_path(tree_of(state))[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), y)
    rays = BlenderDataset(root, split="val", img_wh=(16, 16))[0]["rays"]
    jsys = JEG3DSystem(JRenderConfig(), JTrainConfig(), steps_per_epoch=1, triplane_cfg=jcfg)
    want = jsys.render({"eg3d_renderer": loaded}, rays, chunk=128)
    got = EG3DSystem(cfg).render(state.models[MODEL], t(rays), chunk=128)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=2e-3, rtol=0, err_msg=k)


def test_jax_trained_state_loads_into_the_port(one_step, tmp_path):
    """A JAX full-resume checkpoint after one step: the port's
    `load_eg3d_ckpt` takes its tree bit for bit."""
    s = one_step
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_train_state(path, s["jnew"], 1)
    model = load_eg3d_ckpt(port_model(numpy_eg3d_tree(configs()[0], seed=1), configs()[1]),
                           path)
    want = eg3d_from_jax(jax.tree_util.tree_map(np.asarray, s["jnew"].params["eg3d_renderer"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
