"""Proxy-culled training in the port (`render/culled_train.py`,
`NeRFSystem(train_backend='culled' | 'culled_fused')`) against the JAX
package's `render_rays_culled` and `NeRFSystem`, on the CPU.

Tolerances and why:
- the placement (`culled_depths`) on JAX's own proxy scores and candidate
  depths, at perturb 0 and on JAX's draws replayed from its key chain
  (`split(fold_in(key, step), 4)`): within 1e-6 of the far depth (6e-6;
  readings 2.4e-6 and 1.9e-6, about 5 ulp at depth 4-6). Only the float32
  summation order separates them: the transmittance's cumprod and the
  CDF's cumsum run sequentially in torch and as XLA's tree scan in JAX, and
  a sample moves by that ulp-level CDF delta times the bin width over its
  pdf. So the proxy here has density along every ray (`proxy_with_density`,
  as `with_density` gives the fields): on a random proxy's empty bins
  (weights eps-floored) the same ulps move a sample by up to 7.1e-4, and
  the deterministic u = 1 sample ties with the CDF's last value, the
  sanctioned `sample_pdf` deltas of ROADMAP Queue 3.
- `render_rays_culled` end to end at perturb 0 and noise 0 on a 4x32 field
  (readings on this seed in brackets): rgb and opacity atol 1e-5 [3.0e-7,
  3.0e-7]; depth atol 1e-4 [1.4e-5]; the proxy loss rtol 1e-5 [1.3e-7].
  The port's bf16 proxy scores sum in another order than XLA's [2.0e-5
  apart], which moves the survivors' depths: below 5e-5 [4.8e-6], the
  sanctioned delta of ROADMAP Queue 3.
- one `train_step` on each culled backend from the same weights and batch,
  perturb 0 and noise 0, against JAX's step (its pure step's loss under
  jax.value_and_grad, whose loss and proxy loss equal its `train_step`'s
  metrics to 1e-6): the loss and the proxy loss within 1e-3 relative.
  Gradients on `culled` (float32 both sides): the heads' and the proxy's
  within 2e-3 of the tensor's largest |gradient| (readings: 1.4e-3 on the
  proxy's output bias, a sum of signed residuals; the rest below 7e-4);
  the trunk layers' relative L2 below 5e-3, tests/test_torch_training.py's
  bar for the sanctioned delta of fused sample positions (XLA fuses o + d z,
  torch rounds twice; readings up to 2.7e-3 on the coarse trunk). On
  `culled_fused` K2's plain version runs against JAX's Pallas kernels in
  interpret mode, both on bf16 operands: on 8 rays the photometric loss
  cancels, and JAX's own bf16 step differs from its float32 step by up to
  9% relative L2 in the trunk. Each field gradient's relative L2 to JAX's
  bf16 one must stay below that spread plus 1e-2 (readings: up to 7.6%
  against a spread of 8.7%); the proxy, float32 on both backends, to
  2e-3 of its largest.
- with `proxy_lambda` 0 the proxy is bit-identical after a step and the
  fine field moves (JAX's `test_photometric_loss_never_moves_the_proxy`).
- grouped culled steps on the CPU (`train_scan_batches`, the loop a card
  captures) against eager steps, and the render on the step's draws made
  beforehand (`draw_step_noise`) against its generator: bit-equal,
  perturbed and noisy.
- checkpoints: the proxy crosses both ways bit-equal, and both packages'
  fast eval read it as the trained proxy.
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.render import culled_train as JC
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu.training import checkpoints as jckpt
from nerf_siren_tpu.training.losses import loss_dict as jloss_dict
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu.training.system import TrainState as JTrainState
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_from_jax, proxy_from_jax, proxy_to_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.render.culled_train import culled_depths, render_rays_culled
from nerf_siren_tpu_torch.render.fast import Proxy
from nerf_siren_tpu_torch.training import checkpoints as ckpt
from nerf_siren_tpu_torch.training.system import (NeRFSystem, draw_step_noise, parameters,
                                                  step_generator)
from tests.test_torch_rendering import with_density
from tests.test_torch_semantic import numpy_tree, one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(depth=4, width=32, skips=(2,))
CULL = dict(n_candidates=32, n_sel=16, n_uni=8)
SYS_CULL = dict(culled_candidates=16, culled_sel=8, culled_uni=4)
RKW = dict(n_samples=8, n_importance=8, perturb=0.0, noise_std=0.0, white_back=True)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    return rays, rng.uniform(size=(n, 3)).astype(np.float32)


def proxy_with_density(proxy):
    """A random proxy whose scores lie near 0.5 everywhere (sigma_hat ~ 0.65):
    no candidate weight is eps-floored (see the module docstring)."""
    l2 = {"kernel": proxy["l2"]["kernel"] * 0.1, "bias": proxy["l2"]["bias"] + 0.5}
    return {**proxy, "l2": l2}


def jax_params(nerf_kw, seed=0):
    """Coarse and fine fields and a hidden-64 proxy, each with density along
    every ray, drawn from numpy in the JAX trees' shapes."""
    cfg = JNeRFConfig(**nerf_kw)
    return {"coarse": with_density(numpy_tree(init_nerf, cfg, seed=seed)),
            "fine": with_density(numpy_tree(init_nerf, cfg, seed=seed + 1)),
            "proxy": proxy_with_density(numpy_tree(jfast.init_proxy, 64, seed=seed + 2))}


def port_models(params, nerf_kw):
    models = {}
    for k in ("coarse", "fine"):
        models[k] = NeRF(NeRFConfig(**nerf_kw))
        models[k].load_state_dict(nerf_from_jax(params[k]))
    models["proxy"] = Proxy(64)
    models["proxy"].load_state_dict(proxy_from_jax(params["proxy"]))
    return models


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def narrow():
    return jax_params(NARROW)


# ---- the placement -----------------------------------------------------------------

def _jax_render_recorded(params, rays, cfg, key, monkeypatch, **kw):
    """JAX's render_rays_culled, run eagerly, with its bf16 proxy scores and
    its pdf and strata depths recorded."""
    rec = {}
    apply0, pdf0, strat0 = JC.apply_proxy, JC.sample_pdf, JC.stratified_z_vals

    def apply_proxy(proxy, xyz, dtype):
        out = apply0(proxy, xyz, dtype)
        rec.setdefault("scores" if dtype is not None else "pred", np.asarray(out))
        return out

    def sample_pdf(*a, **k):
        rec["z_sel"] = np.asarray(pdf0(*a, **k))
        return rec["z_sel"]

    def stratified(*a, **k):
        rec["z_uni"] = np.asarray(strat0(*a, **k))
        return rec["z_uni"]

    monkeypatch.setattr(JC, "apply_proxy", apply_proxy)
    monkeypatch.setattr(JC, "sample_pdf", sample_pdf)
    monkeypatch.setattr(JC, "stratified_z_vals", stratified)
    out, p_loss = JC.render_rays_culled(params, jnp.asarray(rays), cfg, key,
                                        nerf_cfg=JNeRFConfig(**NARROW), **kw)
    rec["z_all"] = np.sort(np.concatenate([rec["z_uni"], rec["z_sel"]], -1), -1)
    return out, p_loss, rec


@pytest.mark.parametrize("perturb", [0.0, 1.0], ids=["perturb0", "jax-draws"])
def test_placement_on_jax_scores_matches_jax(narrow, monkeypatch, perturb):
    rays, _ = _rays(48, 1)
    cfg = dict(RKW, perturb=perturb)
    key, step = jax.random.PRNGKey(3), 5
    step_key = jax.random.fold_in(key, step)
    _, _, rec = _jax_render_recorded(narrow, rays, JRenderConfig(**cfg), step_key, monkeypatch,
                                     **CULL)
    noise = {}
    if perturb:
        k_pdf, k_uni, _, _ = jax.random.split(step_key, 4)
        noise = {"culled_pdf_u": t(jax.random.uniform(k_pdf, (48, CULL["n_sel"]))),
                 "culled_strat_u": t(jax.random.uniform(k_uni, (48, CULL["n_uni"])))}
    near, far = jnp.asarray(rays[:, 6:7]), jnp.asarray(rays[:, 7:8])
    tt = jnp.linspace(0.0, 1.0, CULL["n_candidates"])
    z_cand = near * (1.0 - tt) + far * tt
    r = t(rays)
    got = culled_depths(t(rec["scores"]), t(z_cand), r[:, 6:7], r[:, 7:8],
                        torch.linalg.norm(r[:, 3:6], dim=-1, keepdim=True), CULL["n_sel"],
                        CULL["n_uni"], RenderConfig(**cfg), noise)
    assert got.shape == (48, 24)
    np.testing.assert_allclose(got.numpy(), rec["z_all"], atol=1e-6 * 6.0, rtol=0)


def test_render_rays_culled_matches_jax(narrow, monkeypatch):
    rays, _ = _rays(64, 2)
    want, want_loss, rec = _jax_render_recorded(narrow, rays, JRenderConfig(**RKW),
                                                jax.random.PRNGKey(1), monkeypatch, **CULL)
    models = port_models(narrow, NARROW)
    got, loss = render_rays_culled(models, t(rays), RenderConfig(**RKW), **CULL)
    assert set(got) == set(want)
    for k, v in want.items():
        atol = 1e-4 if k.startswith("depth") else 1e-5
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), atol=atol, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    # the placement's delta: bf16 scores summed in another order
    r = t(rays)
    tt = torch.linspace(0.0, 1.0, CULL["n_candidates"])
    with torch.no_grad():
        from nerf_siren_tpu_torch.render.fast import apply_proxy
        z_cand = r[:, 6:7] * (1 - tt) + r[:, 7:8] * tt
        scores = apply_proxy(models["proxy"], r[:, None, :3] + r[:, None, 3:6] * z_cand[..., None])
    z = culled_depths(scores, z_cand, r[:, 6:7], r[:, 7:8],
                      torch.linalg.norm(r[:, 3:6], dim=-1, keepdim=True), CULL["n_sel"],
                      CULL["n_uni"], RenderConfig(**RKW))
    assert np.abs(z.numpy() - rec["z_all"]).max() < 5e-5


# ---- the training step --------------------------------------------------------------

def _systems(backend, nerf_kw, **kw):
    jsys = JNeRFSystem(JRenderConfig(**RKW), JTrainConfig(lr=5e-4, decay_step=(20,)),
                       JNeRFConfig(**nerf_kw), steps_per_epoch=10, train_backend=backend,
                       **SYS_CULL, **kw)
    system = NeRFSystem(RenderConfig(**RKW), TrainConfig(lr=5e-4, decay_step=(20,)),
                        NeRFConfig(**nerf_kw), steps_per_epoch=10, train_backend=backend,
                        device="cpu", **SYS_CULL, **kw)
    return jsys, system


def _jax_step(jsys, params, rays, rgbs, key):
    """JAX's culled step at step 0: the loss of its pure step
    (`NeRFSystem._make_pure_step`: the culled render on the step's key, the
    loss registry's sum plus proxy_lambda times the proxy loss) under
    jax.value_and_grad, jitted. Returns (loss, proxy loss, gradients)."""
    cfg = jsys.render_cfg.replace(test_time=False)
    field_fn = make_fused_train_field_fn = None
    if jsys.train_backend == "culled_fused":
        from nerf_siren_tpu.ops.pallas.fused_mlp_train import make_fused_train_field_fn

        field_fn = make_fused_train_field_fn

    def loss(p, rays, rgbs):
        fn = None if field_fn is None else make_fused_train_field_fn(rays[:, 3:6])
        out, p_loss = JC.render_rays_culled(
            p, rays, cfg, jax.random.fold_in(key, 0), nerf_cfg=jsys.nerf_cfg,
            field_fn=fn, n_candidates=jsys.culled_candidates, n_sel=jsys.culled_sel,
            n_uni=jsys.culled_uni)
        total = jloss_dict["mse"](out, rgbs)["sum"] + jsys.proxy_lambda * p_loss
        return total, p_loss

    (total, p_loss), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(rays), jnp.asarray(rgbs))
    return float(total), float(p_loss), grads


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("backend,nerf_kw,n_rays", [("culled", NARROW, 32),
                                                    ("culled_fused", {}, 8)],
                         ids=["culled-4x32", "culled_fused-8x256"])
def test_culled_train_step_matches_jax(backend, nerf_kw, n_rays):
    params = jax_params(nerf_kw, seed=4)
    rays, rgbs = _rays(n_rays, 6)
    key = jax.random.PRNGKey(1)
    jsys, system = _systems(backend, nerf_kw)
    j_loss, j_proxy, jgrads = _jax_step(jsys, params, rays, rgbs, key)
    if backend == "culled":   # the mirror is JAX's step: its train_step's metrics
        jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jax.device_put(params),
                             opt_state=jsys.tx.init(params))
        _, jm = jsys.train_step(jstate, {"rays": rays, "rgbs": rgbs}, key)
        np.testing.assert_allclose([j_loss, j_proxy], [float(jm["train/loss"]),
                                                       float(jm["train/proxy_loss"])], rtol=1e-6)
    else:                     # JAX's own bf16 spread: its float32 culled step
        jplain = _jax_step(_systems("culled", nerf_kw)[0], params, rays, rgbs, key)[2]

    state = system.state_for(port_models(params, nerf_kw))
    _, _, grads = system.loss_and_grads(state, t(rays), t(rgbs), None, noise={})
    _, m = system.train_step(state, {"rays": rays, "rgbs": rgbs}, seed=1)
    np.testing.assert_allclose([float(m["train/loss"]), float(m["train/proxy_loss"])],
                               [j_loss, j_proxy], rtol=1e-3)
    for (k, name, _), g in zip(parameters(state.models), grads):
        jg, g, what = _jax_leaf(jgrads[k], k, name), g.numpy(), f"{k} {name}"
        if backend == "culled_fused" and k != "proxy":
            spread = _rel_l2(jg, _jax_leaf(jplain[k], k, name))
            assert _rel_l2(g, jg) < spread + 1e-2, (what, _rel_l2(g, jg), spread)
        elif name.startswith("xyz_layers."):
            assert _rel_l2(g, jg) < 5e-3, (what, _rel_l2(g, jg))
        else:
            scale = max(float(np.abs(jg).max()), 1e-12)
            np.testing.assert_allclose(g, jg, atol=2e-3 * scale, rtol=0, err_msg=what)


def _jax_leaf(tree, key, name):
    """The JAX gradient of the port's tensor `name` of model `key`, in the
    port's layout (linear kernels transposed)."""
    if key == "proxy":
        layer, kind = name.split(".")
        leaf = np.asarray(tree[layer]["kernel" if kind == "weight" else "bias"])
        return leaf.T if kind == "weight" else leaf
    from nerf_siren_tpu_torch.convert import nerf_from_jax as f
    return f(jax.tree_util.tree_map(np.asarray, tree))[name].numpy()


def test_photometric_loss_never_moves_the_proxy(narrow):
    rays, rgbs = _rays(32, 7)
    system = NeRFSystem(RenderConfig(**dict(RKW, perturb=1.0, noise_std=1.0)),
                        TrainConfig(lr=5e-3), NeRFConfig(**NARROW), train_backend="culled",
                        device="cpu", proxy_lambda=0.0, **SYS_CULL)
    state = system.state_for(port_models(narrow, NARROW))
    before = copy.deepcopy(state.models)
    state, m = system.train_step(state, {"rays": rays, "rgbs": rgbs}, seed=2)
    assert float(m["train/proxy_loss"]) > 0
    for a, b in zip(before["proxy"].parameters(), state.models["proxy"].parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(before["fine"].parameters(),
                                                     state.models["fine"].parameters()))


def test_grouped_culled_steps_are_bit_equal_to_eager():
    system = NeRFSystem(RenderConfig(**dict(RKW, perturb=1.0, noise_std=1.0)),
                        TrainConfig(lr=5e-3), NeRFConfig(**NARROW), train_backend="culled",
                        device="cpu", **SYS_CULL)
    eager = system.init_state(0)
    assert set(eager.models) == {"coarse", "fine", "proxy"}
    grouped = system.state_for(copy.deepcopy(eager.models))
    batches = [_rays(16, 10 + i) for i in range(3)]
    # the step's draws made beforehand are the generator's
    cfg, culled = system.render_cfg, dict(n_candidates=16, n_sel=8, n_uni=4)
    noise = draw_step_noise(5, 0, 16, cfg, "cpu", (8, 4))
    assert set(noise) == {"culled_pdf_u", "culled_strat_u", "culled_sigma_coarse",
                          "culled_sigma_fine"}
    want, want_loss = render_rays_culled(eager.models, t(batches[0][0]), cfg,
                                         step_generator(5, 0, "cpu"), **culled)
    got, got_loss = render_rays_culled(eager.models, t(batches[0][0]), cfg, noise=noise, **culled)
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    proxy_losses = []
    for r, c in batches:
        eager, m = system.train_step(eager, {"rays": r, "rgbs": c}, seed=5)
        proxy_losses.append(m["train/proxy_loss"])
    grouped, gm = system.train_scan_batches(grouped, np.stack([b[0] for b in batches]),
                                            np.stack([b[1] for b in batches]), seed=5)
    for (_, _, a), (_, _, b) in zip(parameters(eager.models), parameters(grouped.models)):
        assert torch.equal(a, b)
    for k in ("train/loss", "train/psnr", "train/proxy_loss"):
        assert torch.equal(gm[k], m[k]), k
    assert torch.equal(system.last_group.steps[:, 2], torch.stack(proxy_losses))
    with pytest.raises(NotImplementedError, match="culled"):
        system.train_step_accum(eager, {"rays": batches[0][0], "rgbs": batches[0][1]}, 5, 2)


# ---- checkpoints ----------------------------------------------------------------------

def test_culled_checkpoint_crosses_both_ways(tmp_path, narrow, capsys):
    """The port's full-resume file: JAX's `load_ckpt` reads its proxy (and
    fields), and the port resumes it with the proxy's Adam moments; a JAX
    culled checkpoint's proxy loads into the port; the port's fast eval
    setup takes a checkpoint's proxy as the trained one."""
    from nerf_siren_tpu_torch.eval import get_opts, setup_fast_proxy

    system = NeRFSystem(RenderConfig(**dict(RKW, perturb=1.0)), TrainConfig(lr=5e-3),
                        NeRFConfig(**NARROW), train_backend="culled", device="cpu", **SYS_CULL)
    state = system.state_for(port_models(narrow, NARROW))
    rays, rgbs = _rays(16, 8)
    state, _ = system.train_step(state, {"rays": rays, "rgbs": rgbs}, seed=3)
    path = str(tmp_path / "port.msgpack")
    ckpt.save_train_state(path, state, 1, "adam")
    jproxy = jckpt.load_ckpt(numpy_tree(jfast.init_proxy, 64, seed=9), path, "proxy")
    want = proxy_to_jax(state.models["proxy"].state_dict())
    for layer in ("l1", "l2"):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(jproxy[layer][k]), want[layer][k])
    back = system.state_for(port_models(jax_params(NARROW, seed=11), NARROW))
    back, epoch = ckpt.restore_train_state(path, back, "adam")
    assert epoch == 1 and back.step == 1
    for (_, _, a), (_, _, b) in zip(parameters(state.models), parameters(back.models)):
        assert torch.equal(a, b)
    for slot in ("mu", "nu"):
        for a, b in zip(state.opt_state[slot], back.opt_state[slot]):
            assert torch.equal(a, b), slot

    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(jpath, {"params": {"nerf_coarse": narrow["coarse"],
                                             "nerf_fine": narrow["fine"],
                                             "proxy": narrow["proxy"]}})
    proxy = ckpt.load_ckpt(Proxy(64), jpath, "proxy")
    for name, v in proxy_from_jax(narrow["proxy"]).items():
        assert torch.equal(proxy.state_dict()[name], v)

    hp = get_opts(["--root_dir", str(tmp_path), "--ckpt_path", path, "--renderer", "fast",
                   "--device", "cpu"])
    models = {k: m for k, m in back.models.items() if k != "proxy"}
    setup = setup_fast_proxy(models, hp, np.array([2.0, 6.0], np.float32))
    assert "reusing the online culled-training proxy" in capsys.readouterr().out
    for name, v in state.models["proxy"].state_dict().items():
        assert torch.equal(setup.proxy.state_dict()[name], v)
    assert not os.path.exists(path + ".proxy.msgpack")


def test_train_cli_culled_checkpoint_feeds_both_fast_evals(tmp_path, capsys, monkeypatch):
    """`train --train_backend culled` (full width, 12 steps in groups of 4)
    logs the proxy loss and saves the proxy, which JAX's `eval.py` and the
    port's `eval --renderer fast` both take as the trained proxy (no
    distillation) and render with to PSNRs within 0.1 dB (JAX on its Pallas
    kernels in interpret mode with tests/test_torch_fast_eval.py's tiles)."""
    import glob

    from eval import get_opts as jax_eval_opts, main as jax_eval
    from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
    from nerf_siren_tpu.ops.pallas import proxy_march as jpm
    from nerf_siren_tpu_torch import eval as port_eval
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.render import fast
    from nerf_siren_tpu_torch.train import main
    from tests.datasets_synthetic import make_blender_dataset
    from tests.test_torch_eval import _run

    monkeypatch.setattr(jfm, "TILE_N", 128)
    monkeypatch.setattr(jpm, "TILE_R", 256)
    monkeypatch.setattr(fast, "TILE_R", 256)
    scene = make_blender_dataset(str(tmp_path / "scene"), hw=8)
    state = _run(main, get_opts, tmp_path, [
        "--root_dir", scene, "--img_wh", "8", "8", "--N_samples", "8", "--N_importance", "8",
        "--batch_size", "32", "--num_epochs", "1", "--train_backend", "culled",
        "--steps_per_dispatch", "4", "--exp_name", "culled", "--device", "cpu"])
    assert state.step == 12 and "train/proxy_loss" in capsys.readouterr().out
    (path,) = glob.glob(str(tmp_path / "ckpts" / "culled" / "*.msgpack"))
    common = ["--root_dir", scene, "--img_wh", "8", "8", "--N_samples", "8",
              "--N_importance", "8", "--ckpt_path", path, "--scene_name", "s",
              "--renderer", "fast", "--fast_candidates", "16", "--fast_keep", "8"]
    psnrs = []
    for run, opts, extra in ((jax_eval, jax_eval_opts, []),
                             (port_eval.main, port_eval.get_opts, ["--device", "cpu"])):
        (tmp_path / str(len(psnrs))).mkdir()
        psnrs.append(_run(run, opts, tmp_path / str(len(psnrs)), common + extra))
        assert "reusing the online culled-training proxy" in capsys.readouterr().out
    assert np.isfinite(psnrs).all() and abs(psnrs[0] - psnrs[1]) < 0.1, psnrs
    assert not os.path.exists(path + ".proxy.msgpack")
