"""The port's SIREN field (`models/siren.py`, `NeRFSystem(field_type='siren')`)
against the JAX package's, on the CPU, weights crossing through
`convert.siren_from_jax` / `siren_to_jax`.

Tolerances and why:
- the field (hidden 32, 3 FiLM layers, z 8, with and without the parse
  head): atol 1e-5. The same float32 sines and products; the arguments
  reach tens of radians (frequencies about 30), where a 1-ulp difference
  in a product moves a sine by ~4e-6 at most (measured 2e-7).
- one training step (perturb 0, noise 0, the same weights and batch):
  loss and PSNR rtol 1e-5; every gradient within a relative L2 of 1e-4
  (measured 4e-6: no positional encoding amplifies the sample positions'
  fused multiply-add, as it does for the MLP field); the parameters after
  the step within atol 1e-6 of optax's Adam applied to the port's own
  gradients (Adam's first step moves a weight by about lr whatever its
  gradient, so it is held to the update rule, not to JAX's gradients).
- the init bounds and the tree round trip: exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.models import siren as jsiren
from nerf_siren_tpu.render.rendering import render_rays as j_render_rays
from nerf_siren_tpu.training import losses as jlosses
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import siren_from_jax, siren_to_jax
from nerf_siren_tpu_torch.models.siren import SirenNeRF, siren_field_fn
from nerf_siren_tpu_torch.training.system import NeRFSystem
from tests.test_torch_semantic import one_torch_thread  # noqa: F401

SMALL = dict(hidden_dim=32, n_layers=3, z_dim=8)
SIREN_KW = dict(siren_hidden=32, siren_layers=3, siren_z_dim=8, siren_box_warp=4.4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _siren(params, n_classes=0, box=4.4):
    model = SirenNeRF(**SMALL, n_classes=n_classes, box_sidelength=box)
    model.load_state_dict(siren_from_jax(_np(params)))
    return model


@pytest.mark.parametrize("n_classes", [0, 3])
def test_siren_field_matches_jax(n_classes):
    params = jsiren.init_siren_nerf(jax.random.PRNGKey(0), 32, 3, 8, n_classes=n_classes)
    model = _siren(params, n_classes)
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-2.5, 2.5, (6, 9, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 9, 3)).astype(np.float32)
    want = jsiren.apply_siren_nerf(params, xyz, dirs, hidden_dim=32, box_sidelength=4.4)
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), torch.from_numpy(dirs))
    assert got.shape == (6, 9, 4 + n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    # render_rays' field_fn: raw directions from the embedding's passthrough,
    # zero directions for the sigma-only pass
    dir_emb = np.concatenate([dirs[:, 0], rng.normal(size=(6, 24)).astype(np.float32)], -1)
    for emb in (dir_emb, None):
        want = jsiren.siren_field_fn(params, xyz, emb, hidden_dim=32, box_sidelength=4.4)
        with torch.no_grad():
            got = siren_field_fn(model, torch.from_numpy(xyz),
                                 None if emb is None else torch.from_numpy(emb))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_siren_init_bounds_and_tree_round_trip():
    model = SirenNeRF(**SMALL, n_classes=2, generator=torch.Generator().manual_seed(0))
    assert model.network[0].weight.abs().max() <= 1.0 / 3
    for layer in list(model.network[1:]) + [model.final_layer, model.color_layer_linear]:
        assert layer.weight.abs().max() <= np.sqrt(6.0 / 32) / 25
    assert model.color_layer_sine.weight.abs().max() <= np.sqrt(6.0 / 35) / 25
    assert model.mapping[2].weight.shape == (4 * 32 * 2, 256) and model.z.shape == (1, 8)
    tree = siren_to_jax(model.state_dict())
    ref = jsiren.init_siren_nerf(jax.random.PRNGKey(0), 32, 3, 8, n_classes=2)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(_np(ref))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(_np(ref))):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = siren_from_jax(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    return {"rays": rays, "rgbs": rng.uniform(size=(n, 3)).astype(np.float32)}


def test_siren_train_step_matches_jax_system():
    rkw = dict(n_samples=16, n_importance=16, perturb=0.0, noise_std=0.0, white_back=True)
    tkw = dict(lr=5e-4, batch_size=64, decay_step=(20,))
    jsys = JNeRFSystem(JRenderConfig(**rkw), JTrainConfig(**tkw), JNeRFConfig(),
                       steps_per_epoch=10, field_type="siren", **SIREN_KW)
    jstate = jsys.init_state(jax.random.PRNGKey(0))
    jparams = _np(jstate.params)
    batch, key = _batch(), jax.random.PRNGKey(1)

    def jloss(p):
        out = j_render_rays(p, jnp.asarray(batch["rays"]), jsys.render_cfg, key,
                            nerf_cfg=jsys.nerf_cfg, field_fn=jsys._field_fn())
        return jlosses.mse_loss(out, jnp.asarray(batch["rgbs"]))["sum"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    jstate, jmetrics = jsys.train_step(jstate, batch, key)

    system = NeRFSystem(RenderConfig(**rkw), TrainConfig(**tkw), NeRFConfig(),
                        steps_per_epoch=10, device="cpu", field_type="siren", **SIREN_KW)
    state = system.state_for({k: _siren(v) for k, v in jparams.items()})
    assert isinstance(system.init_state(0).models["fine"], SirenNeRF)
    rays, rgbs = torch.from_numpy(batch["rays"]), torch.from_numpy(batch["rgbs"])
    losses, _, grads = system.loss_and_grads(state, rays, rgbs, None)
    np.testing.assert_allclose(float(losses["sum"].detach()), float(ref_loss), rtol=1e-5)
    names = [(k, n) for k in sorted(state.models) for n, _ in state.models[k].named_parameters()]
    want = {k: siren_from_jax(_np(v)) for k, v in ref_grads.items()}
    for (k, n), g in zip(names, grads):
        rel = float((g - want[k][n]).norm() / want[k][n].norm().clamp_min(1e-12))
        assert rel < 1e-4, f"{k} {n}: relative L2 {rel:.2e}"

    state, metrics = system.train_step(state, batch, seed=1)
    for name in ("train/loss", "train/psnr"):
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-5)
    port_grads = {k: siren_to_jax({n: g for (kk, n), g in zip(names, grads) if kk == k})
                  for k in state.models}
    updates, _ = jsys.tx.update(port_grads, jsys.tx.init(jparams), jparams)
    want_params = optax.apply_updates(jparams, updates)
    for k, model in state.models.items():
        ref = siren_from_jax(_np(want_params[k]))
        for n, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{k} {n}")


def test_siren_grouped_steps_equal_train_steps_and_fused_is_refused():
    """`train_scan_batches` on the CPU (the captured graph's loop) takes the
    same steps as `train_step`, bit for bit; the fused backend (K2, the MLP
    field) refuses the SIREN field, as JAX's assert does."""
    rkw = dict(n_samples=8, n_importance=8, perturb=1.0, noise_std=1.0)
    system = NeRFSystem(RenderConfig(**rkw), TrainConfig(lr=1e-3, batch_size=32), NeRFConfig(),
                        steps_per_epoch=10, device="cpu", field_type="siren", **SIREN_KW)
    eager = system.init_state(3)
    grouped = system.state_for({k: _siren(siren_to_jax(m.state_dict()))
                                for k, m in eager.models.items()})
    batches = [_batch(32, seed) for seed in range(3)]
    for b in batches:
        eager, m = system.train_step(eager, b, seed=5)
    grouped, mg = system.train_scan_batches(grouped, np.stack([b["rays"] for b in batches]),
                                            np.stack([b["rgbs"] for b in batches]), seed=5)
    assert float(mg["train/loss"]) == float(m["train/loss"])
    for k in eager.models:
        for (n, a), (_, b) in zip(eager.models[k].state_dict().items(),
                                  grouped.models[k].state_dict().items()):
            assert torch.equal(a, b), (k, n)
    with pytest.raises(ValueError, match="MLP field"):
        NeRFSystem(train_backend="fused", field_type="siren", device="cpu")
