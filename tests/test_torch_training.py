"""The port's training pieces against the JAX package: losses, optimizers
and schedules against optax, one `NeRFSystem.train_step` of the `jnp`
backend against the JAX `NeRFSystem`, the `fused` backend against `jnp`,
the epoch iterator, and checkpoints both packages read.

Tolerances and why:
- losses 1e-6 relative: the same float32 reductions.
- optimizers: rtol 1e-5 / atol 1e-7 on the parameters after each of 10
  steps: the same update rules in float32, only rounding order differs.
- one `jnp` step (narrow field, perturb 0, noise 0, the same weights and
  batch): loss rtol 1e-5; each gradient relative L2 below 5e-3. Float32
  on both sides, but XLA fuses the sample positions' multiply-add and
  PyTorch does not: a 1-ulp difference in a point becomes ~6e-5 in
  sin(2^9 x), which moves the trunk's gradients by up to ~2e-3 (relative
  L2; the heads agree to ~1e-6, and the fields alone agree to ~3e-7 on
  one embedding). Adam's first step moves a weight by
  lr * g / (|g| + 1e-8), about lr whatever |g|, so a gradient element near
  zero can flip the step: the parameters after the step are held (atol
  1e-6) to optax's Adam applied to the port's own gradients, and the
  step's loss and PSNR to the JAX step's (rtol 1e-5). The fields get
  density along every ray (`with_density`) so the sanctioned u = 1
  sample_pdf tie cannot move a fine sample.
- `fused` vs `jnp` first-step loss: rtol 2e-2, the JAX package's own bar
  (the fused field computes in bf16).
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
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.render.rendering import render_rays as j_render_rays
from nerf_siren_tpu.training import checkpoints as jckpt
from nerf_siren_tpu.training import losses as jlosses
from nerf_siren_tpu.training.optimizers import get_optimizer, make_lr_schedule
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu.training.system import epoch_iterator as j_epoch_iterator
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_from_jax, nerf_to_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.training import checkpoints as ckpt
from nerf_siren_tpu_torch.training import losses
from nerf_siren_tpu_torch.training.optimizers import Optimizer
from nerf_siren_tpu_torch.training.optimizers import make_lr_schedule as t_schedule
from nerf_siren_tpu_torch.training.system import NeRFSystem, epoch_iterator
from tests.test_torch_rendering import with_density
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(depth=4, width=64, skips=(2,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- losses -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "msece", "msenll"])
@pytest.mark.parametrize("fine", [False, True])
def test_losses_match_jax(name, fine):
    rng = np.random.default_rng(0)
    n, c = 64, 5
    out = {"rgb_coarse": rng.uniform(size=(n, 3)), "cls_coarse": rng.normal(size=(n, c))}
    if fine:
        out.update(rgb_fine=rng.uniform(size=(n, 3)), cls_fine=rng.normal(size=(n, c)))
    if name == "msenll":
        out = {k: (v - np.log(np.exp(v).sum(-1, keepdims=True)) if k.startswith("cls") else v)
               for k, v in out.items()}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    labels = rng.integers(-1, c, n).astype(np.int32)
    ref = jlosses.loss_dict[name]({k: jnp.asarray(v) for k, v in out.items()},
                                  jnp.asarray(target), cls_target=jnp.asarray(labels))
    got = losses.loss_dict[name]({k: torch.from_numpy(v) for k, v in out.items()},
                                 torch.from_numpy(target), cls_target=torch.from_numpy(labels))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)


# ---- optimizers and schedules -----------------------------------------------

OPT_CASES = [
    dict(optimizer="sgd", lr_scheduler="steplr"),
    dict(optimizer="sgd", lr_scheduler="poly", warmup_epochs=2, warmup_multiplier=4.0),
    dict(optimizer="adam", lr_scheduler="steplr", weight_decay=0.01),
    dict(optimizer="adam", lr_scheduler="cosine", warmup_epochs=1),
    dict(optimizer="adam", lr_scheduler="poly"),
    dict(optimizer="radam", lr_scheduler="steplr"),
    dict(optimizer="ranger", lr_scheduler="cosine", weight_decay=0.01),
]
STEPS_PER_EPOCH = 3


def _train_cfg(**kw):
    base = dict(lr=1e-2, decay_step=(1, 2), decay_gamma=0.5, num_epochs=4)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_schedule_matches_jax(case):
    jcfg, tcfg = _train_cfg(**case)
    ref, got = make_lr_schedule(jcfg, STEPS_PER_EPOCH), t_schedule(tcfg, STEPS_PER_EPOCH)
    for step in range(14):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("case", OPT_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_optimizer_matches_optax(case):
    """10 steps across three epoch boundaries, the same gradients fed to
    both (ranger syncs its slow weights at step 6)."""
    jcfg, tcfg = _train_cfg(**case)
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = get_optimizer(jcfg, STEPS_PER_EPOCH)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = Optimizer(tcfg, STEPS_PER_EPOCH)
    tstate = opt.init(tp)
    for step in range(10):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, [torch.from_numpy(grads[k]) for k in ("a", "b")], tstate)
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after step {step}")


def test_unknown_optimizer_is_rejected():
    with pytest.raises(ValueError, match="optimizer"):
        Optimizer(TrainConfig(optimizer="lamb"), 1)


# ---- one training step against the JAX NeRFSystem ----------------------------

def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    rgbs = rng.uniform(size=(n, 3)).astype(np.float32)
    return {"rays": rays, "rgbs": rgbs}


def _models(jparams, cfg):
    models = {}
    for k, p in jparams.items():
        models[k] = NeRF(cfg)
        models[k].load_state_dict(nerf_from_jax(_np(p)))
    return models


def test_jnp_train_step_matches_jax_system():
    rkw = dict(n_samples=16, n_importance=16, perturb=0.0, noise_std=0.0, white_back=True)
    tkw = dict(lr=5e-4, batch_size=64, decay_step=(20,))
    jsys = JNeRFSystem(JRenderConfig(**rkw), JTrainConfig(**tkw), JNeRFConfig(**NARROW),
                       steps_per_epoch=10)
    jstate = jsys.init_state(jax.random.PRNGKey(0))
    jparams = {k: with_density(v) for k, v in _np(jstate.params).items()}
    jstate = jstate.replace(params=jax.device_put(jparams), opt_state=jsys.tx.init(jparams))
    batch = _batch()
    key = jax.random.PRNGKey(1)

    def jloss(p):
        out = j_render_rays(p, jnp.asarray(batch["rays"]), jsys.render_cfg, key,
                            nerf_cfg=jsys.nerf_cfg)
        return jlosses.mse_loss(out, jnp.asarray(batch["rgbs"]))["sum"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    jstate, jmetrics = jsys.train_step(jstate, batch, key)

    cfg = NeRFConfig(**NARROW)
    system = NeRFSystem(RenderConfig(**rkw), TrainConfig(**tkw), cfg, steps_per_epoch=10,
                        device="cpu")
    state = system.state_for(_models(jparams, cfg))
    rays, rgbs = torch.from_numpy(batch["rays"]), torch.from_numpy(batch["rgbs"])
    tl, _, grads = system.loss_and_grads(state, rays, rgbs, None)
    np.testing.assert_allclose(float(tl["sum"].detach()), float(ref_loss), rtol=1e-5)
    names = [(k, n) for k in sorted(state.models) for n, _ in state.models[k].named_parameters()]
    want = {k: nerf_from_jax(_np(v)) for k, v in ref_grads.items()}
    for (k, n), g in zip(names, grads):
        b = want[k][n]
        rel = float((g - b).norm() / b.norm().clamp_min(1e-12))
        assert rel < 5e-3, f"{k} {n}: relative L2 {rel:.2e}"

    state, metrics = system.train_step(state, batch, seed=1)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["train/loss"]), float(jmetrics["train/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["train/psnr"]), float(jmetrics["train/psnr"]),
                               rtol=1e-5)
    # the update itself: optax's Adam applied to the port's gradients
    port_grads = {k: nerf_to_jax({n: g for (kk, n), g in zip(names, grads) if kk == k})
                  for k in state.models}
    updates, _ = jsys.tx.update(port_grads, jsys.tx.init(jparams), jparams)
    want_params = optax.apply_updates(jparams, updates)
    for k, model in state.models.items():
        ref = nerf_from_jax(_np(want_params[k]))
        for n, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{k} {n}")


def _toy_batch(n=128, seed=11):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([np.zeros((n, 3), np.float32), d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], -1)
    return {"rays": rays, "rgbs": (0.5 + 0.5 * np.tanh(d)).astype(np.float32)}


def test_fused_backend_trains_and_agrees_with_jnp():
    """Full-width field (K2's topology; the plain K2 on the CPU): the first
    step's loss within 2e-2 of the `jnp` backend from the same weights and
    batch, and the loss falls over 8 steps."""
    batch = _toy_batch()

    def make(backend):
        system = NeRFSystem(RenderConfig(n_samples=8, n_importance=8, perturb=1.0,
                                         noise_std=0.0),
                            TrainConfig(lr=1e-3, batch_size=128, decay_step=(100,)),
                            NeRFConfig(), steps_per_epoch=8, train_backend=backend,
                            device="cpu")
        return system, system.init_state(seed=0)

    sys_f, state_f = make("fused")
    sys_j, state_j = make("jnp")
    state_f, mf = sys_f.train_step(state_f, batch, seed=1)
    state_j, mj = sys_j.train_step(state_j, batch, seed=1)
    np.testing.assert_allclose(float(mf["train/loss"]), float(mj["train/loss"]), rtol=2e-2)
    loss = [float(mf["train/loss"])]
    for _ in range(7):
        state_f, mf = sys_f.train_step(state_f, batch, seed=1)
        loss.append(float(mf["train/loss"]))
    assert np.isfinite(loss).all() and loss[-1] < loss[0], loss


def test_system_rejects_what_the_port_lacks():
    # slice 6 ported the culled backends: they refuse what JAX's refuse
    with pytest.raises(ValueError, match="fine network"):
        NeRFSystem(RenderConfig(n_importance=0), train_backend="culled", device="cpu")
    with pytest.raises(ValueError, match="reference 8x256"):
        NeRFSystem(nerf_cfg=NeRFConfig(**NARROW), train_backend="culled_fused", device="cpu")
    with pytest.raises(ValueError, match="reference 8x256"):
        NeRFSystem(nerf_cfg=NeRFConfig(**NARROW), train_backend="fused", device="cpu")


def test_epoch_iterator_matches_jax():
    rng = np.random.default_rng(3)
    rays = rng.normal(size=(1000, 8)).astype(np.float32)
    rgbs = rng.uniform(size=(1000, 3)).astype(np.float32)
    ref = list(j_epoch_iterator(rays, rgbs, 96, seed=5, epoch=2))
    got = list(epoch_iterator(rays, rgbs, 96, seed=5, epoch=2))
    assert len(got) == len(ref) == 10
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["rays"], b["rays"])
        np.testing.assert_array_equal(a["rgbs"], b["rgbs"])


# ---- checkpoints --------------------------------------------------------------

def _narrow_system(optimizer="adam"):
    return NeRFSystem(RenderConfig(n_samples=8, n_importance=8, perturb=1.0, noise_std=1.0),
                      TrainConfig(optimizer=optimizer, lr=5e-3, decay_step=(100,)),
                      NeRFConfig(**NARROW), steps_per_epoch=4, device="cpu")


def test_port_checkpoint_loads_in_jax(tmp_path):
    system = _narrow_system()
    state = system.init_state(seed=3)
    state, _ = system.train_step(state, _batch(32), seed=0)
    path = str(tmp_path / "port.msgpack")
    ckpt.save_train_state(path, state, epoch=1, optimizer="adam")
    template = init_nerf(jax.random.PRNGKey(9), JNeRFConfig(**NARROW))
    for key, name in (("coarse", "nerf_coarse"), ("fine", "nerf_fine")):
        loaded = _np(jckpt.load_ckpt(template, path, name))
        want = nerf_to_jax(state.models[key].state_dict())
        for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    raw = jckpt.load_checkpoint(path)
    assert int(raw["step"]) == 1 and int(raw["epoch"]) == 1


@pytest.mark.parametrize("optimizer", ["adam", "ranger"])
def test_resume_reproduces_the_next_step_exactly(tmp_path, optimizer):
    """Perturb 1 and noise 1: the next step's draws come from (seed, step),
    so a resumed run takes exactly the step the uninterrupted one takes."""
    system = _narrow_system(optimizer)
    batches = [_batch(32, seed=s) for s in range(3)]
    state = system.init_state(seed=3)
    for b in batches[:2]:
        state, _ = system.train_step(state, b, seed=7)
    path = str(tmp_path / "resume.msgpack")
    checkpointer = ckpt.AsyncCheckpointer()
    checkpointer.save_train_state(path, state, epoch=1, optimizer=optimizer)
    checkpointer.close()
    state, m_a = system.train_step(state, batches[2], seed=7)

    fresh = system.init_state(seed=99)
    fresh, epoch = ckpt.restore_train_state(path, fresh, optimizer)
    assert (epoch, fresh.step) == (1, 2)
    fresh, m_b = system.train_step(fresh, batches[2], seed=7)
    assert float(m_a["train/loss"]) == float(m_b["train/loss"])
    for k in state.models:
        for (n, a), b in zip(state.models[k].state_dict().items(),
                             fresh.models[k].state_dict().values()):
            assert torch.equal(a, b), f"{k} {n}"
    with pytest.raises(ValueError, match="optimizer"):
        ckpt.restore_train_state(path, system.init_state(seed=1), "sgd")
