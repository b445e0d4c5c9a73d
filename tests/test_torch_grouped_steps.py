"""The port's grouped and accumulating training steps on the CPU: the
pre-drawn step noise, the optimizer's device-scalar update, the grouped
steps' loop (the plain version of the captured CUDA graph) against
`train_step`, `train_scan_batches` and `train_step_accum` against the JAX
package's, `train_scan` and `train_scan_importance`, the inverse-CDF ray
sampler, and the train CLI's `--steps_per_dispatch`.

Tolerances and why:
- `render_rays` on `draw_noise`'s draws, the device-scalar update (`step`
  and `step_device`) against the update written with host floats, and the
  grouped loop against `train_step`s: bit-equal. The same generator calls
  in the same order, the same float32 operations on the same values.
- against JAX, at perturb 0 and noise 0 from the same weights (the single
  step's bars of `tests/test_torch_training.py`, per step): each step's
  loss and PSNR rtol 1e-5. The parameters after the group are held (atol
  1e-6) to optax's Adam run on the port's own gradients of each step,
  because Adam's first steps move an element by about lr whatever its
  gradient, so a trunk gradient near zero (the sanctioned ~2e-3 relative
  delta of fused sample positions) can flip a step against JAX's.
- `train_step_accum` against the full-batch step, in the port: the JAX
  package's own bars (`tests/test_training.py`): loss rtol 1e-5,
  parameters atol 2e-5 and rtol 1e-4 (micro-batch means reorder the sums).
- the inverse-CDF sampler's frequencies: within 5 binomial standard
  deviations of (err + 1e-8)^alpha mixed with the uniform floor, at a fixed
  seed.
- the CLI with `--steps_per_dispatch 4`: the same checkpoint bytes of
  weights and moments as `--steps_per_dispatch 1` (the grouped loop is
  bit-equal to the steps).
"""
import copy
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.render.rendering import draw_noise, noise_shapes, render_rays
from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint
from nerf_siren_tpu_torch.training.graphs import importance_indices
from nerf_siren_tpu_torch.training.optimizers import (B1, B2, LOOKAHEAD_PERIOD, LOOKAHEAD_STEP,
                                                      Optimizer, _pow_f32, _radam_rect_f32)
from nerf_siren_tpu_torch.training.system import (NeRFSystem, draw_step_noise, parameters,
                                                  step_generator)
from tests.test_torch_rendering import with_density
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(depth=4, width=32, skips=(2,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(n, seed, origin_scale=0.2):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * origin_scale, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    return rays, rng.uniform(size=(n, 3)).astype(np.float32)


def _params_equal(a, b):
    return all(torch.equal(x, y) for (_, _, x), (_, _, y) in zip(parameters(a), parameters(b)))


# ---- the step's draws, made beforehand ------------------------------------------

@pytest.mark.parametrize("perturb,noise_std,n_importance,test_time", [
    (1.0, 1.0, 8, False), (1.0, 0.0, 8, False), (0.0, 1.0, 8, False), (1.0, 1.0, 0, False),
    (-1.0, 1.0, 8, False), (1.0, 1.0, 8, True)])
def test_render_rays_on_drawn_noise_is_bit_equal_to_the_generator(perturb, noise_std,
                                                                  n_importance, test_time):
    cfg = RenderConfig(n_samples=8, n_importance=n_importance, perturb=perturb,
                       noise_std=noise_std, white_back=True, test_time=test_time)
    gen = torch.Generator().manual_seed(0)
    models = {"coarse": NeRF(NeRFConfig(**NARROW), generator=gen),
              "fine": NeRF(NeRFConfig(**NARROW), generator=gen)}
    rays = torch.from_numpy(_rays(24, 1)[0])
    want = render_rays(models, rays, cfg, step_generator(3, 5, "cpu"))
    noise = draw_step_noise(3, 5, 24, cfg, "cpu")
    assert set(noise) == set(noise_shapes(24, cfg))
    got = render_rays(models, rays, cfg, noise=noise)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="noise"):
        render_rays(models, rays, cfg, step_generator(3, 5, "cpu"), noise=noise)
    if noise:
        with pytest.raises(ValueError, match="noise"):
            render_rays(models, rays, cfg, noise=draw_noise(gen, 23, cfg))


# ---- the optimizer's device-scalar update -------------------------------------

def _host_float_update(opt, params, grads, state):
    """One update with its scalars as host floats and host branches: the
    rule `Optimizer` applied before it read them from a device row, the form
    `tests/test_torch_training.py` holds to optax."""
    cfg = opt.cfg
    lr = opt.schedule(state["count"])
    grads = [g + cfg.weight_decay * p if cfg.weight_decay else g for p, g in zip(params, grads)]
    state["count"] += 1
    t = state["count"]
    if cfg.optimizer == "sgd":
        updates = []
        for g, tr in zip(grads, state["trace"]):
            tr.mul_(cfg.momentum).add_(g)
            updates.append(-lr * tr)
    else:
        mu_corr = float(np.float32(1) - _pow_f32(B1, t))
        nu_corr = float(np.float32(1) - _pow_f32(B2, t))
        rect = _radam_rect_f32(t) if cfg.optimizer in ("radam", "ranger") else None
        updates = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            m_hat = mu / mu_corr
            if rect == 0.0:
                u = m_hat
            else:
                u = m_hat / ((nu / nu_corr).sqrt() + 1e-8)
                if rect is not None:
                    u = rect * u
            updates.append(-lr * u)
    if cfg.optimizer == "ranger":
        state["la_count"] += 1
        if state["la_count"] % LOOKAHEAD_PERIOD == 0:
            for p, u, slow in zip(params, updates, state["slow"]):
                slow.add_(p + u - slow, alpha=LOOKAHEAD_STEP)
                p.copy_(slow)
            return
    for p, u in zip(params, updates):
        p.add_(u)


@pytest.mark.parametrize("case", [
    dict(optimizer="sgd", lr_scheduler="poly", warmup_epochs=2, warmup_multiplier=4.0),
    dict(optimizer="adam", lr_scheduler="steplr", weight_decay=0.01),
    dict(optimizer="radam", lr_scheduler="cosine"),
    dict(optimizer="ranger", lr_scheduler="cosine", weight_decay=0.01),
], ids=lambda c: c["optimizer"])
def test_device_scalar_update_is_bit_equal_to_step(case):
    """7 steps across two epoch boundaries: RAdam's rectification turns on
    (rho_t >= 5 from step 6) and ranger syncs its slow weights at step 6.
    `step` (one row at a time) and `step_device` on a group's table, both
    against the update written with host floats."""
    cfg = TrainConfig(lr=1e-2, decay_step=(1, 2), decay_gamma=0.5, num_epochs=4, **case)
    opt = Optimizer(cfg, 3)
    rng = np.random.default_rng(1)
    start = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((5, 3), (7,))]
    a, b, c = ([p.clone() for p in start] for _ in range(3))
    sa, sb, sc = opt.init(a), opt.init(b), opt.init(c)
    table = torch.from_numpy(opt.scalar_table(sb, 7))
    addresses = [p.data_ptr() for p in b + c]
    for k in range(7):
        grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in start]
        _host_float_update(opt, a, grads, sa)
        opt.step_device(b, grads, sb, table[k])
        opt.step(c, grads, sc)
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z), f"step {k}"
    opt.advance(sb, 7)
    for s in (sb, sc):
        assert s["count"] == sa["count"] == 7 and s.get("la_count") == sa.get("la_count")
        for key in ("trace", "mu", "nu", "slow"):
            for x, y in zip(sa.get(key, []), s.get(key, [])):
                assert torch.equal(x, y), key
    assert [p.data_ptr() for p in b + c] == addresses


# ---- the grouped loop against N train_steps --------------------------------------

@pytest.mark.parametrize("backend,nerf,samples,optimizer", [
    ("jnp", NARROW, 8, "ranger"), ("fused", {}, 8, "adam")], ids=["jnp-4x32", "fused-8x256"])
def test_grouped_loop_is_bit_equal_to_train_steps(backend, nerf, samples, optimizer):
    """7 steps (ranger's sync at 6), perturbed and noisy: every draw counts."""
    n = 7 if backend == "jnp" else 3
    system = NeRFSystem(RenderConfig(n_samples=samples, n_importance=samples, perturb=1.0,
                                     noise_std=1.0, white_back=True),
                        TrainConfig(optimizer=optimizer, lr=5e-3, decay_step=(1,)),
                        NeRFConfig(**nerf), steps_per_epoch=2, train_backend=backend,
                        device="cpu")
    eager = system.init_state(0)
    grouped = system.state_for(copy.deepcopy(eager.models))
    batches = [_rays(32, i) for i in range(n)]
    losses = []
    for r, c in batches:
        eager, metrics = system.train_step(eager, {"rays": r, "rgbs": c}, seed=5)
        losses.append(metrics["train/loss"])
    grouped, gm = system.train_scan_batches(grouped, np.stack([b[0] for b in batches]),
                                            np.stack([b[1] for b in batches]), seed=5)
    assert grouped.step == eager.step == n
    assert grouped.opt_state["count"] == eager.opt_state["count"] == n
    assert _params_equal(grouped.models, eager.models)
    for k in ("train/loss", "train/psnr"):
        assert torch.equal(gm[k], metrics[k]), k
    assert torch.equal(system.last_group.steps[:, 0], torch.stack(losses))


# ---- against the JAX package -------------------------------------------------------

RKW = dict(n_samples=16, n_importance=16, perturb=0.0, noise_std=0.0, white_back=True)
TKW = dict(lr=5e-4, batch_size=64, decay_step=(20,))


def _jax_and_port(n_rays=64):
    jsys = JNeRFSystem(JRenderConfig(**RKW), JTrainConfig(**TKW), JNeRFConfig(**NARROW),
                       steps_per_epoch=10)
    jstate = jsys.init_state(jax.random.PRNGKey(0))
    jparams = {k: with_density(v) for k, v in _np(jstate.params).items()}
    jstate = jstate.replace(params=jax.device_put(jparams), opt_state=jsys.tx.init(jparams))
    system = NeRFSystem(RenderConfig(**RKW), TrainConfig(**TKW), NeRFConfig(**NARROW),
                        steps_per_epoch=10, device="cpu")
    models = {}
    for k, p in jparams.items():
        models[k] = NeRF(NeRFConfig(**NARROW))
        models[k].load_state_dict(nerf_from_jax(p))
    return jsys, jstate, system, system.state_for(models)


def _port_grads(system, state, rays, rgbs):
    _, _, grads = system.loss_and_grads(state, torch.from_numpy(rays), torch.from_numpy(rgbs),
                                        None)
    return [g.numpy() for g in grads]


def _optax_on(jsys, state, grads_per_step):
    """The parameters the JAX system's optax Adam reaches from `state`'s on
    the given gradients (flat lists in `parameters` order)."""
    tx = jsys.tx
    params = [p.detach().numpy().copy() for _, _, p in parameters(state.models)]
    opt = tx.init(params)
    for grads in grads_per_step:
        upd, opt = tx.update([jnp.asarray(g) for g in grads], opt, params)
        params = [np.asarray(p + u) for p, u in zip(params, upd)]
    return params


def test_train_scan_batches_matches_jax():
    jsys, jstate, system, state = _jax_and_port()
    batches = [_rays(64, 10 + i) for i in range(3)]
    key = jax.random.PRNGKey(1)
    jlosses = []
    jstep = jax.tree_util.tree_map(jnp.copy, jstate)   # train_step donates its state
    for r, c in batches:
        jstep, m = jsys.train_step(jstep, {"rays": r, "rgbs": c}, key)
        jlosses.append((float(m["train/loss"]), float(m["train/psnr"])))
    jstate, jm = jsys.train_scan_batches(jstate, np.stack([b[0] for b in batches]),
                                         np.stack([b[1] for b in batches]), key)
    np.testing.assert_allclose(float(jm["train/loss"]), jlosses[-1][0], rtol=1e-5)

    start = copy.deepcopy(state.models)
    walk, grads = system.state_for(copy.deepcopy(start)), []
    for r, c in batches:      # the port's gradients of each step, on its own trajectory
        grads.append(_port_grads(system, walk, r, c))
        walk, _ = system.train_step(walk, {"rays": r, "rgbs": c}, seed=1)
    want = _optax_on(jsys, system.state_for(copy.deepcopy(start)), grads)
    state, m = system.train_scan_batches(state, np.stack([b[0] for b in batches]),
                                         np.stack([b[1] for b in batches]), seed=1)
    assert state.step == 3
    steps = system.last_group.steps.numpy()
    np.testing.assert_allclose(steps, np.asarray(jlosses, np.float32), rtol=1e-5)
    assert float(m["train/loss"]) == steps[-1, 0] and float(m["train/psnr"]) == steps[-1, 1]
    for (k, name, p), w in zip(parameters(state.models), want):
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-6, rtol=0, err_msg=f"{k} {name}")


def test_train_step_accum_matches_jax():
    jsys, jstate, system, state = _jax_and_port()
    r, c = _rays(64, 20)
    jstate, jm = jsys.train_step_accum(jstate, {"rays": r, "rgbs": c}, jax.random.PRNGKey(1),
                                       n_micro=4)
    start = copy.deepcopy(state.models)
    micro = [_port_grads(system, state, r[16 * i:16 * (i + 1)], c[16 * i:16 * (i + 1)])
             for i in range(4)]
    avg = [sum(g[j] / 4 for g in micro) for j in range(len(micro[0]))]
    state, m = system.train_step_accum(state, {"rays": r, "rgbs": c}, seed=1, n_micro=4)
    assert state.step == 1
    for k in ("train/loss", "train/psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = _optax_on(jsys, system.state_for(start), [avg])
    for (k, name, p), w in zip(parameters(state.models), want):
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-6, rtol=0, err_msg=f"{k} {name}")


def test_train_step_accum_matches_full_batch():
    """The JAX package's `test_train_step_accum_matches_full_batch`, in the
    port: the mean of equal micro-batch means is the full mean."""
    def make():
        system = NeRFSystem(RenderConfig(n_samples=8, n_importance=0, perturb=0.0,
                                         noise_std=0.0),
                            TrainConfig(lr=5e-3, batch_size=256, decay_step=(100,)),
                            NeRFConfig(depth=2, width=64), steps_per_epoch=4, device="cpu")
        return system, system.init_state(0)

    rays, rgbs = _rays(256, 9, origin_scale=0.0)
    rgbs = (0.5 + 0.5 * np.tanh(rays[:, 3:6])).astype(np.float32)
    batch = {"rays": rays, "rgbs": rgbs}
    sa, state_a = make()
    state_a, ma = sa.train_step(state_a, batch, seed=1)
    sb, state_b = make()
    state_b, mb = sb.train_step_accum(state_b, batch, seed=1, n_micro=4)
    np.testing.assert_allclose(float(ma["train/loss"]), float(mb["train/loss"]), rtol=1e-5)
    for (_, _, a), (_, _, b) in zip(parameters(state_a.models), parameters(state_b.models)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="n_micro"):
        sb.train_step_accum(state_b, batch, seed=1, n_micro=3)


# ---- pool steps -----------------------------------------------------------------

def _pool_system():
    return NeRFSystem(RenderConfig(n_samples=8, n_importance=0, perturb=1.0, noise_std=1.0),
                      TrainConfig(lr=5e-3, batch_size=128, decay_step=(100,)),
                      NeRFConfig(depth=2, width=128), steps_per_epoch=20, device="cpu")


def test_train_scan_loss_falls():
    """The JAX package's `test_train_scan_matches_train_step_progress`: 2
    steps, then 30 more end below the first group's loss."""
    rays, _ = _rays(512, 0, origin_scale=0.0)
    rgbs = (0.5 + 0.5 * np.tanh(rays[:, 3:6])).astype(np.float32)
    system = _pool_system()
    state = system.init_state(0)
    state, m0 = system.train_scan(state, rays, rgbs, seed=1, n_steps=2)
    state, m1 = system.train_scan(state, rays, rgbs, seed=2, n_steps=30)
    assert state.step == 32 and state.opt_state["count"] == 32
    assert float(m1["train/loss"]) < float(m0["train/loss"])


def test_train_scan_importance_focuses_hard_rays():
    """The JAX package's test of the same name: on a pool whose targets are
    hard only in a small patch, loss-guided sampling reaches no higher an
    error there than the uniform scan at the same step budget."""
    rays, _ = _rays(1024, 5, origin_scale=0.0)
    rgbs = np.full((1024, 3), 0.5, np.float32)
    hard = slice(0, 128)
    rgbs[hard] = (0.5 + 0.5 * np.sin(37.0 * rays[hard, 3:6])).astype(np.float32)

    def run(kind):
        system = NeRFSystem(RenderConfig(n_samples=8, n_importance=0, perturb=1.0,
                                         noise_std=0.0),
                            TrainConfig(lr=5e-3, batch_size=128, decay_step=(100,)),
                            NeRFConfig(depth=2, width=128), steps_per_epoch=40, device="cpu")
        state = system.init_state(0)
        if kind == "importance":
            state, m = system.train_scan_importance(state, rays, rgbs, seed=1, n_steps=40,
                                                    alpha=1.0, uniform_frac=0.2)
        else:
            state, m = system.train_scan(state, rays, rgbs, seed=1, n_steps=40)
        assert np.isfinite(float(m["train/loss"]))
        out = system.render(state.models, rays[hard])
        return float(((out["rgb_coarse"].numpy() - rgbs[hard]) ** 2).mean())

    err_imp, err_uni = run("importance"), run("uniform")
    assert err_imp < err_uni * 1.1, (err_imp, err_uni)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_importance_sampler_frequencies(alpha):
    """The inverse-CDF pick plus the uniform floor, drawn as the grouped
    steps draw it, against p = (1 - f) (e + 1e-8)^alpha / sum + f / P."""
    n_pool, b, frac = 40, 200_000, 0.2
    rng = np.random.default_rng(7)
    err = rng.uniform(0, 1, n_pool).astype(np.float32) ** 3
    err[:5] = 0.0                                           # only the floor reaches these
    gen = torch.Generator().manual_seed(11)
    u_cat = torch.rand(b, generator=gen)
    idx_uni = torch.randint(0, n_pool, (b,), generator=gen)
    take = torch.rand(b, generator=gen) < frac
    idx = importance_indices(torch.from_numpy(err), u_cat, idx_uni, take, alpha)
    freq = np.bincount(idx.numpy(), minlength=n_pool) / b
    w = (err.astype(np.float64) + 1e-8) ** alpha
    p = (1 - frac) * w / w.sum() + frac / n_pool
    sd = np.sqrt(p * (1 - p) / b)
    assert np.all(np.abs(freq - p) <= 5 * sd), np.max(np.abs(freq - p) / sd)


@pytest.mark.parametrize("scale", [1e-4, 1e-6])
def test_importance_sampler_frequencies_at_small_errors(scale):
    """Late in training every error is small: at alpha 2 and errors near
    `scale`, the pick's counts on an even grid of 2^16 draws equal the
    inverse CDF of (e + 1e-8)^alpha within one draw a ray (no weight rounds
    to 0; the pool's weights are scaled by its largest one)."""
    n_pool, b, alpha = 48, 2 ** 16, 2.0
    rng = np.random.default_rng(3)
    err = (scale * rng.uniform(0.2, 3.0, n_pool)).astype(np.float32)
    u_cat = (torch.arange(b, dtype=torch.float32) + 0.5) / b
    never = torch.zeros(b, dtype=torch.bool)
    idx = importance_indices(torch.from_numpy(err), u_cat, torch.zeros(b, dtype=torch.long),
                             never, alpha)
    counts = np.bincount(idx.numpy(), minlength=n_pool)
    w = (err.astype(np.float64) + 1e-8) ** alpha
    want = w / w.sum() * b
    assert np.all(counts > 0)
    np.testing.assert_allclose(counts, want, atol=1.0, rtol=0)


def test_duplicate_draws_keep_the_error_of_their_last_draw():
    """`last_occurrence`: every entry of a duplicated index points at its
    last position, so the error buffer's write is one value per ray
    whatever order a card lands the writes in (the CPU's sequential
    index_put, last wins, gives the same buffer)."""
    from nerf_siren_tpu_torch.training.graphs import last_occurrence

    idx = torch.tensor([3, 0, 3, 5, 0, 3, 7])
    np.testing.assert_array_equal(last_occurrence(idx, 8).numpy(), [5, 4, 5, 3, 4, 5, 6])
    err = torch.arange(7, dtype=torch.float32) / 10
    buf, seq = torch.ones(8), torch.ones(8)
    buf[idx] = err[last_occurrence(idx, 8)]
    for i, e in zip(idx.tolist(), err.tolist()):
        seq[i] = e
    assert torch.equal(buf, seq)


# ---- the train CLI ---------------------------------------------------------------

def test_train_cli_grouped_steps_write_the_eager_checkpoint(tmp_path):
    """6 steps an epoch in groups of 4 (the tail a group of 2) against one
    step a batch, on the synthetic Blender scene with the full-width field."""
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import main
    from tests.datasets_synthetic import make_blender_dataset

    scene = make_blender_dataset(str(tmp_path / "scene"), hw=16)
    args = ["--root_dir", scene, "--dataset_name", "blender", "--img_wh", "16", "16",
            "--N_samples", "4", "--N_importance", "4", "--batch_size", "256", "--lr", "1e-3",
            "--num_epochs", "1", "--device", "cpu"]
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for spd in ("1", "4"):
            state = main(get_opts(args + ["--exp_name", spd, "--steps_per_dispatch", spd]))
            assert state.step == 6
    finally:
        os.chdir(old)
    (a,), (b,) = (glob.glob(str(tmp_path / "ckpts" / e / "*.msgpack")) for e in ("1", "4"))
    a, b = load_checkpoint(a), load_checkpoint(b)
    leaves_a, leaves_b = (jax.tree_util.tree_leaves({k: c[k] for k in ("params", "opt_state")})
                          for c in (a, b))
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(x, y)
