"""The port's LLFF loader and NDC rays against the JAX package's, on the
synthetic forward-facing capture of `tests/datasets_synthetic.py`, and one
training step on its NDC rays against the JAX `NeRFSystem`'s.

Tolerances and why:
- rays and rgbs of every split, with and without `spheric_poses`: atol
  1e-6. Both packages build the camera directions and world rays with
  their C++ helper libraries where they load (the same source and flags:
  equal rays, `tests/test_torch_native.py`), and in numpy where they do
  not, which rounds the direction's normalisation differently from the
  helper (up to ~3e-7 on NDC rays here); the images are read by the same
  PIL calls (exact).
- `get_ndc_rays`: atol 1e-6, the same numpy expressions.
- one NDC step (narrow field, perturb 0, noise 0, the same weights and
  batch): the single step's bars of `tests/test_torch_training.py`: loss
  and PSNR rtol 1e-5, each gradient relative L2 below 5e-3 (XLA fuses the
  sample positions' multiply-add, PyTorch does not), and the parameters
  after the step within atol 1e-6 of optax's Adam on the port's own
  gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.datasets import ray_utils as jrays
from nerf_siren_tpu.datasets.llff import LLFFDataset as JLLFFDataset
from nerf_siren_tpu.render.rendering import render_rays as j_render_rays
from nerf_siren_tpu.training import losses as jlosses
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.datasets import ray_utils
from nerf_siren_tpu_torch.datasets.llff import LLFFDataset
from nerf_siren_tpu_torch.training.system import parameters
from tests.datasets_synthetic import make_llff_dataset
from tests.test_torch_grouped_steps import _jax_and_port, _optax_on

WH = (40, 30)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_llff_dataset(str(tmp_path_factory.mktemp("llff")), hw=WH)


@pytest.mark.parametrize("spheric", [False, True], ids=["ndc", "spheric"])
def test_llff_loader_matches_jax(scene, spheric):
    for split in ("train", "val", "test"):
        ref = JLLFFDataset(scene, split=split, img_wh=WH, spheric_poses=spheric)
        got = LLFFDataset(scene, split=split, img_wh=WH, spheric_poses=spheric)
        assert len(got) == len(ref) and got.white_back == ref.white_back, split
        if split == "train":
            np.testing.assert_allclose(got.all_rays, ref.all_rays, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(got.all_rgbs, ref.all_rgbs)
            continue
        for idx in {0, len(ref) - 1}:
            a, b = got[idx], ref[idx]
            assert set(a) == set(b), split
            np.testing.assert_allclose(a["rays"], b["rays"], rtol=0, atol=1e-6,
                                       err_msg=f"{split} {idx}")
            np.testing.assert_allclose(a["c2w"], b["c2w"], rtol=0, atol=1e-6)
            if "rgbs" in b:
                np.testing.assert_array_equal(a["rgbs"], b["rgbs"])
    if not spheric:   # NDC: the rays span t in [0, 1] from the near plane
        rays = LLFFDataset(scene, split="train", img_wh=WH).all_rays
        assert np.all(rays[:, 6] == 0.0) and np.all(rays[:, 7] == 1.0)


@pytest.mark.parametrize("h,w,focal,near", [(30, 40, 48.0, 1.0), (378, 504, 407.5, 1.0),
                                            (17, 23, 20.0, 0.5)])
def test_get_ndc_rays_matches_jax(h, w, focal, near):
    rng = np.random.default_rng(h)
    o = rng.normal(size=(257, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.1                 # forward-facing: toward -z
    for got, ref in zip(ray_utils.get_ndc_rays(h, w, focal, near, o, d),
                        jrays.get_ndc_rays(h, w, focal, near, o, d)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


def test_ndc_train_step_matches_jax(scene):
    ds = LLFFDataset(scene, split="train", img_wh=WH)
    idx = np.random.default_rng(0).choice(len(ds.all_rays), 64, replace=False)
    batch = {"rays": ds.all_rays[idx], "rgbs": ds.all_rgbs[idx]}
    jsys, jstate, system, state = _jax_and_port()
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    key = jax.random.PRNGKey(1)

    def jloss(p):
        out = j_render_rays(p, jnp.asarray(batch["rays"]), jsys.render_cfg, key,
                            nerf_cfg=jsys.nerf_cfg)
        return jlosses.mse_loss(out, jnp.asarray(batch["rgbs"]))["sum"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    jstate, jm = jsys.train_step(jstate, batch, key)

    losses, _, grads = system.loss_and_grads(state, torch.from_numpy(batch["rays"]),
                                             torch.from_numpy(batch["rgbs"]), None)
    np.testing.assert_allclose(float(losses["sum"].detach()), float(ref_loss), rtol=1e-5)
    want = {k: nerf_from_jax(jax.tree_util.tree_map(np.asarray, v))
            for k, v in ref_grads.items()}
    for (k, n, _), g in zip(parameters(state.models), grads):
        rel = float((g - want[k][n]).norm() / want[k][n].norm().clamp_min(1e-12))
        assert rel < 5e-3, f"{k} {n}: relative L2 {rel:.2e}"

    target = _optax_on(jsys, state, [[g.numpy() for g in grads]])   # before the step
    state, m = system.train_step(state, batch, seed=1)
    for k in ("train/loss", "train/psnr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for (k, n, p), w in zip(parameters(state.models), target):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-6, err_msg=f"{k} {n}")
