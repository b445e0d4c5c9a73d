"""The port's EG3D eval path (`training/eg3d_system.py`, `training/checkpoints.py::
load_eg3d_ckpt`, `python -m nerf_siren_tpu_torch.eval_eg3d`) against the JAX
package's `EG3DSystem.render` and checkpoints, on a tiny triplane config
(z/w 32, planes 16^2, channel_base 512, channel_max 32) and the synthetic
Blender sphere scene.

Tolerances:
- the render on shared planes (both packages sample one bf16 table that
  JAX packed): 1e-4, float32 reductions in another order, as
  tests/test_torch_triplane.py;
- `EG3DSystem.render` end to end, each package synthesising and packing
  its own planes: 2e-3. The two packages' float32 planes differ by ~1e-6
  relative (tests/test_torch_stylegan2.py), and where a plane value lies
  within that of a bf16 rounding boundary the two bf16 tables differ by
  one bf16 step (2^-8 relative) there (10 of 31,104 table entries here;
  the frame then agrees within 8.6e-6);
- against JAX's Pallas sampler (`plane_sampler='kernel'`, interpret mode),
  whose bilinear y-weights are rounded to bf16: JAX's own kernel-vs-gather
  bar, rtol 1e-3 (tests/test_triplane_gather.py), over the same 2e-3
  (measured: 9.4e-4 on depths of ~4);
- the CLI's frames: within 2/255 per pixel of JAX's render, mean PSNR
  within 0.1 dB."""
import glob
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_siren_tpu.config import RenderConfig, TrainConfig
from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu.training.checkpoints import save_checkpoint
from nerf_siren_tpu.training.eg3d_system import EG3DSystem as JEG3DSystem
from nerf_siren_tpu_torch.convert import eg3d_from_jax
from nerf_siren_tpu_torch.render import triplane as T
from nerf_siren_tpu_torch.training.checkpoints import load_eg3d_ckpt
from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_stylegan2 import numpy_eg3d_tree

SHARED_TOL = 1e-4
OWN_PLANES_TOL = 2e-3
TINY_FLAGS = ["--eg3d_plane_res", "16", "--eg3d_channel_base", "512", "--eg3d_channel_max", "32",
              "--eg3d_z_dim", "32", "--eg3d_ray_start", "2.0", "--eg3d_ray_end", "6.0",
              "--eg3d_box_warp", "8.0", "--N_samples", "8", "--N_importance", "8"]
CFG = dict(z_dim=32, w_dim=32, plane_resolution=16, channel_base=512, channel_max=32)
OPTS = dict(depth_resolution=8, depth_resolution_importance=8, ray_start=2.0, ray_end=6.0,
            box_warp=8.0, white_back=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The sphere scene, a JAX-saved `eg3d_renderer` checkpoint of the CLI's
    tiny config (32 plane channels), and its test split's rays."""
    from nerf_siren_tpu.datasets.blender import BlenderDataset

    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=16)
    jcfg = J.TriPlaneConfig(**CFG, rendering=J.RenderingOptions(**OPTS))
    tree = numpy_eg3d_tree(jcfg, seed=5, noise=True)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "eg3d.msgpack")
    save_checkpoint(ckpt, {"eg3d_renderer": tree, "nerf_coarse": {}})
    data = BlenderDataset(root, split="test", img_wh=(16, 16))
    frames = [data[i] for i in range(len(data))]
    return root, ckpt, jcfg, tree, frames


def port_model(tree):
    model = T.EG3DRenderer(T.TriPlaneConfig(**CFG, rendering=T.RenderingOptions(**OPTS)))
    model.load_state_dict(eg3d_from_jax(tree))
    return model


@pytest.fixture(scope="module")
def jax_frames(scene):
    """JAX `EG3DSystem.render` (chunk 64) of the test split's frames with
    its gather sampler, and of the second frame with its Pallas sampler."""
    _, _, jcfg, tree, frames = scene
    out = {}
    for sampler, items in (("gather", frames), ("kernel", frames[1:])):
        system = JEG3DSystem(RenderConfig(), TrainConfig(), steps_per_epoch=1,
                             triplane_cfg=jcfg, plane_sampler=sampler)
        out[sampler] = [system.render({"eg3d_renderer": tree}, f["rays"], chunk=64)
                        for f in items]
    return out


def test_load_eg3d_ckpt_reads_the_jax_checkpoint_bit_exact(scene, capsys):
    _, ckpt, _, tree, _ = scene
    model = load_eg3d_ckpt(port_model(numpy_eg3d_tree(J.TriPlaneConfig(**CFG), seed=9)), ckpt)
    want = eg3d_from_jax(tree)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    other = port_model(tree)
    load_eg3d_ckpt(other, ckpt, model_name="nerf_coarse")   # a tree with nothing of it
    assert "matched ZERO 'nerf_coarse' tensors" in capsys.readouterr().out


@pytest.mark.parametrize("sampler", ["gather", "kernel"])
def test_render_on_shared_planes_matches_jax(scene, sampler):
    """`render_packed` on the bf16 table JAX packed from its planes, in
    64-ray tiles, against JAX's importance_render (jnp gather) per tile."""
    _, _, jcfg, tree, frames = scene
    rays = frames[0]["rays"][:128]
    planes = jax.jit(lambda p: J.pack_planes_for_sampling(J.triplane_planes(
        p, jcfg, J.triplane_mapping(p, jcfg, p["z"])), jnp.bfloat16))(tree)
    render = jax.jit(lambda pl, dec, t: J.importance_render(
        pl, dec, t[None, :, :3], t[None, :, 3:6], jcfg.rendering, packed=True))
    want = [render(planes, tree["decoder"], jnp.asarray(rays[i: i + 64])) for i in (0, 64)]
    table = torch.from_numpy(np.array(planes.astype(jnp.float32))).to(torch.bfloat16)
    model = port_model(tree)
    got = EG3DSystem(model.cfg, sampler).render_packed(model, table, torch.from_numpy(rays),
                                                       chunk=64)
    for j, k in enumerate(("rgb_coarse", "depth_coarse", "opacity_coarse", "rgb_fine",
                           "depth_fine", "opacity_fine")):
        ref = np.concatenate([np.asarray(w[j][0]) for w in want])
        np.testing.assert_allclose(got[k].numpy(), ref, atol=SHARED_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("sampler", ["gather", "kernel"])
def test_eg3d_system_render_matches_jax(scene, jax_frames, sampler):
    """End to end, each package from its own synthesis, a 256-ray frame in
    64-ray tiles, both samplers of both packages."""
    _, _, _, tree, frames = scene
    want = jax_frames[sampler][-1]
    model = port_model(tree)
    got = EG3DSystem(model.cfg, sampler).render(model, torch.from_numpy(frames[1]["rays"]),
                                                chunk=64)
    assert set(got) == set(want)
    rtol = 1e-3 if sampler == "kernel" else 0.0
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=OWN_PLANES_TOL, rtol=rtol,
                                   err_msg=k)


def _run(main, get_opts, cwd, args):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(get_opts(args))
    finally:
        os.chdir(old)


@pytest.mark.parametrize("sampler", ["gather", "kernel"])
def test_eval_eg3d_cli_matches_jax(tmp_path, scene, jax_frames, sampler):
    """`python -m nerf_siren_tpu_torch.eval_eg3d --device cpu` on the JAX
    checkpoint: frames within 2/255 of JAX `EG3DSystem.render`, PSNR within
    0.1 dB, PNGs and a GIF written."""
    from nerf_siren_tpu.training.metrics import psnr as jpsnr
    from nerf_siren_tpu_torch.eval_eg3d import get_opts, main

    root, ckpt, _, _, frames = scene
    psnr = _run(main, get_opts, tmp_path, [
        "--root_dir", root, "--img_wh", "16", "16", "--ckpt_path", ckpt, "--scene_name", "eg3d",
        "--chunk", "100", "--plane_sampler", sampler, "--device", "cpu"] + TINY_FLAGS)
    out_dir = tmp_path / "results" / "blender" / "eg3d"
    names = sorted(os.path.basename(p) for p in glob.glob(str(out_dir / "*")))
    assert names == ["000.png", "001.png", "eg3d.gif"]
    jax_psnrs = []
    for i, sample in enumerate(frames):
        pred = jax_frames["gather"][i]["rgb_fine"].reshape(16, 16, 3)
        want = (np.clip(pred, 0, 1) * 255).astype(np.uint8).astype(int)
        got = imageio.imread(out_dir / f"{i:03d}.png").astype(int)
        assert got.shape == want.shape == (16, 16, 3)
        assert np.abs(got - want).max() <= 2, i
        jax_psnrs.append(float(jpsnr(jnp.asarray(pred), jnp.asarray(
            sample["rgbs"].reshape(16, 16, 3)))))
    assert np.isfinite(psnr) and abs(psnr - np.mean(jax_psnrs)) < 0.1


@pytest.mark.parametrize("args,message", [
    # slice 5 brought the fast renderer: it parses now, under its old id
    pytest.param(["--renderer", "fast"], None, id="args0-slice 5"),
    (["--num_chips", "2"], "slice 6"),
    # the JAX CLI's datasets are blender, llff and replica: replica parses
    # (slice 4 brought its loader), a semantic loader is refused
    pytest.param(["--dataset_name", "replica"], None, id="args2-slice 4"),
    (["--dataset_name", "blender_cls_ib"], "invalid choice: 'blender_cls_ib'"),
    # K3 takes at most 256 candidates a ray on the card (the default device)
    (["--renderer", "fast", "--fast_candidates", "300"], "takes at most 256"),
    (["--renderer", "fast", "--fast_prepass", "300"], "takes at most 256"),
])
def test_eval_eg3d_cli_refuses_what_later_slices_bring(args, message, capsys):
    from nerf_siren_tpu_torch.eval_eg3d import get_opts

    if message is None:
        opts = get_opts(["--root_dir", ".", "--ckpt_path", "x.msgpack"] + args)
        assert getattr(opts, args[0][2:]) == args[1]
        return
    with pytest.raises(SystemExit):
        get_opts(["--root_dir", ".", "--ckpt_path", "x.msgpack"] + args)
    assert message in capsys.readouterr().err


def test_eval_eg3d_cli_defaults_to_the_card(scene, monkeypatch):
    from nerf_siren_tpu_torch.eval_eg3d import get_opts, main

    root, ckpt, _, _, _ = scene
    hp = get_opts(["--root_dir", root, "--ckpt_path", ckpt] + TINY_FLAGS)
    assert hp.device == "cuda" and hp.plane_sampler == "gather" and hp.chunk == 4096
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(hp)
