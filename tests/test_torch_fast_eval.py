"""The port's eval CLI with `--renderer fast` against the JAX package's
`eval.py --renderer fast` on a synthetic Blender scene.

JAX distils the density proxy (a tiny distillation: 5 steps of 256 points)
and writes the `<ckpt>.proxy.msgpack` cache; the port's CLI reads that same
file, so both render with the same proxy and scene box (the two RNG streams
never meet), then renders the same frames. Both sides run on the kernel
route at the CLI defaults (pdf, mid placement, delta quadrature) with C = 16
and K = 8: JAX on its Pallas kernels in interpret mode, the port on the
plain versions its wrappers run on the CPU. The proxy kernel's ray tile
(JAX) and the auto-cull budget quantum (the port) are both set to 256 rays,
so that a 16x16 frame is one tile on both sides, and the JAX field
kernel's point tile to 128 (as tests/test_fused_mlp.py does).

Tolerances: PNG frames within 3/255 per channel at the median pixel and
32/255 at the worst (bf16 operands summed in another order move a
survivor's depth by O(eps), and one sample crossing a steep density edge
moves its pixel), the same output files, and mean PSNR within 0.1 dB.
"""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import jax
import pytest

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from nerf_siren_tpu.training.checkpoints import save_checkpoint
from nerf_siren_tpu_torch.render import fast
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_eval import _run


@pytest.fixture(scope="module")
def scene_and_ckpt(tmp_path_factory):
    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=16)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "random.msgpack")
    save_checkpoint(ckpt, {"nerf_coarse": init_nerf(jax.random.PRNGKey(12), NeRFConfig()),
                           "nerf_fine": init_nerf(jax.random.PRNGKey(13), NeRFConfig())})
    return root, ckpt


@pytest.fixture
def tiles(monkeypatch):
    monkeypatch.setattr(jfm, "TILE_N", 128)
    monkeypatch.setattr(jpm, "TILE_R", 256)
    monkeypatch.setattr(fast, "TILE_R", 256)


@pytest.mark.parametrize("flags", [[], ["--fast_field_dtype", "int8"], ["--fast_cull", "auto"]],
                         ids=["bf16", "int8", "auto-cull"])
def test_fast_eval_cli_matches_jax(tmp_path, scene_and_ckpt, tiles, capsys, flags):
    from eval import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu_torch.eval import get_opts, main

    root, ckpt = scene_and_ckpt
    common = ["--root_dir", root, "--dataset_name", "blender", "--split", "test",
              "--img_wh", "16", "16", "--N_samples", "16", "--N_importance", "16",
              "--ckpt_path", ckpt, "--scene_name", "sphere", "--renderer", "fast",
              "--fast_candidates", "16", "--fast_keep", "8", "--fast_distill_steps", "5",
              "--fast_distill_batch", "256", *flags]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_psnr = _run(jax_main, jax_opts, tmp_path / "jax", common)
    assert os.path.exists(ckpt + ".proxy.msgpack")
    capsys.readouterr()
    port_psnr = _run(main, get_opts, tmp_path / "port", common + ["--device", "cpu"])
    assert "reusing distilled proxy" in capsys.readouterr().out
    assert np.isfinite(port_psnr) and abs(port_psnr - jax_psnr) < 0.1

    jax_dir = tmp_path / "jax" / "results" / "blender" / "sphere"
    port_dir = tmp_path / "port" / "results" / "blender" / "sphere"
    names = sorted(os.path.basename(p) for p in glob.glob(str(jax_dir / "*")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(str(port_dir / "*")))
    for name in ("000.png", "001.png"):
        a = imageio.imread(jax_dir / name).astype(int)
        b = imageio.imread(port_dir / name).astype(int)
        assert a.shape == b.shape == (16, 16, 3)
        d = np.abs(a - b)
        assert np.median(d) <= 3 and d.max() <= 32, (name, np.median(d), d.max())


def test_port_written_proxy_cache_loads_in_jax(tmp_path, scene_and_ckpt):
    """The other direction: the port's CLI distils and writes the cache, and
    the JAX loader reads the same tree (proxy kernels (in, out), the box,
    the checkpoint's sha256 and the distillation settings)."""
    import hashlib

    import torch
    from nerf_siren_tpu_torch.convert import proxy_to_jax
    from nerf_siren_tpu_torch.eval import get_opts, setup_fast_proxy
    from nerf_siren_tpu_torch.models.nerf import NeRF

    _, ckpt = scene_and_ckpt
    cache = str(tmp_path / "port.proxy.msgpack")
    hp = get_opts(["--root_dir", str(tmp_path), "--ckpt_path", ckpt, "--renderer", "fast",
                   "--fast_distill_steps", "3", "--fast_distill_batch", "128",
                   "--fast_proxy_path", cache, "--device", "cpu"])
    models = {"coarse": NeRF(NeRFConfig(depth=2, width=128)),
              "fine": NeRF(NeRFConfig(depth=2, width=128))}
    setup = setup_fast_proxy(models, hp, np.array([2.0, 6.0], np.float32))
    blob = jax_load_checkpoint(cache)
    want = proxy_to_jax(setup.proxy.state_dict())
    for layer in ("l1", "l2"):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(blob["proxy"][layer][k]), want[layer][k])
    np.testing.assert_array_equal(np.asarray(blob["aabb"]), np.stack(setup.aabb))
    with open(ckpt, "rb") as f:
        assert bytes(np.asarray(blob["meta"]["ckpt_sha"], np.uint8)) == \
            hashlib.sha256(f.read()).digest()
    assert int(blob["meta"]["distill_steps"]) == 3 and int(blob["meta"]["distill_batch"]) == 128
    assert setup.proxy.l1.weight.dtype == torch.float32
