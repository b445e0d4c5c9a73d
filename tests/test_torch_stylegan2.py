"""The port's StyleGAN2 ops and generator (`nerf_siren_tpu_torch/ops/{bias_act,
upfirdn2d,conv2d_resample}.py`, `models/stylegan2.py`) against the JAX
package's on the same numpy inputs and weights.

Tolerances (float32 on both sides; only the summation order of the
convolutions and products differs): ops 1e-5 of the output's scale;
mapping and synthesis 1e-4 of the output's scale (a 14-layer-deep stack at
the TINY config of tests/test_triplane.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.models import stylegan2 as J
from nerf_siren_tpu.ops.bias_act import bias_act as j_bias_act
from nerf_siren_tpu.ops.conv2d_resample import conv2d_resample as j_conv2d_resample
from nerf_siren_tpu.ops import upfirdn2d as JU
from nerf_siren_tpu.render.triplane import TriPlaneConfig as JTriPlaneConfig
from nerf_siren_tpu.render.triplane import init_eg3d_renderer
from nerf_siren_tpu_torch.convert import eg3d_from_jax, eg3d_to_jax
from nerf_siren_tpu_torch.models import stylegan2 as T
from nerf_siren_tpu_torch.ops import upfirdn2d as TU
from nerf_siren_tpu_torch.ops.bias_act import bias_act
from nerf_siren_tpu_torch.ops.conv2d_resample import conv2d_resample
from nerf_siren_tpu_torch.render.triplane import EG3DRenderer, TriPlaneConfig

OP_TOL = 1e-5
NET_TOL = 1e-4
TINY = dict(z_dim=32, w_dim=32, plane_resolution=16, plane_channels=8, mapping_layers=2,
            channel_base=512, channel_max=32)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|d| {err:.3e} > {tol} x scale {scale:.3e}"


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("act,gain,clamp", [("linear", None, None), ("lrelu", None, 1.5),
                                            ("relu", 0.5, None), ("softplus", None, None),
                                            ("swish", None, 0.7), ("sigmoid", 2.0, None)])
def test_bias_act_matches_jax(act, gain, clamp):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32) * 2
    b = rng.standard_normal(5).astype(np.float32)
    close(bias_act(t(x), t(b), dim=1, act=act, gain=gain, clamp=clamp),
          j_bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act=act, gain=gain, clamp=clamp),
          OP_TOL)


@pytest.mark.parametrize("f", [[1, 3, 3, 1], [1, 2, 1], list(range(1, 9)), None])
def test_setup_filter_matches_jax(f):
    close(TU.setup_filter(f, gain=2.0), JU.setup_filter(f, gain=2.0), 1e-7)


@pytest.mark.parametrize("up,down,padding,flip", [
    (1, 1, (1, 1, 1, 1), False), (2, 1, (2, 1, 2, 1), False), (1, 2, (1, 1, 1, 1), True),
    (1, 1, (-1, 2, 0, 1), False), ((2, 1), (1, 2), (0, 1, 2, 0), False)])
def test_upfirdn2d_matches_jax(up, down, padding, flip):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 7)).astype(np.float32)
    for f in ([1, 3, 3, 1], list(range(1, 9))):   # 2-D, and a separable 1-D filter
        got = TU.upfirdn2d(t(x), TU.setup_filter(f), up=up, down=down, padding=list(padding),
                           flip_filter=flip, gain=1.5)
        want = JU.upfirdn2d(jnp.asarray(x), JU.setup_filter(f), up=up, down=down,
                            padding=list(padding), flip_filter=flip, gain=1.5)
        close(got, want, OP_TOL)


@pytest.mark.parametrize("name", ["upsample2d", "downsample2d", "filter2d"])
def test_resample_helpers_match_jax(name):
    x = np.random.default_rng(2).standard_normal((1, 4, 8, 8)).astype(np.float32)
    got = getattr(TU, name)(t(x), TU.setup_filter([1, 3, 3, 1]), padding=1)
    close(got, getattr(JU, name)(jnp.asarray(x), JU.setup_filter([1, 3, 3, 1]), padding=1),
          OP_TOL)


@pytest.mark.parametrize("up,down,kernel,padding,flip", [
    (1, 1, 3, 1, True), (1, 1, 1, 0, True), (2, 1, 3, 1, False), (1, 2, 3, 1, True),
    (1, 2, 1, 0, False)])
def test_conv2d_resample_matches_jax(up, down, kernel, padding, flip):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = rng.standard_normal((5, 4, kernel, kernel)).astype(np.float32) * 0.2
    got = conv2d_resample(t(x), t(w), TU.setup_filter([1, 3, 3, 1]), up=up, down=down,
                          padding=padding, flip_weight=flip)
    want = j_conv2d_resample(jnp.asarray(x), jnp.asarray(w), JU.setup_filter([1, 3, 3, 1]),
                             up=up, down=down, padding=padding, flip_weight=flip)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("activation,lr", [("linear", 1.0), ("lrelu", 0.01)])
def test_fully_connected_matches_jax(activation, lr):
    rng = np.random.default_rng(4)
    params = {"weight": rng.standard_normal((6, 9)).astype(np.float32) / lr,
              "bias": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((5, 9)).astype(np.float32)
    fc = T.FullyConnected(9, 6, lr_multiplier=lr)
    fc.load_state_dict({k: t(v) for k, v in params.items()})
    close(fc(t(x), activation), J.apply_fc(params, jnp.asarray(x), activation, lr), OP_TOL)


@pytest.mark.parametrize("up,demodulate,noise", [(1, True, True), (2, True, False),
                                                 (1, False, False)])
def test_modulated_conv2d_matches_jax(up, demodulate, noise):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    s = rng.standard_normal((2, 4)).astype(np.float32)
    n = rng.standard_normal((8 * up, 8 * up)).astype(np.float32) if noise else None
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    got = T.modulated_conv2d(t(x), t(w), t(s), None if n is None else t(n),
                             resample_filter=TU.setup_filter([1, 3, 3, 1]), **kw)
    want = J.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              None if n is None else jnp.asarray(n),
                              resample_filter=JU.setup_filter([1, 3, 3, 1]), **kw)
    close(got, want, OP_TOL)


def test_normalize_2nd_moment_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, 7)).astype(np.float32)
    close(T.normalize_2nd_moment(t(x)), J.normalize_2nd_moment(jnp.asarray(x)), OP_TOL)


def numpy_eg3d_tree(cfg: JTriPlaneConfig, seed: int, noise: bool = False):
    """A JAX `eg3d_renderer` tree with `init_eg3d_renderer`'s structure
    (from `jax.eval_shape`, no compile) and distributions, drawn with
    numpy: FC weights N(0, 1) / lr_multiplier (0.01 in the mapping), affine
    biases 1, other biases 0, convolution weights, consts, noise_const and
    z N(0, 1), noise strengths and w_avg 0. With `noise`, noise strengths
    U(0.1, 0.5) and w_avg N(0, 1), so const noise and truncation are
    exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_eg3d_renderer(k, cfg), jax.random.PRNGKey(0))

    def leaf(path, x):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name = names[-1]
        if name == "noise_strength":
            return np.float32(rng.uniform(0.1, 0.5) if noise else 0.0)
        if name == "w_avg":
            return (rng.standard_normal(x.shape) if noise else np.zeros(x.shape)).astype(
                np.float32)
        if name == "bias":
            return np.full(x.shape, 1.0 if "affine" in names else 0.0, np.float32)
        lr = 0.01 if ("fcs" in names and name == "weight") else 1.0
        return (rng.standard_normal(x.shape) / lr).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny_renderer():
    params = numpy_eg3d_tree(JTriPlaneConfig(**TINY), seed=7, noise=True)
    model = EG3DRenderer(TriPlaneConfig(**TINY))
    model.load_state_dict(eg3d_from_jax(params))
    return params, model


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 3)])
def test_mapping_matches_jax(tiny_renderer, psi, cutoff):
    params, model = tiny_renderer
    cfg = JTriPlaneConfig(**TINY).backbone.mapping
    z = np.random.default_rng(8).standard_normal((2, 32)).astype(np.float32)
    want = J.apply_mapping(params["backbone"]["mapping"], cfg, jnp.asarray(z),
                           truncation_psi=psi, truncation_cutoff=cutoff)
    got = model.backbone.mapping(t(z), truncation_psi=psi, truncation_cutoff=cutoff)
    close(got, want, NET_TOL)
    close(model.backbone.mapping.pre_broadcast(t(z)),
          J.mapping_pre_broadcast(params["backbone"]["mapping"], cfg, jnp.asarray(z)), NET_TOL)


def test_mapping_with_c_conditioning_matches_jax():
    cfg = J.MappingConfig(z_dim=16, c_dim=5, w_dim=16, num_ws=4, num_layers=3)
    rng = np.random.default_rng(9)
    features = [32, 16, 16, 16]   # z_dim + the embedding's w_dim, then w_dim
    params = {"fcs": [{"weight": (rng.standard_normal((o, i)) / 0.01).astype(np.float32),
                       "bias": rng.standard_normal(o).astype(np.float32)}
                      for i, o in zip(features[:-1], features[1:])],
              "w_avg": np.zeros(16, np.float32),
              "embed": {"weight": rng.standard_normal((16, 5)).astype(np.float32),
                        "bias": rng.standard_normal(16).astype(np.float32)}}
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        jax.eval_shape(lambda k: J.init_mapping(k, cfg), jax.random.PRNGKey(1))))
    mapping = T.MappingNetwork(T.MappingConfig(16, 5, 16, 4, 3))
    mapping.load_state_dict(eg3d_from_jax(params))
    z = rng.standard_normal((3, 16)).astype(np.float32)
    c = rng.standard_normal((3, 5)).astype(np.float32)
    close(mapping(t(z), t(c)), J.apply_mapping(params, cfg, jnp.asarray(z), jnp.asarray(c)),
          NET_TOL)


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_synthesis_network_matches_jax(tiny_renderer, noise_mode):
    params, model = tiny_renderer
    cfg = JTriPlaneConfig(**TINY).backbone.synthesis
    assert model.backbone.synthesis.cfg.num_ws == cfg.num_ws == 6
    ws = np.random.default_rng(10).standard_normal((2, cfg.num_ws, 32)).astype(np.float32)
    want = jax.jit(lambda p, w: J.apply_synthesis_network(p, cfg, w, noise_mode=noise_mode))(
        params["backbone"]["synthesis"], jnp.asarray(ws))
    with torch.no_grad():
        got = model.backbone.synthesis(t(ws), noise_mode=noise_mode)
    assert got.shape == (2, 24, 16, 16)
    close(got, want, NET_TOL)


def test_generator_matches_jax(tiny_renderer):
    params, model = tiny_renderer
    cfg = JTriPlaneConfig(**TINY).backbone
    z = np.random.default_rng(11).standard_normal((1, 32)).astype(np.float32)
    want = jax.jit(lambda p, z: J.apply_generator(p, cfg, z, truncation_psi=0.8))(
        params["backbone"], jnp.asarray(z))
    with torch.no_grad():
        close(model.backbone(t(z), truncation_psi=0.8), want, NET_TOL)


def test_random_noise_is_refused(tiny_renderer):
    _, model = tiny_renderer
    with pytest.raises(ValueError, match="random"):
        model.backbone.synthesis(torch.zeros((1, 8, 32)), noise_mode="random")


def test_eg3d_tree_round_trip(tiny_renderer):
    """eg3d_from_jax / eg3d_to_jax carry every tensor both ways, exactly, and
    accept lists restored from msgpack as {"0": ...} dicts."""
    params, model = tiny_renderer
    sd = model.state_dict()
    assert set(sd) == set(eg3d_from_jax(params))
    back = eg3d_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    as_dicts = dict(params, backbone=dict(params["backbone"], mapping=dict(
        params["backbone"]["mapping"],
        fcs={str(i): v for i, v in enumerate(params["backbone"]["mapping"]["fcs"])})))
    for k, v in eg3d_from_jax(as_dicts).items():
        assert torch.equal(v, sd[k]), k
