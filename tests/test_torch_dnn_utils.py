"""The port's `utils/dnn.py`, `utils/training_stats.py` and `utils/debug.py`:
the twins of tests/test_dnn_utils.py and tests/test_hardening.py, held
against the JAX functions where they compute numbers (moments to 1e-6
relative, the fingerprint to 1e-6 relative: float32 sums in another order;
batches and tables exactly)."""
from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.utils import debug as jdebug
from nerf_siren_tpu.utils import dnn as jdnn
from nerf_siren_tpu.utils import training_stats as jstats
from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.convert import nerf_to_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.utils import debug, dnn, training_stats


def test_easydict():
    d = dnn.EasyDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    del d.a
    with pytest.raises(AttributeError):
        _ = d.a


def test_construct_class_by_name():
    arr = dnn.construct_class_by_name("numpy.ndarray", (2, 3))
    assert arr.shape == (2, 3)
    od = dnn.construct_class_by_name("collections.OrderedDict", [("x", 1)])
    assert od["x"] == 1
    assert dnn.get_obj_by_name("nerf_siren_tpu_torch.models.nerf.NeRF") is NeRF


def test_param_summary_equals_jax_on_the_same_fields():
    gen = torch.Generator().manual_seed(0)
    models = {"coarse": NeRF(NeRFConfig(), generator=gen),
              "fine": NeRF(NeRFConfig(), generator=gen)}
    trees = {k: nerf_to_jax(m.state_dict()) for k, m in models.items()}
    n = dnn.param_count(models["coarse"])
    assert n == jdnn.param_count(trees["coarse"]) > 500_000   # 8x256 trunk
    assert dnn.param_summary(models) == jdnn.param_summary(trees)
    assert dnn.param_count(trees) == 2 * n


@pytest.mark.parametrize("shard", [0, 1])
def test_infinite_batches_shards_equal_jax(shard):
    arrays = {"x": np.arange(100), "y": np.arange(100) * 2}
    want = jdnn.infinite_batches(arrays, 10, seed=3, shard_index=shard, num_shards=2)
    got = dnn.infinite_batches(arrays, 10, seed=3, shard_index=shard, num_shards=2)
    seen = set()
    for _ in range(12):   # past the shard's end: a fresh permutation
        a, b = next(got), next(want)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        assert np.array_equal(a["y"], a["x"] * 2) and all(v % 2 == shard for v in a["x"])
        seen.update(a["x"].tolist())
    assert len(seen) == 50


def test_logger_tees_to_file(tmp_path):
    log = tmp_path / "run.log"
    with dnn.Logger(str(log)):
        print("hello tee")
    assert sys.stdout is not None
    assert "hello tee" in log.read_text()
    print("after close")


def test_open_url_plain_path_file_url_and_cache(tmp_path):
    p = tmp_path / "weights.bin"
    p.write_bytes(b"abc")
    with dnn.open_url(str(p)) as f:
        assert f.read() == b"abc"
    assert dnn.open_url("file://" + str(p), return_filename=True) == str(p)
    cd = tmp_path / "cache"
    cd.mkdir()
    url = "https://example.com/model.pkl"
    md5 = hashlib.md5(url.encode()).hexdigest()
    (cd / f"{md5}_model.pkl").write_bytes(b"cached")
    with dnn.open_url(url, cache_dir=str(cd)) as f:   # a cache hit: nothing downloaded
        assert f.read() == b"cached"
    assert dnn.open_url(url, cache_dir=str(cd), return_filename=True) == \
        jdnn.open_url(url, cache_dir=str(cd), return_filename=True)


def test_moments_equal_jax(rng):
    vals = rng.standard_normal(1000).astype(np.float32)
    m, jm = training_stats.init_moments(), jstats.init_moments()
    for chunk in np.split(vals, 10):
        m = training_stats.report(m, torch.from_numpy(chunk))
        jm = jstats.report(jm, jnp.asarray(chunk))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(float(training_stats.mean(m)), float(jstats.mean(jm)), rtol=1e-6)
    np.testing.assert_allclose(float(training_stats.std(m)), float(jstats.std(jm)), rtol=1e-6)
    np.testing.assert_allclose(float(training_stats.mean(m)), vals.mean(), atol=1e-4)
    # without a process group the cross-replica sum is the moments
    assert torch.equal(training_stats.cross_replica_sum(m), m)


def test_collector_equals_jax(rng):
    c, jc = training_stats.Collector(), jstats.Collector()
    vals = rng.uniform(0, 1, 500)
    for v in np.split(vals, 5):
        c.report("loss", torch.from_numpy(v))
        jc.report("loss", v)
    assert json.dumps(c.as_dict()) == json.dumps(jc.as_dict())
    np.testing.assert_allclose(c.as_dict()["loss"]["mean"], vals.mean(), rtol=1e-6)
    c.reset()
    assert c.as_dict() == {}


def test_replica_consistency_equals_jax_fingerprint():
    params = {"w": np.ones((8, 8), np.float32), "b": np.zeros(8, np.float32)}
    h = debug.check_replica_consistency(params)
    np.testing.assert_allclose(h, jdebug.check_replica_consistency(
        {k: jnp.asarray(v) for k, v in params.items()}), rtol=1e-6)
    debug.check_replica_consistency(params, reference_hash=h)
    bad = {"w": np.ones((8, 8), np.float32) * 1.01, "b": np.zeros(8, np.float32)}
    with pytest.raises(AssertionError):
        debug.check_replica_consistency(bad, reference_hash=h)


def test_assert_all_finite():
    debug.assert_all_finite({"a": torch.ones(3), "m": NeRF(NeRFConfig(depth=2, width=8))})
    with pytest.raises(FloatingPointError, match=r"\['a'\]\[1\]"):
        debug.assert_all_finite({"a": [torch.ones(2), torch.tensor([1.0, float("nan")])]})


def test_nan_debug_toggle():
    """Anomaly mode names the forward operation whose backward made a NaN."""
    debug.enable_nan_debug(True)
    try:
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    finally:
        debug.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with debug.profile_trace(str(tmp_path / "trace")) as d:
        with debug.named_scope("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert d == str(tmp_path / "trace")
    assert any(e.get("name") == "matmul" for e in trace["traceEvents"])
