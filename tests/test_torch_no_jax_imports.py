"""The port imports nothing of JAX and nothing of the JAX package: every
module under `nerf_siren_tpu_torch/` and the root `chip_smoke.py`, read as
source (no module is imported), must not import `jax`, `flax`, `optax` or
`nerf_siren_tpu` (the package itself or any of its submodules)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "nerf_siren_tpu")
SOURCES = sorted((ROOT / "nerf_siren_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def forbidden_imports(source: str):
    """(line, module) of every import of a forbidden top-level package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_nothing_of_jax(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("line,bad", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from flax import serialization", True),
    ("import optax", True),
    ("from nerf_siren_tpu.config import NeRFConfig", True),
    ("import nerf_siren_tpu.datasets", True),
    ("from nerf_siren_tpu import config", True),
    ("def f():\n    import nerf_siren_tpu\n", True),
    ("from nerf_siren_tpu_torch.config import NeRFConfig", False),
    ("import nerf_siren_tpu_torch.datasets", False),
    ("import jaxlib_free_module", False),
    ("from . import config", False),
])
def test_guard_tells_the_package_from_the_port(line, bad):
    assert bool(forbidden_imports(line)) == bad
