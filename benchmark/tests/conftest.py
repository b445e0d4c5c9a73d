"""CPU tests of the benchmark (`python -m pytest benchmark/tests` from the
checkout's root). Tests marked `cuda` need a card and skip without one; a
fixture decides, never an import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


# tiny shapes of each cell for the CPU: the widths stay, the counts shrink
TINY_CAMERAS = {"count": 2, "width": 8, "height": 8, "camera_angle_x": 0.69, "radius": 4.0,
                "elevation_deg": [5, 85], "near": 2.0, "far": 6.0}
TINY = {
    "nerf_blender.train": {
        "traffic": {"cameras": dict(TINY_CAMERAS, width=16, height=16), "rays_per_step": 128,
                    "steps_per_dispatch": 2, "warmup_groups": 1, "traced_groups": 1,
                    "reference_block": 64},
        "config": {"n_samples": 16, "n_importance": 16}},
    "nerf_blender.render_exact": {
        "traffic": {"cameras": dict(TINY_CAMERAS, count=3, width=16, height=16),
                    "chunk": 100, "check_rays": 1024, "check_frames": 3, "warmup_frames": 1},
        "config": {"n_samples": 8, "n_importance": 8}},
    "nerf_blender.render_fast": {
        "traffic": {"cameras": dict(TINY_CAMERAS, count=3, width=32, height=32),
                    "chunk": 512, "check_rays": 1024, "check_frames": 3, "warmup_frames": 1,
                    "cli": {"--fast_distill_steps": 100, "--fast_distill_batch": 2048}},
        "config": {"n_samples": 32, "n_importance": 32}},
    "eg3d_blender.train": {
        "traffic": {"cameras": TINY_CAMERAS, "rays_per_step": 16, "steps_per_dispatch": 2,
                    "warmup_groups": 1, "traced_groups": 1},
        # a CPU takes no product in TF32: the port runs float32 throughout here
        "config": {"n_samples": 8, "n_importance": 8, "plane_resolution": 16,
                   "channel_base": 512, "channel_max": 32, "z_dim": 32, "w_dim": 32,
                   "precision": "f32"}},
}


@pytest.fixture
def tiny():
    return TINY
