"""benchmark/counts/nerf3d.py against counts worked by hand, and the
published sizes' totals."""
from benchmark.counts import nerf, nerf3d

SMALL = {"depth": 3, "width": 8, "skips": [2], "xyz_freqs": 1, "dir_freqs": 1,
         "dir_width": 4, "n_samples": 2, "n_importance": 3, "n_classes": 2, "point_inputs": 6}


def test_pointnet_by_hand():
    per_point = (3 * 64 + 64 * 128 + 128 * 1024 + 6 * 64 + 64 * 128 + 128 * 1024
                 + 1088 * 512 + 512 * 256 + 256 * 128 + 128 * 2 + 9)
    assert nerf3d.pointnet_forward_macs(2, 6) == per_point
    assert nerf3d.pointnet_train_macs(2, 6) == 3 * per_point - 3 * 64
    # 5 rays with 9 valid points over the two clouds
    cloud = 3 * (1024 * 512 + 512 * 256 + 256 * 9)
    assert nerf3d.pointnet_step_flops(SMALL, 9) == 2 * (9 * (3 * per_point - 192) + 2 * cloud)
    traffic = {"rays_per_step": 5}
    assert nerf3d.fields_step_flops(SMALL, traffic) == 2 * 5 * 7 * nerf.forward_macs(SMALL, True)
    assert nerf3d.step_flops(SMALL, traffic, 9) == (nerf3d.fields_step_flops(SMALL, traffic)
                                                    + nerf3d.pointnet_step_flops(SMALL, 9))


def test_published_sizes():
    cfg = dict(depth=8, width=256, skips=[4], xyz_freqs=10, dir_freqs=4, dir_width=128,
               n_samples=64, n_importance=128, n_classes=6, point_inputs=6)
    traffic = {"rays_per_step": 4096}
    assert 2 * nerf3d.pointnet_forward_macs(6, 6) == 2_001_554     # ~2.0 MFLOP a point
    # every sample of both passes valid (the fork's largest cloud): 1,048,576 points
    assert round(nerf3d.pointnet_step_flops(cfg, 4096 * (64 + 192)) / 1e12, 2) == 6.30
    assert round(nerf3d.fields_step_flops(cfg, traffic) / 1e12, 2) == 1.24
