"""benchmark/counts/ against counts worked by hand at small widths."""
from benchmark.counts import eg3d, nerf

SMALL = {"depth": 3, "width": 8, "skips": [2], "xyz_freqs": 1, "dir_freqs": 1,
         "dir_width": 4, "n_samples": 2, "n_importance": 3}


def test_nerf_forward_and_training_counts():
    # embeddings: 3 (2 + 1) = 9 wide; trunk inputs 9, 8, 8 + 9
    assert nerf.trunk_inputs(SMALL) == [9, 8, 17]
    sigma = 9 * 8 + 8 * 8 + 17 * 8 + 8                      # 280
    assert nerf.forward_macs(SMALL, full=False) == sigma
    full = sigma + 8 * 8 + (8 + 9) * 4 + 4 * 3               # + feature, direction, rgb
    assert nerf.forward_macs(SMALL, full=True) == full == 424
    emb = 2 * 9 * 8 + 9 * 4                                   # layer 0, the skip, the direction
    assert nerf.embedding_input_macs(SMALL) == emb == 180
    assert nerf.train_flops_per_point(SMALL) == 2 * (3 * 424 - 180)
    # 5 rays: the coarse pass at 2 points and the fine at 2 + 3
    assert nerf.train_points(SMALL, 5) == 5 * 7
    assert nerf.train_step_flops(SMALL, 5) == 35 * 2 * (3 * 424 - 180)
    assert nerf.frame_flops(SMALL, 5) == 2 * 5 * (2 * 280 + 5 * 424)


def test_nerf_params_and_bytes():
    n = (9 * 8 + 8) + (8 * 8 + 8) + (17 * 8 + 8) + (8 + 1) + (64 + 8) + (17 * 4 + 4) + (12 + 3)
    assert nerf.param_count(SMALL) == n
    assert nerf.frame_bytes(SMALL, 5) == 4 * n + 5 * 2 * 16 + 5 * 5 * 28 + 5 * 12


def test_nerf_published_sizes():
    cfg = {"depth": 8, "width": 256, "skips": [4], "xyz_freqs": 10, "dir_freqs": 4,
           "dir_width": 128, "n_samples": 64, "n_importance": 128}
    assert nerf.forward_macs(cfg, True) == 593408
    assert nerf.param_count(cfg) == 595844   # the 8x256 NeRF field's weights and biases


def test_eg3d_synthesis_by_hand():
    cfg = {"plane_resolution": 8, "plane_channels": 2, "channel_base": 32, "channel_max": 4,
           "w_dim": 5, "z_dim": 5, "mapping_layers": 2, "decoder_hidden": 3, "decoder_out": 4,
           "n_samples": 2, "n_importance": 1}
    # res 4: 4 channels, conv1 4x4x9x16 + affine 5x4; torgb 4x6x16 + affine 5x4
    b4 = 4 * 4 * 9 * 16 + 5 * 4 + 4 * 6 * 16 + 5 * 4
    # res 8: 4 channels in and out, conv0 and conv1 at 64 pixels
    b8 = 2 * (4 * 4 * 9 * 64 + 5 * 4) + 4 * 6 * 64 + 5 * 4
    assert eg3d.synthesis_macs(cfg) == b4 + b8
    assert eg3d.mapping_macs(cfg) == 2 * 25
    assert eg3d.train_step_flops(cfg, 10) == 6 * (b4 + b8 + 50 + 30 * (2 * 3 + 3 * 4))
