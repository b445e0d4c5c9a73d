"""Training CLI flags of the port: the same flags and defaults as the JAX
package's root `opt.py`, plus `--device`. Every flag value of the JAX CLI
is served; `--num_chips` above the visible device count is refused by the
train CLI, which knows the device."""
from __future__ import annotations

import argparse

from nerf_siren_tpu_torch.datasets import dataset_name


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    parser.add_argument('--root_dir', type=str, required=True,
                        help='root directory of dataset')
    parser.add_argument('--mode', default='normal', type=str,
                        choices=['d3', 'd3_ib', 'normal', 'eg3d'],
                        help='which training system to use')
    parser.add_argument('--dataset_name', type=dataset_name, default='blender',
                        help="which dataset to train/val: 'blender', 'llff', or a "
                             "semantic one ('blender_cls_ib', 'llff_cls', "
                             "'llff_cls_ib', 'replica'; --mode d3)")
    parser.add_argument('-sn', '--semantic_network', type=str, default='pointnet',
                        choices=['pointnet', 'conv3d'],
                        help='network for semantic features (d3 modes)')
    parser.add_argument('--point_norm', type=str, default='frob',
                        choices=['frob', 'rms'],
                        help='semantic point-cloud coordinate normalization: '
                             "'frob' divides xyz by the whole cloud's "
                             'Frobenius norm (reference quirk, '
                             'rendering.py:364-365 — scale depends on the '
                             "valid-point COUNT); 'rms' is the "
                             'count-invariant per-point RMS variant '
                             '(measured by tools/semantic_convergence.py)')
    parser.add_argument('--field', type=str, default='mlp',
                        choices=['mlp', 'siren'],
                        help='radiance field: positional-encoding MLP or '
                             'SIREN/FiLM (mode=normal)')
    parser.add_argument('--siren_box_warp', type=float, default=51.0,
                        help='SIREN UniformBoxWarp sidelength: the scene box '
                             'extent mapped to [-1,1]. The reference '
                             'hardcodes 51 (Replica-room scale); size it to '
                             'your scene (e.g. ~4.4 for blender-style '
                             'objects) or the sin trunk trains poorly')
    parser.add_argument('--n_classes', type=int, default=0,
                        help='>0 adds the nerf_cls semantic head to the field '
                             '(mode=normal; use with --loss_type msece)')
    parser.add_argument('--pretrained', type=str, default=None,
                        help='pretrained-model ckpt to warm-start from')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[800, 800],
                        help='resolution (img_w, img_h) of the image')
    parser.add_argument('--spheric_poses', default=False, action='store_true',
                        help='whether images are taken in spheric poses (llff)')

    parser.add_argument('--N_samples', type=int, default=64,
                        help='number of coarse samples')
    parser.add_argument('--N_importance', type=int, default=128,
                        help='number of additional fine samples')
    parser.add_argument('--use_disp', default=False, action='store_true',
                        help='use disparity depth sampling')
    parser.add_argument('--perturb', type=float, default=1.0,
                        help='factor to perturb depth sampling points')
    parser.add_argument('--noise_std', type=float, default=1.0,
                        help='std dev of noise added to regularize sigma')

    parser.add_argument('--loss_type', type=str, default='mse',
                        choices=['mse', 'msece', 'msenll'])

    parser.add_argument('--batch_size', type=int, default=1024)
    parser.add_argument('--chunk', type=int, default=32 * 1024,
                        help='rays per compiled tile (memory bound)')
    parser.add_argument('--num_epochs', type=int, default=16)
    parser.add_argument('--train_backend', type=str, default='jnp',
                        choices=['jnp', 'fused', 'culled', 'culled_fused'],
                        help="jnp (default): the plain PyTorch field in "
                             "float32 under autograd (the flag value of the "
                             "reference scripts). fused: both field passes "
                             "on K2, the hand-written CUDA forward and "
                             "backward kernels (bf16 operands, float32 "
                             "accumulation; reference 8x256 topology). "
                             "culled: proxy-culled sample placement "
                             "(render/culled_train.py): an online proxy "
                             "places 16 samples a ray among 32 candidates, "
                             "8 strata beside them, and both fields "
                             "evaluate only those 24. culled_fused: culled "
                             "with both field passes on K2. The SIREN field "
                             "and --mode d3 train on jnp")
    parser.add_argument('--steps_per_dispatch', type=int, default=1,
                        help="training steps per group: > 1 runs each group of the "
                             "epoch's batches as one captured CUDA graph on the card "
                             "(train_scan_batches, every --mode); 1: one eager step a batch")
    parser.add_argument('--num_chips', '--num_gpus', dest='num_chips', type=int, default=0,
                        help="devices of --device to train on, one process each "
                             "(data parallel): 0 every visible card (the CPU: one), "
                             "N > 1 spawns N local ranks")
    parser.add_argument('--multihost', default=False, action='store_true',
                        help="this process is one rank of a multi-process group "
                             "(torchrun, or the coordinator flags / NERF_TPU_* env)")
    parser.add_argument('--coordinator_address', type=str, default=None,
                        help='host:port of process 0 (--multihost)')
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)

    parser.add_argument('--ckpt_path', type=str, default=None,
                        help='checkpoint to fully resume training from')
    parser.add_argument('--prefixes_to_ignore', nargs='+', type=str, default=['loss'],
                        help='prefixes to ignore when loading checkpoints')

    parser.add_argument('--optimizer', type=str, default='adam',
                        choices=['sgd', 'adam', 'radam', 'ranger'])
    parser.add_argument('--lr', type=float, default=5e-4)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--weight_decay', type=float, default=0.0)
    parser.add_argument('--lr_scheduler', type=str, default='steplr',
                        choices=['steplr', 'cosine', 'poly'])
    parser.add_argument('--warmup_multiplier', type=float, default=1.0)
    parser.add_argument('--warmup_epochs', type=int, default=0)
    parser.add_argument('--decay_step', nargs='+', type=int, default=[20])
    parser.add_argument('--decay_gamma', type=float, default=0.1)
    parser.add_argument('--poly_exp', type=float, default=0.9)

    # EG3D triplane options (mode=eg3d; defaults match the reference's
    # hardcoded init_kwargs, eg3d_renderer.py:30-36)
    parser.add_argument('--eg3d_plane_res', type=int, default=256)
    parser.add_argument('--eg3d_channel_base', type=int, default=32768)
    parser.add_argument('--eg3d_channel_max', type=int, default=512)
    parser.add_argument('--eg3d_z_dim', type=int, default=512)
    parser.add_argument('--eg3d_ray_start', type=float, default=0.1)
    parser.add_argument('--eg3d_ray_end', type=float, default=10.0)
    parser.add_argument('--eg3d_box_warp', type=float, default=15.0)

    parser.add_argument('--exp_name', type=str, default='exp')
    parser.add_argument('--is_crop', default=False, action='store_true',
                        help='random-crop image batches (blender_cls_ib)')
    parser.add_argument('--crop_size', type=int, default=32)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--val_every', type=int, default=1,
                        help='validate every N epochs')
    parser.add_argument('--save_topk', type=int, default=100,
                        help='keep the best K checkpoints by val loss')
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='matmul operand dtype (f32 accumulate either way)')
    # the reference's mixed-precision flag (opt.py:86), accepted so its
    # train scripts run unmodified: bare or truthy values set --compute_dtype
    # bfloat16 (the reference declared type=bool, so any non-empty value
    # enabled it there)
    parser.add_argument('--is_use_mixed_precision', nargs='?', const='true',
                        default=None, metavar='BOOL',
                        help="alias: sets --compute_dtype bfloat16 "
                             "(reference's fp16 autocast flag)")
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) "
                             "or 'cpu'")
    return parser


def get_opts(args=None):
    parser = build_parser()
    opts = parser.parse_args(args)
    if opts.is_use_mixed_precision and \
            opts.is_use_mixed_precision.lower() not in ('false', '0', 'no'):
        opts.compute_dtype = 'bfloat16'
    return opts
