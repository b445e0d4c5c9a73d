"""Dataset loaders of the port and their registry.

Counterpart of `nerf_siren_tpu/datasets/__init__.py`, holding every loader
of the JAX package under its name: `blender` and `llff`, and the semantic
loaders `blender_cls_ib`, `llff_cls`, `llff_cls_ib` and `replica` (the
`--mode d3` datasets, with per-pixel class labels). They are numpy on the
host and import PIL or cv2 only when a loader reads images.
"""
dataset_dict = {}


def register_dataset(name):
    def deco(cls):
        dataset_dict[name] = cls
        return cls
    return deco


def dataset_name(name: str) -> str:
    """argparse `type` of `--dataset_name`: a registered loader's name."""
    import argparse

    if name in dataset_dict:
        return name
    raise argparse.ArgumentTypeError(
        f"unknown dataset {name!r}; the loaders: {sorted(dataset_dict)}")


from nerf_siren_tpu_torch.datasets import poses, ray_utils  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.blender import BlenderDataset  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.blender_cls import BlenderClsImgBatchDataset  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.llff import LLFFDataset  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.llff_cls import (  # noqa: E402,F401
    LLFFClsDataset, LLFFClsImgBatchDataset)
from nerf_siren_tpu_torch.datasets.replica import ReplicaDatasetCache  # noqa: E402,F401
