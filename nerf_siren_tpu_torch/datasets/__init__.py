"""Dataset loaders of the port and their registry.

Counterpart of `nerf_siren_tpu/datasets/__init__.py`, holding the loaders
of the main path: `blender` and `llff`. They are numpy on the host and
import PIL only when a loader reads images. The semantic loaders
(`blender_cls_ib`, `llff_cls`, `llff_cls_ib`, `replica`) use cv2 and serve
the semantic modes; they come with ROADMAP slice 4.
"""
dataset_dict = {}

# dataset names of the JAX package that the port does not load yet -> the
# ROADMAP slice that brings them
LATER_SLICES = {
    "blender_cls_ib": "slice 4 (the semantic stack)",
    "llff_cls": "slice 4 (the semantic stack)",
    "llff_cls_ib": "slice 4 (the semantic stack)",
    "replica": "slice 4 (the semantic stack)",
}


def register_dataset(name):
    def deco(cls):
        dataset_dict[name] = cls
        return cls
    return deco


def dataset_name(name: str) -> str:
    """argparse `type` of `--dataset_name`: a ported loader's name, or an
    error that names the ROADMAP slice bringing the loader."""
    import argparse

    if name in dataset_dict:
        return name
    if name in LATER_SLICES:
        raise argparse.ArgumentTypeError(
            f"dataset {name!r} is not ported yet: it comes with ROADMAP "
            f"{LATER_SLICES[name]}; ported: {sorted(dataset_dict)}")
    raise argparse.ArgumentTypeError(
        f"unknown dataset {name!r}; ported: {sorted(dataset_dict)}")


from nerf_siren_tpu_torch.datasets import poses, ray_utils  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.blender import BlenderDataset  # noqa: E402,F401
from nerf_siren_tpu_torch.datasets.llff import LLFFDataset  # noqa: E402,F401
