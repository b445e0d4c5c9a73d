from nerf_siren_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_rays

__all__ = ["Mesh", "make_mesh", "shard_rays", "replicate"]
