"""Mesh extraction helpers of the port (numpy only): its own copies of the
JAX package's `mesh/` (marching tetrahedra, the largest connected
component, PLY IO)."""
from nerf_siren_tpu_torch.mesh.marching import largest_connected_component, marching_tetrahedra
from nerf_siren_tpu_torch.mesh.ply import read_ply, write_ply

__all__ = ["marching_tetrahedra", "largest_connected_component", "write_ply", "read_ply"]
