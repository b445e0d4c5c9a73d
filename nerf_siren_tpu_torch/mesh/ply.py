"""Minimal PLY mesh IO — replaces the plyfile dependency
(reference: extract_color_mesh.py:307-325 writes colored binary PLY).

The port's own copy of `nerf_siren_tpu/mesh/ply.py` (numpy only)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY. verts (V,3) f32, faces (F,3) int,
    colors (V,3) uint8 optional."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(len(verts), vdt)
            rec["xyz"] = verts
            rec["rgb"] = colors
        else:
            vdt = np.dtype([("xyz", "<f4", 3)])
            rec = np.empty(len(verts), vdt)
            rec["xyz"] = verts
        rec.tofile(f)
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        frec = np.empty(len(faces), fdt)
        frec["n"] = 3
        frec["idx"] = faces
        frec.tofile(f)


def read_ply(path: str):
    """Read back PLY files written by write_ply (and compatible binary PLYs).
    Returns (verts, faces, colors-or-None)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply"
        n_verts = n_faces = 0
        props = []
        element = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element":
                element = parts[1]
                if element == "vertex":
                    n_verts = int(parts[2])
                else:
                    n_faces = int(parts[2])
            elif parts[0] == "property" and element == "vertex":
                props.append(parts[-1])

        has_color = "red" in props
        if has_color:
            vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
        else:
            vdt = np.dtype([("xyz", "<f4", 3)])
        rec = np.fromfile(f, vdt, n_verts)
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        frec = np.fromfile(f, fdt, n_faces)
    colors = rec["rgb"].copy() if has_color else None
    return rec["xyz"].copy(), frec["idx"].copy(), colors
