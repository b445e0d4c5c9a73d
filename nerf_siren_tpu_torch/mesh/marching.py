"""Iso-surface extraction from a dense scalar grid.

The port's own copy of `nerf_siren_tpu/mesh/marching.py` (numpy only; the
port imports nothing of the JAX package).

Replaces the reference's PyMCubes / skimage marching-cubes dependency
(reference: extract_color_mesh.py:147, extract_color_mesh_eg3d.py:96-156) —
neither ships in this environment — with MARCHING TETRAHEDRA: each grid cell
splits into 6 tetrahedra; a tetrahedron with a sign change on its 4 corners
emits 1 or 2 triangles with linear edge interpolation. Equivalent capability
(watertight iso-surface, exact linear interpolation along edges) with a
16-case table that is derived from first principles rather than the 256-row
MC table; triangle count is ~2× MC for the same grid.

Vectorized numpy, host-side (mesh extraction is an offline tool).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner indices 0..7 with
# corner c = (x, y, z) bits: c = x*4 + y*2 + z). Shares the main diagonal 0-7.
_CUBE_TETS = np.asarray([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], np.int32)

# cube corner offsets (x, y, z) for corner index c = x*4 + y*2 + z
_CORNER_OFFSETS = np.asarray(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.int32)

# The 6 edges of a tetrahedron as corner-index pairs (into its 4 corners).
_TET_EDGES = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)


def _tet_triangle_table():
    """case (4-bit mask of 'corner is inside') → up to 2 triangles of edge
    ids, padded with -1. Derived by enumeration:

    - 1 inside (or 3): one triangle on the three edges touching the odd corner,
    - 2 inside: a quad on the four crossing edges, split into two triangles.
    Winding is normalized afterwards by orienting normals along the field
    gradient, so the enumeration order here need not be consistent.
    """
    # edges touching each corner: edge ids where the corner participates
    corner_edges = {c: [e for e, (a, b) in enumerate(_TET_EDGES) if c in (a, b)]
                    for c in range(4)}
    table = -np.ones((16, 6), np.int32)
    for mask in range(1, 15):
        inside = [c for c in range(4) if mask & (1 << c)]
        outside = [c for c in range(4) if not (mask & (1 << c))]
        if len(inside) == 1 or len(inside) == 3:
            odd = inside[0] if len(inside) == 1 else outside[0]
            e = corner_edges[odd]
            table[mask, :3] = e
        else:  # 2 inside, 2 outside → 4 crossing edges
            crossing = [e for e, (a, b) in enumerate(_TET_EDGES)
                        if (mask >> a & 1) != (mask >> b & 1)]
            # order the quad so consecutive edges share a tet face:
            # crossing edges around the quad: pair them via shared corners
            c0, c1 = inside
            # edges from c0: to each outside corner; edges from c1 likewise
            e00 = next(e for e in crossing if c0 in _TET_EDGES[e] and outside[0] in _TET_EDGES[e])
            e01 = next(e for e in crossing if c0 in _TET_EDGES[e] and outside[1] in _TET_EDGES[e])
            e10 = next(e for e in crossing if c1 in _TET_EDGES[e] and outside[0] in _TET_EDGES[e])
            e11 = next(e for e in crossing if c1 in _TET_EDGES[e] and outside[1] in _TET_EDGES[e])
            table[mask, :6] = [e00, e01, e10, e01, e11, e10]
    return table


_TET_TRI_TABLE = _tet_triangle_table()


def marching_tetrahedra(grid: np.ndarray, iso: float,
                        spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                        origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a (Nx, Ny, Nz) scalar grid.

    Returns (vertices (V, 3) float32 in world units, faces (F, 3) int32).
    Vertices are deduplicated per grid edge; triangles are oriented so normals
    point toward decreasing field values (outward for density fields).
    """
    grid = np.asarray(grid, np.float32)
    nx, ny, nz = grid.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    if min(cx, cy, cz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # cell base coordinates (Ncells, 3)
    bx, by, bz = np.meshgrid(np.arange(cx), np.arange(cy), np.arange(cz),
                             indexing="ij")
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)             # (C, 3)

    # global corner coordinates per cube: (C, 8, 3)
    corners = base[:, None, :] + _CORNER_OFFSETS[None]
    corner_vals = grid[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)
    inside_cube = corner_vals > iso

    # quick reject: cubes fully in/out
    any_in = inside_cube.any(1)
    any_out = (~inside_cube).any(1)
    active = np.nonzero(any_in & any_out)[0]
    if active.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    corners = corners[active]                                    # (A, 8, 3)
    corner_vals = corner_vals[active]
    inside_cube = inside_cube[active]

    tris = []
    # unique edge key: edges are between two global grid points; key on the
    # sorted flat indices so shared edges dedupe across tets/cubes
    def flat(pt):  # (..., 3) int → flat grid index
        return (pt[..., 0] * ny + pt[..., 1]) * nz + pt[..., 2]

    edge_keys = []
    for t in range(6):
        tet = _CUBE_TETS[t]                                      # 4 cube corners
        tv = corner_vals[:, tet]                                 # (A, 4)
        tin = inside_cube[:, tet]                                # (A, 4)
        mask = (tin * np.asarray([1, 2, 4, 8])).sum(1)           # (A,)
        tri_edges = _TET_TRI_TABLE[mask]                         # (A, 6)

        tp = corners[:, tet]                                     # (A, 4, 3)
        # edge endpoints per tet edge: (A, 6, 3)
        pa = tp[:, _TET_EDGES[:, 0]]
        pb = tp[:, _TET_EDGES[:, 1]]
        va = tv[:, _TET_EDGES[:, 0]]
        vb = tv[:, _TET_EDGES[:, 1]]
        denom = vb - va
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        frac = np.clip((iso - va) / denom, 0.0, 1.0)             # (A, 6)
        pts = pa + frac[..., None] * (pb - pa).astype(np.float32)
        keys = np.stack([np.minimum(flat(pa), flat(pb)),
                         np.maximum(flat(pa), flat(pb))], -1)    # (A, 6, 2)

        for tri in range(2):
            e3 = tri_edges[:, 3 * tri: 3 * tri + 3]              # (A, 3)
            valid = e3[:, 0] >= 0
            idx = np.nonzero(valid)[0]
            if idx.size == 0:
                continue
            sel = e3[idx]                                        # (V, 3)
            p = pts[idx[:, None], sel]                           # (V, 3, 3)
            k = keys[idx[:, None], sel]                          # (V, 3, 2)
            tris.append((p, k))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    pts_all = np.concatenate([p for p, _ in tris], 0)            # (T, 3, 3)
    keys_all = np.concatenate([k for _, k in tris], 0)           # (T, 3, 2)

    # dedupe vertices by edge key
    flat_keys = keys_all.reshape(-1, 2)
    uniq, inv = np.unique(flat_keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float32)
    verts[inv] = pts_all.reshape(-1, 3)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]

    # orient triangles: flip those whose normal points along +gradient
    # (inside values > iso → outward normal is -gradient direction)
    gx, gy, gz = np.gradient(grid)
    vi = np.clip(np.round(verts).astype(int), 0, [nx - 1, ny - 1, nz - 1])
    grad = np.stack([gx[vi[:, 0], vi[:, 1], vi[:, 2]],
                     gy[vi[:, 0], vi[:, 1], vi[:, 2]],
                     gz[vi[:, 0], vi[:, 1], vi[:, 2]]], -1)
    tri_pts = verts[faces]
    n = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    g = grad[faces].mean(1)
    flip = (n * g).sum(-1) > 0
    faces[flip] = faces[flip][:, ::-1]

    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)
    return verts.astype(np.float32), faces


def largest_connected_component(verts: np.ndarray, faces: np.ndarray):
    """Keep only the largest vertex-connected face cluster — replaces the
    reference's open3d cluster denoise (reference extract_color_mesh.py:166-177).
    Union-find over face edges."""
    parent = np.arange(len(verts))

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.asarray([find(v) for v in range(len(verts))])
    uniq, counts = np.unique(roots, return_counts=True)
    big = uniq[np.argmax(counts)]
    keep_v = roots == big
    keep_f = keep_v[faces].all(1)

    remap = -np.ones(len(verts), np.int64)
    remap[keep_v] = np.arange(keep_v.sum())
    return (verts[keep_v], remap[faces[keep_f]].astype(np.int32),
            np.nonzero(keep_v)[0])
