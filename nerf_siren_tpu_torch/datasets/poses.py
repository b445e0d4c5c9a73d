"""Camera pose utilities for LLFF-style forward-facing captures.

Numerics match the reference pose math (reference: datasets/llff.py:12-156):
average pose (z from mean forward, x = y'×z, y = z×x), pose centering by the
inverse average pose, LLFF spiral render paths, and the downward-looking
spheric circle path.
"""
from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average (3, 4) pose of a (N, 3, 4) set, Gram-Schmidt style."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """Re-express poses in the average-pose frame.

    Returns (poses_centered (N,3,4), inv_pose_avg (4,4)).
    """
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    inv = np.linalg.inv(pose_avg_homo)
    poses_centered = (inv @ poses_homo)[:, :3]
    return poses_centered, inv


def create_spiral_poses(radii: np.ndarray, focus_depth: float, n_poses: int = 120) -> np.ndarray:
    """LLFF spiral path: 2 turns, look-at the focus plane. Returns (n, 3, 4)."""
    out = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0, 1.0, 0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        out.append(np.stack([x, y, z, center], 1))
    return np.stack(out, 0)


def create_spheric_poses(radius: float, n_poses: int = 120, phi: float = -np.pi / 5) -> np.ndarray:
    """Circle of poses around +z looking 36° downward. Returns (n, 3, 4)."""

    def spheric_pose(theta, phi, radius):
        trans_t = np.array([
            [1, 0, 0, 0],
            [0, 1, 0, -0.9 * radius],
            [0, 0, 1, radius],
            [0, 0, 0, 1.0],
        ])
        rot_phi = np.array([
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1.0],
        ])
        rot_theta = np.array([
            [np.cos(theta), 0, -np.sin(theta), 0],
            [0, 1, 0, 0],
            [np.sin(theta), 0, np.cos(theta), 0],
            [0, 0, 0, 1.0],
        ])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
        return c2w[:3]

    return np.stack(
        [spheric_pose(th, phi, radius) for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0
    )
