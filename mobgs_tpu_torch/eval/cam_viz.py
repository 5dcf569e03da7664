"""Camera-frustum trajectory visualization, dependency-free (port of
``mobgs_tpu/eval/cam_viz.py``, the same numpy).

Behavioral reference: `utils_poses/vis_cam_traj.py` (NeRF++-derived
Open3D line sets; library code, no reference caller). Open3D is not in
this image, so the geometry is returned as plain numpy arrays and can
be written to an edge-list PLY that MeshLab/Open3D/CloudCompare load
directly.
"""

from __future__ import annotations

import numpy as np


def camera_frustum(H: int, W: int, fx: float, fy: float, w2c: np.ndarray,
                   frustum_length: float = 0.5,
                   color=np.array([0.0, 1.0, 0.0]),
                   coord: str = "opengl"):
    """One camera frustum in world space (vis_cam_traj.py:30-96).

    Returns (points [5,3], lines [8,2] int, colors [8,3]).
    """
    hfov = np.arctan(W / 2.0 / fx) * 2.0
    vfov = np.arctan(H / 2.0 / fy) * 2.0
    half_w = frustum_length * np.tan(hfov / 2.0)
    half_h = frustum_length * np.tan(vfov / 2.0)

    if coord == "opengl":  # X right, Y up, Z backward (:48-53)
        corners = np.array([[0.0, 0.0, 0.0, 1.0],
                            [-half_w, half_h, -frustum_length, 1.0],
                            [half_w, half_h, -frustum_length, 1.0],
                            [half_w, -half_h, -frustum_length, 1.0],
                            [-half_w, -half_h, -frustum_length, 1.0]])
    elif coord == "opencv":  # (:81-86)
        corners = np.array([[0.0, 0.0, 0.0, 1.0],
                            [-half_w, -half_h, frustum_length, 1.0],
                            [half_w, -half_h, frustum_length, 1.0],
                            [half_w, half_h, frustum_length, 1.0],
                            [-half_w, half_h, frustum_length, 1.0]])
    else:
        raise ValueError(f"unknown coord system {coord!r}")

    lines = np.array([[0, i] for i in range(1, 5)]
                     + [[i, i + 1] for i in range(1, 4)] + [[4, 1]])
    colors = np.tile(np.asarray(color, np.float64).reshape(1, 3), (8, 1))
    c2w = np.linalg.inv(w2c)
    pts = (c2w @ corners.T).T
    pts = pts[:, :3] / pts[:, 3:4]
    return pts, lines, colors


def frustums_lineset(c2ws: np.ndarray, H: int, W: int, fx: float = 600.0,
                     fy: float = 600.0, frustum_length: float = 0.5,
                     color=np.array([29.0, 53.0, 87.0]) / 255.0,
                     coord: str = "opengl"):
    """Merged line set for N cameras (vis_cam_traj.py:11-27,99-131
    `draw_camera_frustum_geometry` + `frustums2lineset`).

    Returns (points [N*5,3], lines [N*8,2] int, colors [N*8,3]).
    """
    c2ws = np.asarray(c2ws)
    N = c2ws.shape[0]
    color = np.asarray(color, np.float64)
    if color.size == 3:
        color = np.tile(color.reshape(1, 3), (N, 1))

    points = np.zeros((N * 5, 3))
    lines = np.zeros((N * 8, 2), np.int64)
    colors = np.zeros((N * 8, 3))
    for i in range(N):
        p, l, c = camera_frustum(H, W, fx, fy, np.linalg.inv(c2ws[i]),
                                 frustum_length, color[i], coord)
        points[i * 5:(i + 1) * 5] = p
        lines[i * 8:(i + 1) * 8] = l + i * 5
        colors[i * 8:(i + 1) * 8] = c
    return points, lines, colors


def save_lineset_ply(path: str, points: np.ndarray, lines: np.ndarray,
                     colors: np.ndarray | None = None) -> None:
    """ASCII PLY with vertex + edge elements (the portable stand-in for
    the reference's o3d.visualization window)."""
    lines = np.asarray(lines, np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(lines)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for i, e in enumerate(lines):
            if colors is not None:
                rgb = (np.clip(colors[i], 0, 1) * 255).astype(np.uint8)
                f.write(f"{e[0]} {e[1]} {rgb[0]} {rgb[1]} {rgb[2]}\n")
            else:
                f.write(f"{e[0]} {e[1]}\n")
