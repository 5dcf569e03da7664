"""dycheck-style numpy camera model (port of
``mobgs_tpu/data/dycheck_camera.py``, a copy: the module is numpy only).

Reference: ``dycheck_geometry/camera.py:278-788``, an OpenCV-model camera
(orientation / position / focal / principal point / image size, radial +
tangential distortion) with intrinsic / extrinsic accessors and
pixel↔ray helpers. Host-side numpy; the training path consumes the derived
(w2c, K) pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DycheckCamera:
    orientation: np.ndarray          # [3, 3] world→camera rotation
    position: np.ndarray             # [3] camera position (world)
    focal_length: float
    principal_point: np.ndarray      # [2] (x, y)
    image_size: np.ndarray           # [2] (W, H)
    skew: float = 0.0
    pixel_aspect_ratio: float = 1.0
    radial_distortion: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    tangential_distortion: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.float32))

    @classmethod
    def from_json(cls, d: dict) -> "DycheckCamera":
        return cls(
            orientation=np.asarray(d["orientation"], np.float32),
            position=np.asarray(d["position"], np.float32),
            focal_length=float(d["focal_length"]),
            principal_point=np.asarray(d["principal_point"], np.float32),
            image_size=np.asarray(d["image_size"], np.float32),
            skew=float(d.get("skew", 0.0)),
            pixel_aspect_ratio=float(d.get("pixel_aspect_ratio", 1.0)),
            radial_distortion=np.asarray(
                d.get("radial_distortion", [0, 0, 0]), np.float32),
            tangential_distortion=np.asarray(
                d.get("tangential_distortion", [0, 0]), np.float32),
        )

    def rescale(self, factor: float) -> "DycheckCamera":
        """Image-scale change (e.g. the 2x dirs): focal/pp/size divide."""
        return DycheckCamera(
            orientation=self.orientation, position=self.position,
            focal_length=self.focal_length / factor,
            principal_point=self.principal_point / factor,
            image_size=np.round(self.image_size / factor),
            skew=self.skew, pixel_aspect_ratio=self.pixel_aspect_ratio,
            radial_distortion=self.radial_distortion,
            tangential_distortion=self.tangential_distortion)

    @property
    def scale_factor_x(self) -> float:
        return self.focal_length

    @property
    def scale_factor_y(self) -> float:
        return self.focal_length * self.pixel_aspect_ratio

    @property
    def intrin(self) -> np.ndarray:
        """3x3 K (dycheck camera.py:438-446)."""
        return np.array([
            [self.scale_factor_x, self.skew, self.principal_point[0]],
            [0, self.scale_factor_y, self.principal_point[1]],
            [0, 0, 1]], np.float32)

    @property
    def extrin(self) -> np.ndarray:
        """4x4 world→camera (dycheck camera.py:448-459)."""
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = self.orientation
        out[:3, 3] = -self.orientation @ self.position
        return out

    @property
    def translation(self) -> np.ndarray:
        return -self.orientation @ self.position

    def undistort_pixels(self, pixels: np.ndarray, iters: int = 10) -> np.ndarray:
        """Invert radial(k1,k2,k3)+tangential(p1,p2) distortion by
        fixed-point iteration (dycheck camera.py:40-131)."""
        k1, k2, k3 = self.radial_distortion
        p1, p2 = self.tangential_distortion
        x = (pixels[..., 0] - self.principal_point[0]) / self.scale_factor_x
        y = (pixels[..., 1] - self.principal_point[1]) / self.scale_factor_y
        xd, yd = x.copy(), y.copy()
        for _ in range(iters):
            r2 = x * x + y * y
            d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
            x = (xd - dx) / d
            y = (yd - dy) / d
        return np.stack([x, y], -1)

    def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
        """World-space unit view directions for pixels [..., 2]."""
        if np.any(self.radial_distortion) or np.any(self.tangential_distortion):
            xy = self.undistort_pixels(pixels)
        else:
            xy = np.stack([
                (pixels[..., 0] - self.principal_point[0]) / self.scale_factor_x,
                (pixels[..., 1] - self.principal_point[1]) / self.scale_factor_y,
            ], -1)
        local = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
        local /= np.linalg.norm(local, axis=-1, keepdims=True)
        world = local @ self.orientation  # R^T @ local, row form
        return world / np.linalg.norm(world, axis=-1, keepdims=True)
