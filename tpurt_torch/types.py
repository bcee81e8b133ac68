"""Core data types of the PyTorch port (counterpart of ``tpurt/types.py``).

``Mesh``, ``Camera`` and ``Light`` are plain dataclasses whose fields are
numpy arrays on the host (the scene generators and ``look_at`` make them)
or tensors; every function that consumes them casts to float32 tensors on
the device it is given. ``RenderConfig`` keeps every field name and default
of the JAX package, so a config translates one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Mesh:
    """Triangle mesh.

    vertices : f32[V, 3] positions
    normals  : f32[V, 3] per-vertex (smooth) normals
    indices  : i32[T, 3] triangle vertex indices
    albedo   : f32[T, 3] per-triangle albedo color
    uv, tex_atlas, tri_tex : texturing (optional; not on the ported path)
    """

    vertices: Any
    normals: Any
    indices: Any
    albedo: Any
    uv: Any = None
    tex_atlas: Any = None
    tri_tex: Any = None

    @property
    def textured(self) -> bool:
        return self.tex_atlas is not None and self.uv is not None \
            and self.tri_tex is not None

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        v = np.asarray(self.vertices)
        return v.min(axis=0), v.max(axis=0)

    def on(self, device) -> "Mesh":
        """This mesh with its geometry as tensors on ``device`` (vertices,
        normals and albedo float32, indices int32; the texturing fields as
        they are). Fields already there are not copied."""
        def t(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dtype)
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)
        return dataclasses.replace(
            self, vertices=t(self.vertices, torch.float32),
            normals=t(self.normals, torch.float32),
            indices=t(self.indices, torch.int32),
            albedo=t(self.albedo, torch.float32))


@dataclasses.dataclass
class Camera:
    """Pinhole camera (look-at + vertical FOV in radians)."""

    position: Any
    target: Any
    up: Any
    fov_y: Any
    znear: Any
    zfar: Any

    @staticmethod
    def look_at(position, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0,
                znear: float = 0.01, zfar: float = 10_000.0) -> "Camera":
        return Camera(
            position=np.asarray(position, np.float32),
            target=np.asarray(target, np.float32),
            up=np.asarray(up, np.float32),
            fov_y=np.float32(np.deg2rad(fov_y_deg)),
            znear=np.float32(znear),
            zfar=np.float32(zfar),
        )


LIGHT_DIRECTIONAL = 0  # the reference's single directional light
LIGHT_POINT = 1        # point light with finite distance
LIGHT_AREA_CONE = 2    # "sun with angular radius" for soft shadows


@dataclasses.dataclass
class Light:
    """A light source; ``direction`` points FROM the scene TOWARD the light."""

    direction: Any
    position: Any
    color: Any
    intensity: Any
    angular_radius: Any
    radius: Any
    kind: int = LIGHT_DIRECTIONAL

    @staticmethod
    def directional(direction, color=(1.0, 1.0, 1.0), intensity: float = 1.0) -> "Light":
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        return Light(direction=d, position=np.zeros(3, np.float32),
                     color=np.asarray(color, np.float32),
                     intensity=np.float32(intensity),
                     angular_radius=np.float32(0.0), radius=np.float32(0.0),
                     kind=LIGHT_DIRECTIONAL)

    @staticmethod
    def sun(direction, angular_radius_deg: float = 0.53, color=(1.0, 1.0, 1.0),
            intensity: float = 1.0) -> "Light":
        l = Light.directional(direction, color, intensity)
        return dataclasses.replace(
            l, angular_radius=np.float32(np.deg2rad(angular_radius_deg)),
            kind=LIGHT_AREA_CONE)

    @staticmethod
    def point(position, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
              radius: float = 0.0) -> "Light":
        return Light(direction=np.array([0, 1, 0], np.float32),
                     position=np.asarray(position, np.float32),
                     color=np.asarray(color, np.float32),
                     intensity=np.float32(intensity),
                     angular_radius=np.float32(0.0),
                     radius=np.float32(radius), kind=LIGHT_POINT)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration; field names and defaults equal
    ``tpurt.types.RenderConfig``. Fields that select TPU-only strategies
    are kept so configs translate, and the port's Renderer raises
    ``NotImplementedError`` for values outside its slice."""

    width: int = 512
    height: int = 512
    spp: int = 1
    ambient: float = 0.08
    shadow_bias: float = 1e-3
    background: Tuple[float, float, float] = (0.18, 0.22, 0.30)
    leaf_size: int = 4
    bvh_width: int = 8
    use_pallas: bool = True
    packet_rows: int = 8
    packet_cols: int = 128
    sort_rays: bool = False
    accumulate: bool = False
    seed: int = 0
    gbuffer: str = "auto"
    raster_cap_pairs: int = 0
    raster_deferred: bool = False
    seeded_gbuffer: bool = False
    sah: bool = True
    fused_shadow: bool = True
    inkernel_attrs: bool = True
    order_children: bool = True
    top_sah: bool = False
    rebuild_collapse: str = "area"
    rebuild_splits: int = -1

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def packet_size(self) -> int:
        return self.packet_rows * self.packet_cols
