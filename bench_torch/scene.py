"""The benchmark's own scene, camera, light sets and animation.

Copies of the program's generators, kept here so that a change to the
program cannot move the yardstick:

- ``hall``: ``tpurt_torch/scenes.py`` ``sponza_scene`` (the colonnaded hall
  that stands in for Crytek Sponza), with the face loops of its primitives
  written as array operations; the arrays are equal to the original's
  (``bench_torch/tests``).
- ``camera``: ``sponza_interior_camera``.
- ``lights``: a light set from a traffic file; ``tpurt/cli.py``'s "multi"
  set and ``Light.sun(..., angular_radius_deg=2.0)`` are written there as
  data.
- ``deform``: ``tpurt_torch/scenes.py`` ``deform``, in torch, so that the
  animated cell's poses are made on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tpurt_torch.types import Camera, Light, Mesh


def compute_smooth_normals(vertices: np.ndarray,
                           indices: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (``scenes.compute_smooth_normals``)."""
    v = vertices.astype(np.float64)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(v[i1] - v[i0], v[i2] - v[i0])
    n = np.zeros_like(v)
    np.add.at(n, i0, fn)
    np.add.at(n, i1, fn)
    np.add.at(n, i2, fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(lens > 1e-20, n / np.maximum(lens, 1e-20),
                 np.array([0.0, 1.0, 0.0]))
    return n.astype(np.float32)


def _mesh(vertices, indices, albedo) -> Mesh:
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    albedo = np.broadcast_to(np.asarray(albedo, np.float32),
                             (len(indices), 3)).copy()
    return Mesh(vertices=vertices,
                normals=compute_smooth_normals(vertices, indices),
                indices=indices, albedo=albedo)


def _merge(meshes) -> Mesh:
    off = np.cumsum([0] + [m.num_vertices for m in meshes[:-1]])
    return Mesh(vertices=np.concatenate([m.vertices for m in meshes]),
                normals=np.concatenate([m.normals for m in meshes]),
                indices=np.concatenate([m.indices + o for m, o in
                                        zip(meshes, off)]).astype(np.int32),
                albedo=np.concatenate([m.albedo for m in meshes]))


def _plane(center, size, subdiv, albedo) -> Mesh:
    cx, cy, cz = center
    sx, sz = size
    n = subdiv + 1
    xs = np.linspace(-sx / 2, sx / 2, n) + cx
    zs = np.linspace(-sz / 2, sz / 2, n) + cz
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, cy), gz], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(subdiv), np.arange(subdiv), indexing="ij")
    a = i * n + j
    b = (i + 1) * n + j
    quads = np.stack([np.stack([a, a + 1, b], -1),
                      np.stack([b, a + 1, b + 1], -1)], axis=2)
    return _mesh(verts, quads.reshape(-1, 3), albedo)


def _box(bmin, bmax, albedo) -> Mesh:
    x0, y0, z0 = np.asarray(bmin, np.float32)
    x1, y1, z1 = np.asarray(bmax, np.float32)
    corners = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                        [x0, y1, z0], [x0, y0, z1], [x1, y0, z1],
                        [x1, y1, z1], [x0, y1, z1]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [3, 7, 6], [3, 6, 2],
                      [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]],
                     np.int32)
    return _mesh(corners, faces, albedo)


def _sphere(center, radius, rows, cols, albedo) -> Mesh:
    """UV sphere; faces in ``make_sphere``'s order: per (row, column) the
    triangle (a, b, c) below the top row and (b, d, c) above the last."""
    c = np.asarray(center, np.float32)
    theta = np.linspace(0, np.pi, rows + 1)
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    verts = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                     axis=-1).reshape(-1, 3) * radius + c
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    a = i * cols + j
    b = i * cols + (j + 1) % cols
    cc = (i + 1) * cols + j
    d = (i + 1) * cols + (j + 1) % cols
    faces = np.stack([np.stack([a, b, cc], -1), np.stack([b, d, cc], -1)],
                     axis=2)
    keep = np.stack([i > 0, i < rows - 1], axis=2)
    return _mesh(verts.astype(np.float32), faces[keep], albedo)


def _cylinder(center, radius, height, segments, rings, albedo) -> Mesh:
    """Capped vertical cylinder; ``make_cylinder``'s vertices and faces."""
    c = np.asarray(center, np.float32)
    phi = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    levels = np.linspace(0, height, rings + 1)
    ly, lp = np.meshgrid(levels, phi, indexing="ij")
    ring = np.stack([radius * np.cos(lp), ly, radius * np.sin(lp)],
                    axis=-1).reshape(-1, 3)
    verts = np.concatenate([ring, [[0.0, height, 0.0]]])
    i, j = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    a = i * segments + j
    b = i * segments + (j + 1) % segments
    cc = (i + 1) * segments + j
    d = (i + 1) * segments + (j + 1) % segments
    side = np.stack([np.stack([a, cc, b], -1), np.stack([b, cc, d], -1)],
                    axis=2).reshape(-1, 3)
    base = rings * segments
    js = np.arange(segments)
    cap = np.stack([base + js, np.full_like(js, len(ring)),
                    base + (js + 1) % segments], -1)
    verts = np.asarray(verts, np.float32) + c
    return _mesh(verts, np.concatenate([side, cap]), albedo)


def hall(tris_target: int = 260_000, seed: int = 7) -> Mesh:
    """``sponza_scene``: two floors of columns around an atrium, floor,
    walls and a roof with a skylight, and 24 spheres of clutter. ``seed``
    draws the columns' albedo jitter and the clutter's placement, size and
    albedo."""
    rng = np.random.default_rng(seed)
    parts: List[Mesh] = []
    hall_x, hall_z, wall_h = 36.0, 18.0, 12.0
    parts.append(_plane((0, 0, 0), (hall_x, hall_z), 6, (0.62, 0.58, 0.52)))
    t = 0.4
    parts.append(_box((-hall_x / 2, 0, -hall_z / 2 - t),
                      (hall_x / 2, wall_h, -hall_z / 2), (0.66, 0.6, 0.5)))
    parts.append(_box((-hall_x / 2, 0, hall_z / 2),
                      (hall_x / 2, wall_h, hall_z / 2 + t), (0.66, 0.6, 0.5)))
    parts.append(_box((-hall_x / 2 - t, 0, -hall_z / 2),
                      (-hall_x / 2, wall_h, hall_z / 2), (0.64, 0.58, 0.5)))
    parts.append(_box((hall_x / 2, 0, -hall_z / 2),
                      (hall_x / 2 + t, wall_h, hall_z / 2), (0.64, 0.58, 0.5)))
    roof_y, opening = wall_h, 6.0
    parts.append(_box((-hall_x / 2, roof_y, -hall_z / 2),
                      (hall_x / 2, roof_y + t, -opening / 2),
                      (0.55, 0.52, 0.48)))
    parts.append(_box((-hall_x / 2, roof_y, opening / 2),
                      (hall_x / 2, roof_y + t, hall_z / 2),
                      (0.55, 0.52, 0.48)))
    n_cols_x, col_rows = 10, 2
    n_columns = n_cols_x * 2 * col_rows
    base_budget = sum(m.num_triangles for m in parts)
    per_col = max(200, (tris_target - base_budget - 40_000) // n_columns)
    segments = max(12, per_col // (2 * 8 + 1))
    xs = np.linspace(-hall_x / 2 + 2.5, hall_x / 2 - 2.5, n_cols_x)
    for floor in range(col_rows):
        y0 = floor * (wall_h / 2)
        for zsign in (-1.0, 1.0):
            for x in xs:
                parts.append(_cylinder(
                    (x, y0, zsign * (hall_z / 2 - 2.2)), 0.45,
                    wall_h / 2 - 0.5, segments, 8,
                    (0.7 + rng.uniform(-0.05, 0.05), 0.62, 0.5)))
    remaining = tris_target - sum(m.num_triangles for m in parts)
    n_clutter = 24
    rows = max(6, int(np.sqrt(max(remaining, 1) / n_clutter / 2.2)))
    for _ in range(n_clutter):
        x = rng.uniform(-hall_x / 2 + 3, hall_x / 2 - 3)
        z = rng.uniform(-hall_z / 2 + 3, hall_z / 2 - 3)
        r = rng.uniform(0.4, 1.1)
        parts.append(_sphere((x, r, z), r, rows, 2 * rows,
                             rng.uniform(0.3, 0.85, 3)))
    return _merge(parts)


GENERATORS = {"hall": hall}


def make_scene(spec: dict, seed: int) -> Mesh:
    """The configuration's ``scene`` block -> its mesh, drawn from the
    run's seed."""
    return GENERATORS[spec["generator"]](spec["tris_target"], seed=seed)


def camera(spec: dict) -> Camera:
    """The configuration's ``camera`` block (``sponza_interior_camera``:
    eye (-13, 2.2, 0), target (14, 4.5, 0.5), 65 degrees)."""
    return Camera.look_at(spec["position"], spec["target"],
                          fov_y_deg=spec["fov_y_deg"], znear=spec["znear"],
                          zfar=spec["zfar"])


def lights(specs) -> List[Light]:
    """A traffic file's light set: ``directional`` (direction, color,
    intensity) or ``sun`` (the same and an angular radius in degrees)."""
    out = []
    for s in specs:
        color = tuple(s.get("color", (1.0, 1.0, 1.0)))
        intensity = s.get("intensity", 1.0)
        if s["kind"] == "directional":
            out.append(Light.directional(s["direction"], color, intensity))
        elif s["kind"] == "sun":
            out.append(Light.sun(s["direction"], s["angular_radius_deg"],
                                 color, intensity))
        else:
            raise ValueError(f"light kind {s['kind']!r}")
    return out


def deform(v: torch.Tensor, time: float, amplitude: float,
           freq: float) -> torch.Tensor:
    """``scenes.deform`` on the vertices' device: a sinusoidal displacement
    of every vertex at animation time ``time`` (seconds)."""
    phase = v[:, 0] * freq + v[:, 2] * 0.7 * freq
    disp = torch.stack([torch.sin(phase + 2.1 * time),
                        torch.cos(0.8 * phase + 1.7 * time) * 0.6,
                        torch.sin(0.6 * phase + 2.9 * time)], dim=-1)
    return v + disp * amplitude
