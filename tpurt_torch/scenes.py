"""Procedural test scenes and mesh utilities (counterpart of
``tpurt/scenes.py``; NumPy only, and every array equals the JAX package's).

The reference ships no geometry; it loads arbitrary ``.obj`` files from the
command line (canonical demo: Crytek Sponza, ~260k triangles). This repo has no
network access, so these generators produce the BASELINE.json scene classes
procedurally:

- ``teapot_scene``  : ~10k-triangle hero object + ground (config 1)
- ``sponza_scene``  : ~260k-triangle colonnaded hall (config 2/5 scale)
- ``random_soup``   : random triangle soup (property tests)
- ``deform``        : time-varying vertex displacement (config 4, refit path)

All generators are NumPy (host-side, like the reference's CPU model loading);
arrays are copied once to the Renderer's device.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from .types import Mesh


def compute_smooth_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (what the reference computes when the
    OBJ lacks ``vn`` [RECALL: loadModel in Source/RayTracedShadows.cpp])."""
    v = vertices.astype(np.float64)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(v[i1] - v[i0], v[i2] - v[i0])  # area-weighted face normals
    n = np.zeros_like(v)
    np.add.at(n, i0, fn)
    np.add.at(n, i1, fn)
    np.add.at(n, i2, fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(lens > 1e-20, n / np.maximum(lens, 1e-20), np.array([0.0, 1.0, 0.0]))
    return n.astype(np.float32)


def make_mesh(vertices: np.ndarray, indices: np.ndarray,
              albedo: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> Mesh:
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    if normals is None:
        normals = compute_smooth_normals(vertices, indices)
    if albedo is None:
        albedo = np.full((len(indices), 3), 0.8, np.float32)
    elif albedo.ndim == 1:
        albedo = np.broadcast_to(albedo.astype(np.float32), (len(indices), 3)).copy()
    return Mesh(vertices=vertices, normals=normals.astype(np.float32),
                indices=indices, albedo=albedo.astype(np.float32))


def merge_meshes(meshes: Iterable[Mesh]) -> Mesh:
    vs, ns, idx, alb = [], [], [], []
    off = 0
    for m in meshes:
        vs.append(np.asarray(m.vertices))
        ns.append(np.asarray(m.normals))
        idx.append(np.asarray(m.indices) + off)
        alb.append(np.asarray(m.albedo))
        off += m.num_vertices
    return Mesh(vertices=np.concatenate(vs), normals=np.concatenate(ns),
                indices=np.concatenate(idx), albedo=np.concatenate(alb))


# ---------------------------------------------------------------------------
# Primitive generators
# ---------------------------------------------------------------------------

def make_plane(center=(0, 0, 0), size=(10.0, 10.0), subdiv: int = 1,
               albedo=(0.75, 0.75, 0.75)) -> Mesh:
    """Horizontal (XZ) ground plane."""
    cx, cy, cz = center
    sx, sz = size
    n = subdiv + 1
    xs = np.linspace(-sx / 2, sx / 2, n) + cx
    zs = np.linspace(-sz / 2, sz / 2, n) + cz
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, cy), gz], axis=-1).reshape(-1, 3)
    quads = []
    for i in range(subdiv):
        for j in range(subdiv):
            a = i * n + j
            b = (i + 1) * n + j
            quads.append([a, a + 1, b])        # +y winding
            quads.append([b, a + 1, b + 1])
    return make_mesh(verts, np.array(quads, np.int32), np.asarray(albedo, np.float32))


def make_box(bmin, bmax, albedo=(0.8, 0.8, 0.8)) -> Mesh:
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    corners = np.array([[bmin[0], bmin[1], bmin[2]],
                        [bmax[0], bmin[1], bmin[2]],
                        [bmax[0], bmax[1], bmin[2]],
                        [bmin[0], bmax[1], bmin[2]],
                        [bmin[0], bmin[1], bmax[2]],
                        [bmax[0], bmin[1], bmax[2]],
                        [bmax[0], bmax[1], bmax[2]],
                        [bmin[0], bmax[1], bmax[2]]], np.float32)
    faces = np.array([
        [0, 2, 1], [0, 3, 2],   # -z
        [4, 5, 6], [4, 6, 7],   # +z
        [0, 1, 5], [0, 5, 4],   # -y
        [3, 7, 6], [3, 6, 2],   # +y
        [0, 4, 7], [0, 7, 3],   # -x
        [1, 2, 6], [1, 6, 5],   # +x
    ], np.int32)
    return make_mesh(corners, faces, np.asarray(albedo, np.float32))


def make_sphere(center=(0, 0, 0), radius=1.0, rows: int = 16, cols: int = 32,
                albedo=(0.8, 0.8, 0.8)) -> Mesh:
    """UV sphere: 2*rows*cols triangles."""
    c = np.asarray(center, np.float32)
    theta = np.linspace(0, np.pi, rows + 1)
    phi = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    verts = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)],
                     axis=-1).reshape(-1, 3) * radius + c
    faces = []
    for i in range(rows):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            cidx = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            if i > 0:
                faces.append([a, b, cidx])
            if i < rows - 1:
                faces.append([b, d, cidx])
    return make_mesh(verts.astype(np.float32), np.array(faces, np.int32),
                     np.asarray(albedo, np.float32))


def make_torus(center=(0, 0, 0), R=1.0, r=0.35, seg_u: int = 48, seg_v: int = 24,
               albedo=(0.8, 0.5, 0.3)) -> Mesh:
    """Torus: 2*seg_u*seg_v triangles."""
    c = np.asarray(center, np.float32)
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    z = (R + r * np.cos(vv)) * np.sin(uu)
    y = r * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3) + c
    faces = []
    for i in range(seg_u):
        for j in range(seg_v):
            a = i * seg_v + j
            b = ((i + 1) % seg_u) * seg_v + j
            cdx = i * seg_v + (j + 1) % seg_v
            d = ((i + 1) % seg_u) * seg_v + (j + 1) % seg_v
            faces.append([a, b, cdx])
            faces.append([b, d, cdx])
    return make_mesh(verts.astype(np.float32), np.array(faces, np.int32),
                     np.asarray(albedo, np.float32))


def make_cylinder(center=(0, 0, 0), radius=0.5, height=2.0, segments: int = 24,
                  rings: int = 1, cap: bool = True, albedo=(0.8, 0.8, 0.8)) -> Mesh:
    """Vertical (Y axis) cylinder; center is the base center."""
    c = np.asarray(center, np.float32)
    phi = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    levels = np.linspace(0, height, rings + 1)
    verts = []
    for y in levels:
        for p in phi:
            verts.append([radius * np.cos(p), y, radius * np.sin(p)])
    faces = []
    for i in range(rings):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            cdx = (i + 1) * segments + j
            d = (i + 1) * segments + (j + 1) % segments
            faces.append([a, cdx, b])
            faces.append([b, cdx, d])
    if cap:
        top_c = len(verts)
        verts.append([0.0, height, 0.0])
        base = rings * segments
        for j in range(segments):
            faces.append([base + j, top_c, base + (j + 1) % segments])
    verts = np.asarray(verts, np.float32) + c
    return make_mesh(verts, np.array(faces, np.int32), np.asarray(albedo, np.float32))


def random_soup(num_tris: int, seed: int = 0, extent: float = 10.0,
                tri_size: float = 0.6) -> Mesh:
    """Random triangle soup for property tests (brute-force vs BVH)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent / 2, extent / 2, (num_tris, 1, 3))
    offsets = rng.normal(0.0, tri_size, (num_tris, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    idx = np.arange(num_tris * 3, dtype=np.int32).reshape(-1, 3)
    albedo = rng.uniform(0.2, 0.9, (num_tris, 3)).astype(np.float32)
    return Mesh(vertices=verts, normals=compute_smooth_normals(verts, idx),
                indices=idx, albedo=albedo)


# ---------------------------------------------------------------------------
# Composite scenes (BASELINE config classes)
# ---------------------------------------------------------------------------

def teapot_scene(tris_target: int = 10_000) -> Mesh:
    """Config-1 scene: ~10k-triangle hero object (torus + spheres) on a ground
    plane, standing in for the teapot."""
    # Budget split: torus ~60%, spheres ~35%, ground/box trivial.
    seg_u = max(8, int(np.sqrt(tris_target * 0.6 / 4)) * 2)
    seg_v = max(8, seg_u // 2)
    rows = max(8, int(np.sqrt(tris_target * 0.18 / 2)))
    parts = [
        make_plane(center=(0, 0, 0), size=(20, 20), subdiv=4, albedo=(0.7, 0.7, 0.68)),
        make_torus(center=(0, 1.0, 0), R=1.6, r=0.55, seg_u=seg_u, seg_v=seg_v,
                   albedo=(0.82, 0.45, 0.25)),
        make_sphere(center=(-2.6, 0.9, 1.8), radius=0.9, rows=rows, cols=2 * rows,
                    albedo=(0.3, 0.55, 0.8)),
        make_sphere(center=(2.4, 0.7, -1.6), radius=0.7, rows=rows, cols=2 * rows,
                    albedo=(0.45, 0.75, 0.35)),
        make_box((-0.9, 0.0, -3.2), (0.9, 1.8, -1.9), albedo=(0.75, 0.7, 0.45)),
    ]
    return merge_meshes(parts)


def sponza_scene(tris_target: int = 260_000, seed: int = 7) -> Mesh:
    """Config-2/5 scene: a colonnaded hall at Crytek-Sponza scale (~260k tris).

    Two floors of columns around a rectangular atrium, a floor, walls, and a
    roof with a central opening the light shines through — enough occlusion
    structure to make shadow rays behave like the Sponza interior.
    """
    rng = np.random.default_rng(seed)
    parts: List[Mesh] = []
    hall_x, hall_z, wall_h = 36.0, 18.0, 12.0

    parts.append(make_plane(center=(0, 0, 0), size=(hall_x, hall_z), subdiv=6,
                            albedo=(0.62, 0.58, 0.52)))
    # Walls (boxes).
    t = 0.4
    parts.append(make_box((-hall_x / 2, 0, -hall_z / 2 - t), (hall_x / 2, wall_h, -hall_z / 2),
                          albedo=(0.66, 0.6, 0.5)))
    parts.append(make_box((-hall_x / 2, 0, hall_z / 2), (hall_x / 2, wall_h, hall_z / 2 + t),
                          albedo=(0.66, 0.6, 0.5)))
    parts.append(make_box((-hall_x / 2 - t, 0, -hall_z / 2), (-hall_x / 2, wall_h, hall_z / 2),
                          albedo=(0.64, 0.58, 0.5)))
    parts.append(make_box((hall_x / 2, 0, -hall_z / 2), (hall_x / 2 + t, wall_h, hall_z / 2),
                          albedo=(0.64, 0.58, 0.5)))
    # Roof slabs leaving a central skylight opening.
    roof_y = wall_h
    opening = 6.0
    parts.append(make_box((-hall_x / 2, roof_y, -hall_z / 2), (hall_x / 2, roof_y + t, -opening / 2),
                          albedo=(0.55, 0.52, 0.48)))
    parts.append(make_box((-hall_x / 2, roof_y, opening / 2), (hall_x / 2, roof_y + t, hall_z / 2),
                          albedo=(0.55, 0.52, 0.48)))

    # Columns: tri budget dominates here; solve segment count from target.
    n_cols_x, col_rows = 10, 2
    n_columns = n_cols_x * 2 * col_rows  # two rails x two floors
    base_budget = sum(m.num_triangles for m in parts)
    per_col = max(200, (tris_target - base_budget - 40_000) // n_columns)
    segments = max(12, per_col // (2 * 8 + 1))  # rings=8
    xs = np.linspace(-hall_x / 2 + 2.5, hall_x / 2 - 2.5, n_cols_x)
    for floor in range(col_rows):
        y0 = floor * (wall_h / 2)
        for zsign in (-1.0, 1.0):
            for x in xs:
                parts.append(make_cylinder(
                    center=(x, y0, zsign * (hall_z / 2 - 2.2)),
                    radius=0.45, height=wall_h / 2 - 0.5, segments=segments,
                    rings=8, cap=True,
                    albedo=(0.7 + rng.uniform(-0.05, 0.05), 0.62, 0.5)))

    # Clutter: spheres/boxes on the floor to densify occlusion detail.
    remaining = tris_target - sum(m.num_triangles for m in parts)
    n_clutter = 24
    rows = max(6, int(np.sqrt(max(remaining, 1) / n_clutter / 2.2)))
    for _ in range(n_clutter):
        x = rng.uniform(-hall_x / 2 + 3, hall_x / 2 - 3)
        z = rng.uniform(-hall_z / 2 + 3, hall_z / 2 - 3)
        r = rng.uniform(0.4, 1.1)
        parts.append(make_sphere(center=(x, r, z), radius=r, rows=rows,
                                 cols=2 * rows,
                                 albedo=rng.uniform(0.3, 0.85, 3)))
    return merge_meshes(parts)


def sponza_interior_camera(fov_y_deg: float = 65.0):
    """Camera inside the colonnaded hall, looking down the atrium — the
    representative benchmark view (Sponza is an interior scene; an exterior
    framing would measure bare walls)."""
    from .types import Camera
    return Camera.look_at((-13.0, 2.2, 0.0), (14.0, 4.5, 0.5),
                          fov_y_deg=fov_y_deg, znear=0.01, zfar=200.0)


def default_camera_for(mesh: Mesh, fov_y_deg: float = 55.0):
    """Frame the mesh: eye on a diagonal, looking at the centroid."""
    from .types import Camera
    bmin, bmax = mesh.bounds()
    center = (bmin + bmax) / 2
    diag = float(np.linalg.norm(bmax - bmin))
    eye = center + np.array([0.42, 0.35, 0.75]) * diag * 0.7
    return Camera.look_at(eye, center, fov_y_deg=fov_y_deg,
                          znear=diag * 1e-4, zfar=diag * 10)


def deform(mesh: Mesh, time: float, amplitude: float = 0.35,
           freq: float = 1.3) -> np.ndarray:
    """Config-4 animation: sinusoidal vertex displacement (host-side NumPy).
    Returns displaced vertices; topology unchanged -> BVH refit path
    applies (Renderer.set_vertices -> refit_lbvh)."""
    v = np.asarray(mesh.vertices)
    phase = v[:, 0] * freq + v[:, 2] * 0.7 * freq
    disp = np.stack([
        np.sin(phase + 2.1 * time),
        np.cos(0.8 * phase + 1.7 * time) * 0.6,
        np.sin(0.6 * phase + 2.9 * time),
    ], axis=-1) * amplitude
    return (v + disp).astype(np.float32)
