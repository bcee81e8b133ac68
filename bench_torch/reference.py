"""The plain reference that decides ``correct``, in plain torch: no kernel
and no module of the program, nothing the program built (no accel, no
attribute rows). It traces the sampled pixels of a frame against every
triangle of the frame's geometry (brute force), and shades them.

Its arithmetic copies the program's plain versions where their order of
operations sets the bits, so that sound runs agree to the last bit on all
but a few pixels:

- camera rays: ``tpurt_torch/camera.py`` ``generate_rays``;
- the ray-triangle tests (``closest_t``, ``occluders``, which the walk
  count shares): ``tpurt_torch/kernels/traverse.py``
  ``_mt_terms``, ``_leaf_closest_t`` and ``_leaf_occluders``;
- the shadow rays: ``_biased_origin``, ``_scene_exit_cap``, ``_dir_ray``
  and ``_cone_ray`` there;
- the soft samples: ``tpurt_torch/kernels/sampling.py`` (Philox4x32-10
  keyed by the frame seed and the light, counted by the pixel's index in
  the packed 32x32 tiles and the sample), ``tpurt_torch/app.py``
  ``frame_seed``;
- the shading: ``passes/gbuffer.py`` and ``passes/composite.py``, with
  the mesh's own normals and albedo (the program packs them into 12-bit
  octahedral and 8-bit channels; ``IMAGE_TOL`` covers that).

``dtype=torch.bfloat16`` computes all of it one precision below the
float32 the configurations state: that is the control.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

BIG = 3.4e38
TILE = 32
# A sampled pixel counts as off when a channel of its image differs by
# more than this: the program's 8-bit albedo and 12-bit octahedral normals
# move a channel by at most about 4e-3.
IMAGE_TOL = 0.02
# Elements of one [rays, triangles] block of the brute-force tests.
BLOCK = 1 << 24

MASK32 = 0xFFFFFFFF


def _big(dtype) -> float:
    return BIG if dtype == torch.float32 else float(torch.finfo(dtype).max)


# ---------------------------------------------------------------------------
# Seeds and samples (tpurt_torch/app.py, tpurt_torch/kernels/sampling.py)
# ---------------------------------------------------------------------------

def _mix32(h: int) -> int:
    h &= MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def frame_seed(seed: int, frame_index: int) -> int:
    """The soft kernels' key word for one frame."""
    return _mix32(_mix32(seed) + 0x9E3779B9 * (frame_index + 1))


def _mulhilo(a, m: int):
    mh, ml = m >> 16, m & 0xFFFF
    pl = a * ml
    ph = a * mh
    return (ph + (pl >> 16)) >> 16, (((ph & 0xFFFF) << 16) + pl) & MASK32


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    k0 &= MASK32
    k1 &= MASK32
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & MASK32
            k1 = (k1 + 0xBB67AE85) & MASK32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1


def _uniform(bits):
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def uniforms(seed: int, light: int, ray_index, sample: int):
    """(u1, u2) float32 of each ray index at one sample."""
    c0 = ray_index.to(torch.int64) & MASK32
    zero = torch.zeros_like(c0)
    w0, w1 = _philox(c0, torch.full_like(c0, sample & MASK32), zero, zero,
                     seed, light)
    return _uniform(w0), _uniform(w1)


def sincos_2pi(t):
    psi = 3.14159265 * (t - 0.5)
    p2 = psi * psi
    s1 = psi * (1.0 + p2 * (-1.0 / 6.0 + p2 * (1.0 / 120.0
                                               + p2 * (-1.0 / 5040.0))))
    c1 = 1.0 + p2 * (-0.5 + p2 * (1.0 / 24.0 + p2 * (-1.0 / 720.0)))
    return 2.0 * s1 * c1, 1.0 - 2.0 * s1 * s1


def onb3(d):
    s = torch.where(d[2] >= 0.0, 1.0, -1.0).to(d.dtype)
    a = -1.0 / (s + d[2])
    b = d[0] * d[1] * a
    t0 = torch.stack([1.0 + s * d[0] * d[0] * a, s * b, -s * d[0]])
    t1 = torch.stack([b, s + d[1] * d[1] * a, -d[1]])
    return t0, t1


def packed_index(y, x, width: int):
    """A pixel's index in the packed block of 32x32 tiles: tile (row-major
    over the image) x 1024 + the row-major position in the tile."""
    wt = -(-width // TILE)
    return ((y // TILE) * wt + x // TILE) * (TILE * TILE) \
        + (y % TILE) * TILE + x % TILE


# ---------------------------------------------------------------------------
# Rays
# ---------------------------------------------------------------------------

def _normalize(v, eps: float = 1e-20):
    ss = v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2] \
        + v[..., 2:3] * v[..., 2:3]
    return v / torch.sqrt(ss + eps)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _t(x, dev, dtype):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dtype)


def camera_rays(cam, width: int, height: int, y, x, dtype):
    """Origins and unit directions f[P, 3] of the pixels (y, x)."""
    dev = y.device
    pos = _t(cam.position, dev, dtype)
    forward = _normalize(_t(cam.target, dev, dtype) - pos)
    right = _normalize(_cross(forward, _t(cam.up, dev, dtype)))
    up = _cross(right, forward)
    tan_half = torch.tan(_t(cam.fov_y, dev, dtype) * 0.5)
    ndc_x = ((x.to(dtype) + 0.5) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((y.to(dtype) + 0.5) / height) * 2.0
    d = (ndc_x[:, None] * (tan_half * (width / height)) * right
         + ndc_y[:, None] * tan_half * up + forward)
    return pos.expand(y.shape[0], 3), _normalize(d)


def _mt_terms(tri, o, d):
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    nu = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    nv = dx * qx + dy * qy + dz * qz
    nt = e2x * qx + e2y * qy + e2z * qz
    return det, nu, nv, nt


def closest_t(tri, o, d):
    """The closest test of rays [n] against triangles [n or 1, m] (the
    program's ``_leaf_closest_t``) -> (t, inf where missed; u; v)."""
    det, nu, nv, nt = _mt_terms(tri, o, d)
    ok = det.abs() >= 1e-9
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    u = nu * inv_det
    v = nv * inv_det
    t = nt * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(ok & (t > 0.0), t, float("inf")), u, v


def occluders(tri, o, d, tmax):
    """The division-free any-hit test of rays [n] against triangles
    [n or 1, m] in (0, tmax) (the program's ``_leaf_occluders``) ->
    bool [n, m]."""
    det, nu, nv, nt = _mt_terms(tri, o, d)
    sgn = torch.where(det < 0.0, -1.0, 1.0).to(det.dtype)
    adet = det * sgn
    nu = nu * sgn
    nv = nv * sgn
    nt = nt * sgn
    return ((adet >= 1e-9) & (nu >= 0.0) & (nv >= 0.0)
            & (nu + nv <= adet) & (nt > 0.0)
            & (nt < tmax[:, None] * adet))


def _blocks(n_rays: int, n_tris: int):
    """(ray block, triangle block) sizes of about BLOCK elements."""
    tb = min(n_tris, max(1, BLOCK // max(1, min(n_rays, 1024))))
    rb = max(1, BLOCK // tb)
    return rb, tb


def closest_hits(geo, o, d):
    """Closest hit of every ray over every triangle, t > 0, ties to the
    lowest triangle id -> (t, id (-1 on a miss), u, v)."""
    n, dt = o.shape[0], o.dtype
    big = _big(dt)
    best_t = torch.full((n,), big, dtype=dt, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros((n,), dtype=dt, device=o.device)
    best_v = torch.zeros_like(best_u)
    rb, tb = _blocks(n, geo["n"])
    for r0 in range(0, n, rb):
        rs = slice(r0, r0 + rb)
        oc = [o[rs, a] for a in range(3)]
        dc = [d[rs, a] for a in range(3)]
        for t0 in range(0, geo["n"], tb):
            tri = [c[None, t0:t0 + tb] for c in geo["tri"]]
            cand, u, v = closest_t(tri, oc, dc)
            j = torch.argmin(cand, dim=1)
            tj = cand.gather(1, j[:, None])[:, 0]
            better = tj < best_t[rs]
            best_t[rs] = torch.where(better, tj, best_t[rs])
            best_i[rs] = torch.where(better, j + t0, best_i[rs])
            best_u[rs] = torch.where(better, u.gather(1, j[:, None])[:, 0],
                                     best_u[rs])
            best_v[rs] = torch.where(better, v.gather(1, j[:, None])[:, 0],
                                     best_v[rs])
    return best_t, best_i, best_u, best_v


def occluded(geo, o, d, tmax):
    """Does any triangle cut each ray in (0, tmax)? The program's
    division-free test; a ray leaves the test at its first occluding
    block of triangles."""
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    rb, tb = _blocks(n, geo["n"])
    for r0 in range(0, n, rb):
        live = torch.arange(r0, min(n, r0 + rb), device=o.device)
        live = live[tmax[live] > 0.0]
        for t0 in range(0, geo["n"], tb):
            if live.numel() == 0:
                break
            tri = [c[None, t0:t0 + tb] for c in geo["tri"]]
            hit = occluders(tri, [o[live, a] for a in range(3)],
                            [d[live, a] for a in range(3)],
                            tmax[live]).any(dim=1)
            occ[live[hit]] = True
            live = live[~hit]
    return occ


def geometry(vertices, indices, normals, albedo, dtype) -> dict:
    """The frame's triangles as the tests read them: v0, e1 = v1 - v0 and
    e2 = v2 - v0 per triangle (computed in float32, as the program's
    leaves hold them), the vertex normals, the albedo and the scene box."""
    v = vertices.to(torch.float32)
    idx = indices.long()
    v0, v1, v2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    tri = [x[:, a].to(dtype) for x in (v0, e1, e2) for a in range(3)]
    return {"n": idx.shape[0], "tri": tri, "indices": idx,
            "normals": normals.to(dtype), "albedo": albedo.to(dtype),
            "box": (v.amin(0).to(dtype), v.amax(0).to(dtype))}


def smooth_normals(vertices, indices):
    """Area-weighted vertex normals of a pose, float32."""
    idx = indices.long()
    v = vertices.to(torch.float32)
    fn = _cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
    n = torch.zeros_like(v)
    for c in range(3):
        n.index_add_(0, idx[:, c], fn)
    return _normalize(n)


def _exit_cap(hit, so, sinv, box, big):
    ex = None
    for a in range(3):
        t0 = (box[0][a] - so[:, a]) * sinv[:, a]
        t1 = (box[1][a] - so[:, a]) * sinv[:, a]
        m = torch.maximum(t0, t1)
        ex = m if ex is None else torch.minimum(ex, m)
    return torch.where(hit, torch.clamp(ex, min=0.0) * 1.0001, -big)


def _inv(sd, big):
    return torch.clamp(1.0 / sd, -big, big)


# ---------------------------------------------------------------------------
# The frame at the sampled pixels
# ---------------------------------------------------------------------------

def render(geo, cam, lights: Sequence, view: dict, y, x, fseed: int,
           dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The frame at pixels (y, x): hit (t, triangle id, valid), each
    light's visibility and the composited colour. ``view``: width, height,
    spp, shadow_bias, ambient, background. Every light is directional
    (hard) or a sun cone sampled ``spp`` times with ``fseed``'s stream."""
    dev = y.device
    big = _big(dtype)
    w, h = view["width"], view["height"]
    o, d = camera_rays(cam, w, h, y, x, dtype)
    t, tid, u, v = closest_hits(geo, o, d)
    hit = tid >= 0
    k = torch.clamp(tid, min=0)
    e1 = torch.stack(geo["tri"][3:6], -1)[k]
    e2 = torch.stack(geo["tri"][6:9], -1)[k]
    gn = _cross(e1, e2)
    rn = 1.0 / torch.sqrt(torch.clamp(
        gn[:, 0] * gn[:, 0] + gn[:, 1] * gn[:, 1] + gn[:, 2] * gn[:, 2],
        min=1e-30))
    flip_o = torch.where(gn[:, 0] * d[:, 0] + gn[:, 1] * d[:, 1]
                         + gn[:, 2] * d[:, 2] > 0.0, -1.0, 1.0).to(dtype)
    bias = torch.tensor(view["shadow_bias"], dtype=torch.float32,
                        device=dev).to(dtype)
    off = bias * rn * flip_o
    so = torch.stack([o[:, a] + t * d[:, a] + gn[:, a] * off
                      for a in range(3)], -1)
    ray_index = packed_index(y, x, w)
    vis = []
    for li, light in enumerate(lights):
        axis = _t(light.direction, dev, dtype)
        if light.kind == 2:           # a sun cone, sampled spp times
            spp = view["spp"]
            cone_cos = _t(np.cos(np.float32(light.angular_radius)), dev,
                          dtype)
            b0, b1 = onb3(axis)
            cnt = torch.zeros(y.shape, dtype=torch.int32, device=dev)
            for s in range(spp):
                u1, u2 = uniforms(fseed, li, ray_index, s)
                u1, u2 = u1.to(dtype), u2.to(dtype)
                cos_t = 1.0 - u1 * (1.0 - cone_cos)
                sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
                sphi, cphi = sincos_2pi(u2)
                sc = sin_t * cphi
                ss = sin_t * sphi
                sd = torch.stack([axis[a] * cos_t + b0[a] * sc + b1[a] * ss
                                  for a in range(3)], -1)
                srn = 1.0 / torch.sqrt(torch.clamp(
                    sd[:, 0] * sd[:, 0] + sd[:, 1] * sd[:, 1]
                    + sd[:, 2] * sd[:, 2], min=1e-20))
                sd = sd * srn[:, None]
                tmax = _exit_cap(hit, so, _inv(sd, big), geo["box"], big)
                cnt += occluded(geo, so, sd, tmax).to(torch.int32)
            vis.append(torch.where(hit, 1.0 - cnt.to(dtype) / spp,
                                   1.0).to(dtype))
        elif light.kind == 0:         # directional, hard
            sd = axis.expand(y.shape[0], 3)
            tmax = _exit_cap(hit, so, _inv(sd, big), geo["box"], big)
            occ = occluded(geo, so, sd, tmax)
            vis.append(torch.where(hit & occ, 0.0, 1.0).to(dtype))
        else:
            raise ValueError(f"light kind {light.kind} has no reference")
    tri = geo["indices"][k]
    nrm = geo["normals"]
    n0, n1, n2 = nrm[tri[:, 0]], nrm[tri[:, 1]], nrm[tri[:, 2]]
    smooth = _normalize(n0 + u[:, None] * (n1 - n0) + v[:, None] * (n2 - n0))
    gnorm = _normalize(gn)
    gd = gnorm * d
    facing = torch.sign(-(gd[:, 0:1] + gd[:, 1:2] + gd[:, 2:3]))
    facing = torch.where(facing == 0, 1.0, facing).to(dtype)
    normal = torch.where(hit[:, None], smooth, 0.0) * facing
    albedo = torch.where(hit[:, None], geo["albedo"][k], 0.0)
    img = None
    for li, light in enumerate(lights):
        ldir = _t(light.direction, dev, dtype)
        ndl = torch.clamp(normal[:, 0] * ldir[0] + normal[:, 1] * ldir[1]
                          + normal[:, 2] * ldir[2], min=0.0)
        radiance = _t(light.color, dev, dtype) * _t(light.intensity, dev,
                                                    dtype)
        direct = (ndl * vis[li])[:, None] * radiance
        if img is None:
            img = albedo * (direct + view["ambient"])
        else:
            img = img + albedo * direct
    bg = torch.tensor(view["background"], dtype=dtype, device=dev)
    img = torch.where(hit[:, None], img, bg)
    return {"t": t.float(), "tri_id": tid, "valid": hit,
            "shadow": torch.stack(vis).float(), "image": img.float()}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers that decide ``correct``, of a frame's sampled pixels
    (``got``) against the reference (``want``):

    - hit_off: share of pixels whose hit or triangle differs;
    - t_err: the largest relative error of t where both hit one triangle;
    - shadow_off: share of (such pixel, light) pairs whose visibility
      differs;
    - image_off: share of pixels with a channel off by more than
      IMAGE_TOL."""
    gv, wv = got["valid"], want["valid"]
    same_tri = got["tri_id"].long() == want["tri_id"].long()
    off = (gv != wv) | (wv & ~same_tri)
    same = gv & wv & same_tri
    rel = (got["t"] - want["t"]).abs() / want["t"].abs().clamp(min=1e-6)
    t_err = float(rel[same].max()) if bool(same.any()) else 0.0
    sh = (got["shadow"] != want["shadow"])[:, same]
    shadow_off = float(sh.float().mean()) if sh.numel() else 0.0
    img = (got["image"] - want["image"]).abs().amax(dim=1) > IMAGE_TOL
    return {"hit_off": float(off.float().mean()), "t_err": t_err,
            "shadow_off": shadow_off,
            "image_off": float(img.float().mean())}
