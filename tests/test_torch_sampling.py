"""The port's counter-based generator and the soft-shadow samplers (plain
PyTorch versions, CPU): Philox4x32-10 known answers, determinism,
decorrelation, the uniforms' range and moments, cone and disk samples
inside their bounds, and the soft kernel's mean visibility against
``tpurt.passes.shadow.shadow_pass`` on the same biased origins (the check
of tests/test_tpu_smoke.py's ``test_tpu_soft_kernel_statistics``, with its
bound of 0.02)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.app import make_tracers
from tpurt.bvh.sah import build_sah_lbvh as jbuild_sah_lbvh
from tpurt.passes.shadow import shadow_pass
from tpurt.scenes import teapot_scene as jteapot_scene
from tpurt.types import Light as JLight
from tpurt.types import RenderConfig as JRenderConfig
from tpurt_torch.app import Renderer, frame_seed
from tpurt_torch.bvh.wide import order_children_for_point
from tpurt_torch.camera import generate_rays
from tpurt_torch.kernels.sampling import (lane_axis_onb, onb3, philox4x32,
                                          sample_uniforms, sincos_2pi)
from tpurt_torch.kernels.traverse import (_cone_ray, _disk_ray,
                                          trace_closest_soft_shadow)
from tpurt_torch.passes.gbuffer import gbuf_from_attr_channels
from tpurt_torch.scenes import default_camera_for, teapot_scene
from tpurt_torch.types import Light, RenderConfig

from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

N = 1 << 16


def _words(*vals):
    return [torch.tensor([v], dtype=torch.int64) for v in vals]


# Random123's known-answer vectors for Philox4x32-10.
@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    got = philox4x32(*_words(*ctr), *key)
    assert [int(w) for w in got] == list(expect)


def _u(seed=7, light=0, sample=0, n=N, zero=False):
    return sample_uniforms(seed, light, torch.arange(n), sample, zero)


def test_uniforms_are_deterministic():
    a1, a2 = _u()
    b1, b2 = _u()
    assert torch.equal(a1, b1) and torch.equal(a2, b2)


def test_uniforms_range_and_moments():
    for u in _u():
        assert u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        # n = 65536: the mean's standard error is 0.0011, the variance's
        # about 0.0003.
        assert abs(float(u.double().mean()) - 0.5) < 0.006
        assert abs(float(u.double().var()) - 1.0 / 12.0) < 0.002
        # 23 bits: every value is a multiple of 2^-23.
        assert torch.equal(u * 2.0 ** 23, torch.round(u * 2.0 ** 23))


@pytest.mark.parametrize("change", ["seed", "frame", "light", "sample",
                                    "word"])
def test_uniforms_decorrelate(change):
    """Changing any key or counter word gives an unrelated stream: almost
    no equal values and a correlation within 4 standard errors of 0."""
    base = _u(seed=frame_seed(0, 0))[0]
    other = {
        "seed": lambda: _u(seed=frame_seed(1, 0))[0],
        "frame": lambda: _u(seed=frame_seed(0, 1))[0],
        "light": lambda: _u(seed=frame_seed(0, 0), light=1)[0],
        "sample": lambda: _u(seed=frame_seed(0, 0), sample=1)[0],
        "word": lambda: _u(seed=frame_seed(0, 0))[1],
    }[change]()
    assert (base == other).double().mean() < 1e-3
    corr = np.corrcoef(base.numpy(), other.numpy())[0, 1]
    assert abs(corr) < 4.0 / np.sqrt(N)


def test_zero_stream_is_zero():
    u1, u2 = _u(zero=True)
    assert not u1.any() and not u2.any()


def test_sincos_polynomial_matches_trig():
    """The reference's Taylor polynomial (degree 7 and 6 on the half angle
    in [-pi/2, pi/2)) is off by up to 1.8e-3 at the ends of the range, not
    the 1e-6 its docstring states; the port copies it as it is. For
    |t - 0.5| < 0.25 it is within 1e-5."""
    t = torch.linspace(0.0, 1.0 - 2.0 ** -23, 4097)
    s, c = sincos_2pi(t)
    ang = 2.0 * np.pi * (t.double().numpy() - 0.5)
    err = np.maximum(np.abs(s.numpy() - np.sin(ang)),
                     np.abs(c.numpy() - np.cos(ang)))
    assert err.max() < 2e-3
    mid = np.abs(t.numpy() - 0.5) < 0.25
    assert err[mid].max() < 1e-5


def test_cone_samples_stay_inside_the_cone():
    axis = torch.tensor([0.3, 0.8, -0.52])
    axis = axis / torch.linalg.norm(axis)
    t0, t1 = onb3(axis)
    cone_cos = torch.tensor(np.float32(np.cos(np.deg2rad(6.0))))
    u1, u2 = _u()
    so = tuple(torch.zeros(N) for _ in range(3))
    big = torch.tensor([1e3] * 3)
    sd, _, _ = _cone_ray(u1, u2, axis, t0, t1, cone_cos, -big, big, so,
                         torch.ones(N, dtype=torch.bool))
    sd = torch.stack(sd, dim=1).double()
    assert torch.allclose(torch.linalg.norm(sd, dim=1),
                          torch.ones(N, dtype=torch.float64), atol=1e-6)
    cos = sd @ axis.double()
    assert float(cos.min()) >= float(cone_cos) - 1e-6
    # Uniform on the cap: cos is uniform in [cone_cos, 1].
    assert abs(float(cos.mean()) - (1.0 + float(cone_cos)) / 2.0) < 1e-4


def test_disk_samples_stay_within_the_radius():
    g = torch.Generator().manual_seed(0)
    so = tuple(torch.rand(N, generator=g) * 4.0 - 2.0 for _ in range(3))
    lp = torch.tensor([0.5, 6.0, -1.0])
    radius = torch.tensor(0.4)
    e0 = (lp[0] - so[0], lp[1] - so[1], lp[2] - so[2])
    u1, u2 = _u()
    sd, _, tmax = _disk_ray(u1, u2, e0, lane_axis_onb(*e0), radius,
                            torch.ones(N, dtype=torch.bool))
    length = tmax.double() / (1.0 - 1e-4)
    target = torch.stack([so[a].double() + sd[a].double() * length
                          for a in range(3)], dim=1)
    off = target - lp.double()
    axis = torch.stack(e0, dim=1).double()
    axis = axis / torch.linalg.norm(axis, dim=1, keepdim=True)
    assert float(torch.linalg.norm(off, dim=1).max()) <= 0.4 * (1 + 1e-4)
    assert float((off * axis).sum(dim=1).abs().max()) < 1e-4
    # Uniform on the disk: the mean squared radius is radius^2 / 2.
    r2 = (torch.linalg.norm(off, dim=1) ** 2).mean()
    assert abs(float(r2) - 0.08) < 0.002


def test_frame_seeds_differ():
    seeds = {frame_seed(s, f) for s in range(4) for f in range(64)}
    assert len(seeds) == 256
    assert all(0 <= s < 2 ** 32 for s in seeds)


def test_soft_visibility_matches_shadow_pass():
    """6 deg sun, spp 16, teapot 1500, 128x96: the port's fused soft plain
    version against tpurt's scan-sampled shadow pass from the same biased
    origins, the mean visibility within 0.02."""
    mesh = teapot_scene(1500)
    cam = default_camera_for(mesh)
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=6.0)
    spp = 16
    r = Renderer(mesh, cam, sun, RenderConfig(width=128, height=96,
                                              leaf_size=8, spp=spp),
                 device="cpu")
    o, d = generate_rays(cam, 128, 96, "cpu")
    acc = order_children_for_point(r.accel, cam.position)
    ch, cnt, counts = trace_closest_soft_shadow(
        acc, o, d, sun.direction, np.cos(sun.angular_radius), spp,
        frame_seed(0, 0), 1e-3, attr_tables=r.attr_tables)
    assert counts.tolist() == [0, 0]
    gbuf = gbuf_from_attr_channels(ch, o, d, cam, mesh)
    valid = gbuf["valid"].numpy()
    vis_port = 1.0 - cnt.numpy()[valid].astype(np.float64) / spp

    jmesh = jteapot_scene(1500)
    bvh = jbuild_sah_lbvh(jmesh, 4)
    _, trace_any = make_tracers(JRenderConfig(width=128, height=96,
                                              use_pallas=False, leaf_size=4))
    jgbuf = {"position": jnp.asarray(gbuf["position"].numpy()),
             "gnormal": jnp.asarray(gbuf["gnormal"].numpy()),
             "valid": jnp.asarray(valid)}
    vis_x = np.asarray(shadow_pass(
        lambda oo, dd, tm: trace_any(bvh, oo, dd, tm), jgbuf,
        JLight.sun((0.45, 0.8, 0.3), angular_radius_deg=6.0), spp,
        jax.random.PRNGKey(3), 1e-3,
        scene_bounds=(bvh.root_min, bvh.root_max)))[valid]
    assert 0.0 < vis_port.mean() < 1.0
    assert (cnt.numpy()[valid] % spp != 0).any()     # a penumbra exists
    assert abs(vis_port.mean() - vis_x.mean()) < 0.02
