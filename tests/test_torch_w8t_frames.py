"""Frames on a WideBVHT (``tpurt``'s w8t accel, leaf 16): the port (CPU,
plain versions of the w8t kernels) against the JAX package (CPU, Pallas
interpret mode) on ``tpurt``'s own accel carried across by
``tpurt_torch.convert``, teapot 1500, 64x48, ``gbuffer="ray"`` in both
configs.

- ``render_frame_fn`` with the shade table and a directional light: the
  w8t closest hit, the table's row gather, the w8t any hit; held as
  tests/test_torch_binary_frames.py holds the binary frames (t and depth
  to 1e-6 relative, tri_id on >= 99.9% of valid pixels, shadows on all
  but 1e-3 of them, the decode against ``tpurt``'s decode of the port's
  hits, the image as tests/test_torch_app.py holds frames).
- A 4 deg sun at spp 4 through the shadow pass's loop over samples (no
  in-kernel sampler takes a WideBVHT, decision 13), held statistically
  (decision 6): the share of pixels more than 2 levels off ``tpurt``'s
  seed-0 frame at most twice that of ``tpurt``'s seed-1 frame.
- ``gbuffer_attr_pass`` with the transposed attribute rows against
  ``tpurt``'s (the w8t attribute walk and the channel decode).
- The five routing points, as pure functions: ``frame_route`` gives
  "unfused", ``_gb_accel`` returns the accel as it is, ``seeded_gbuffer``
  is ignored, the soft samplers are None, and ``attr_tables`` are
  ignored, as ``tpurt`` gates each on a WideBVH (``app.py`` :239, :249,
  :95, :114, :305).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpurt.app as japp
import tpurt.bvh.lbvh as jlbvh
import tpurt.bvh.wide as jwide
import tpurt.passes.gbuffer as jgbuffer
import tpurt.passes.shading as jshading
import tpurt.scenes as jscenes
import tpurt.types as jtypes
import tpurt_torch.app as tapp
import tpurt_torch.convert as convert
import tpurt_torch.kernels.traverse as tr
from tpurt_torch.bvh.wide import WideBVH
from tpurt_torch.camera import generate_rays
from tpurt_torch.passes.gbuffer import gbuffer_attr_pass
from tpurt_torch.types import Light, RenderConfig

from test_torch_binary_frames import _off, check_frames
from test_torch_multi_shadow import jax_checks_off
from test_torch_native import ensure_native_libraries

torch.set_num_threads(1)
ensure_native_libraries()

DIRECTION = (0.45, 0.8, 0.3)
FILL = (-0.5, 0.7, 0.2)
W, H, LEAF = 64, 48, 16


@functools.lru_cache(maxsize=None)
def accel():
    """tpurt's leaf-16 WideBVHT of the teapot, its shade table and
    transposed attribute rows, and the port's copies of each; the row
    accel of the same tree (for the routing contrasts)."""
    jmesh = jscenes.teapot_scene(1500)
    with jax_checks_off():
        jb = jlbvh.build_lbvh(jnp.asarray(jmesh.vertices),
                              jnp.asarray(jmesh.indices), leaf_size=LEAF)
        jw = jwide.build_wide(jb)
        jt = jwide.build_wide_t(jw, jb)
        jst = jshading.make_shade_table(jb, jmesh)
        jat = jshading.make_leaf_attr_rows_t(jb, jmesh)
    tmesh = convert.mesh(convert.numpy_fields(jmesh)).on("cpu")
    return dict(jmesh=jmesh, jt=jt, jst=jst, jat=jat, tmesh=tmesh,
                acc=convert.wide_bvh_t(convert.numpy_fields(jt), "cpu"),
                wide=convert.wide_bvh(convert.numpy_fields(jw), "cpu"),
                tst=convert.shade_table(jst, "cpu"),
                tat=convert.attr_tables(*jat, "cpu"),
                jcam=jscenes.default_camera_for(jmesh),
                tcam=convert.camera(convert.numpy_fields(
                    jscenes.default_camera_for(jmesh))))


def _cfg(**fields):
    return RenderConfig(**dict(dict(width=W, height=H, leaf_size=LEAF,
                                    gbuffer="ray"), **fields))


def _jax_frame(light, seed=0, **fields):
    s = accel()
    cfg = jtypes.RenderConfig(**dict(dict(width=W, height=H, leaf_size=LEAF,
                                          gbuffer="ray"), **fields))
    with jax_checks_off():
        out = japp.render_frame_fn(s["jt"], s["jmesh"], s["jcam"], (light,),
                                   jax.random.PRNGKey(seed), cfg,
                                   shade_table=s["jst"])
        return {k: np.asarray(v) for k, v in out.items()}


def test_render_frame_fn_w8t_with_the_shade_table():
    s = accel()
    j = _jax_frame(jtypes.Light.directional(DIRECTION))
    t = tapp.render_frame_fn(s["acc"], s["tmesh"], s["tcam"],
                             [Light.directional(DIRECTION)], _cfg(),
                             shade_table=s["tst"])
    sidx = tr.trace_closest(s["acc"], *generate_rays(s["tcam"], W, H,
                                                     "cpu"),
                            return_sorted=True)[2].numpy()
    rows = s["jst"][np.clip(sidx, 0, s["jst"].shape[0] - 1)]
    decode = jax.jit(jshading.shade_from_table)(
        rows, t["position"].numpy(), t["valid"].numpy())
    check_frames(j, t, decode)


def test_w8t_sun_spp4_loops_over_samples_held_statistically(monkeypatch):
    """No in-kernel sampler takes a WideBVHT: the sun's spp samples are
    spp w8t any-hit calls; tpurt's scan draws jax.random samples, the
    port its Philox ones, so the port's seed-0 frame may be no further
    from tpurt's seed-0 frame than twice tpurt's own seed-1 frame is."""
    s = accel()
    jsun = jtypes.Light.sun(DIRECTION, angular_radius_deg=4.0)
    ref = _jax_frame(jsun, 0, spp=4)["image"]
    noise_img = _jax_frame(jsun, 1, spp=4)["image"]
    calls = []
    real = tr.w8t_any_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tr, "w8t_any_reference", counted)
    out = tapp.render_frame_fn(
        s["acc"], s["tmesh"], s["tcam"],
        [Light.sun(DIRECTION, angular_radius_deg=4.0)], _cfg(spp=4),
        seed=tapp.frame_seed(0, 0), shade_table=s["tst"])
    assert len(calls) == 4
    assert out["walk_counts"].tolist() == [0, 0]
    vis = out["shadow"][0][out["valid"]]
    assert ((vis > 0) & (vis < 1)).any()           # a penumbra was sampled
    assert set(np.unique((vis * 4).numpy())) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    noise = _off(noise_img, ref)
    ours = _off(out["image"].numpy(), ref)
    assert noise > 0.0
    assert ours <= 2.0 * noise, f"port {ours:.4%} vs seed noise {noise:.4%}"


def test_gbuffer_attr_pass_on_w8t_matches_tpurt():
    """The w8t attribute walk and the channel decode: hit sets equal, t
    and depth to 1e-6 relative, tri_id on >= 99.9% of valid pixels, the
    position to 1e-5, the smooth normal to 2e-5 and the geometric normal
    to 1e-6 where the triangle is the same (the barycentrics to 1e-4,
    decision 1), the albedo exact."""
    s = accel()
    with jax_checks_off():
        j = {k: np.asarray(v) for k, v in jgbuffer.gbuffer_attr_pass(
            s["jt"], s["jat"], s["jmesh"], s["jcam"], W, H).items()}
    gbuf, counts = gbuffer_attr_pass(s["acc"], s["tat"], s["tmesh"],
                                     s["tcam"], W, H)
    t = {k: v.numpy() for k, v in gbuf.items()}
    assert counts.tolist() == [0, 0]
    valid = j["valid"]
    np.testing.assert_array_equal(t["valid"], valid)
    assert valid.any() and not valid.all()
    same = (t["tri_id"] == j["tri_id"]) & valid
    assert same.sum() >= 0.999 * valid.sum()
    for key in ("t", "depth"):
        np.testing.assert_allclose(t[key][valid], j[key][valid], rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for key, atol in (("position", 1e-5), ("normal", 2e-5),
                      ("gnormal", 1e-6), ("albedo", 0.0)):
        np.testing.assert_allclose(t[key][same], j[key][same], atol=atol,
                                   rtol=0, err_msg=key)


LIGHT_SETS = [[Light.directional(DIRECTION)],
              [Light.directional(DIRECTION), Light.directional(FILL)],
              [Light.sun(DIRECTION, angular_radius_deg=4.0),
               Light.directional(FILL)]]


def test_repair_a_w8t_accel_routes_unfused():
    """The light sets that take fused0, fusedN and fusedSM on the row
    accel route "unfused" on a WideBVHT; render_frame_fn takes that
    route (one any-hit call per light)."""
    s = accel()
    cfg = _cfg(spp=2)
    assert [tapp.frame_route(cfg, ls, s["wide"]) for ls in LIGHT_SETS] == \
        ["fused0", "fusedN", "fusedSM"]
    assert [tapp.frame_route(cfg, ls, s["acc"]) for ls in LIGHT_SETS] == \
        ["unfused"] * 3
    out = tapp.render_frame_fn(s["acc"], s["tmesh"], s["tcam"],
                               LIGHT_SETS[1], cfg, shade_table=s["tst"])
    assert out["shadow"].shape[0] == 2
    assert out["walk_counts"].tolist() == [0, 0]


def test_repair_the_gbuffer_walks_a_w8t_accel_as_it_is():
    """tpurt orders only WideBVH children: _gb_accel hands a WideBVHT
    back unchanged, and orders the row accel's."""
    s = accel()
    cfg = _cfg(order_children=True)
    assert tapp._gb_accel(s["acc"], s["tcam"], cfg) is s["acc"]
    ordered = tapp._gb_accel(s["wide"], s["tcam"], cfg)
    assert isinstance(ordered, WideBVH) and ordered is not s["wide"]


def test_repair_seeded_gbuffer_is_ignored_on_a_w8t_accel(monkeypatch):
    """trace_closest_pallas takes a WideBVHT's branch before it reads
    ``seeded``: no seed walk runs and the G-buffer is the unseeded one."""
    s = accel()
    fields = dict(fused_shadow=False)
    plain, _ = tapp.gbuffer_production(s["acc"], s["tmesh"], s["tcam"],
                                       _cfg(**fields), None, s["tst"])

    def no_seed(*a, **k):
        raise AssertionError("the seed walk ran on a WideBVHT")
    monkeypatch.setattr(tr, "first_hit_reference", no_seed)
    seeded, counts = tapp.gbuffer_production(
        s["acc"], s["tmesh"], s["tcam"],
        _cfg(seeded_gbuffer=True, **fields), None, s["tst"])
    assert counts.tolist() == [0, 0]
    for k in ("t", "tri_id", "normal", "albedo"):
        assert torch.equal(plain[k], seeded[k]), k


def test_repair_no_soft_sampler_takes_a_w8t_accel(monkeypatch):
    """tpurt's make_soft_tracer and make_point_soft_tracer return None for
    anything but a WideBVH: the shadow pass gets no samplers on a
    WideBVHT, and the in-kernel ones on the row accel."""
    s = accel()
    seen = {}

    def record(trace_any, gbuf, light, *args, trace_soft, trace_soft_point,
               **kw):
        seen[trace_any.args[0].__class__.__name__] = (trace_soft,
                                                      trace_soft_point)
        return None, None
    monkeypatch.setattr(tapp, "shadow_pass", record)
    sun = Light.sun(DIRECTION, angular_radius_deg=4.0)
    for acc in (s["acc"], s["wide"]):
        tapp.shadow_production(acc, {}, sun, 0, 0, _cfg(spp=4))
    assert seen["WideBVHT"] == (None, None)
    assert all(f is not None for f in seen["WideBVH"])


def test_repair_attr_tables_are_ignored_on_a_w8t_accel(monkeypatch):
    """tpurt takes the attribute pass on a WideBVH alone (app.py:249):
    on a WideBVHT the frame reads the shade table if one is given, else
    the mesh by triangle id."""
    s = accel()

    def no_attr_pass(*a, **k):
        raise AssertionError("gbuffer_attr_pass ran on a WideBVHT")
    monkeypatch.setattr(tapp, "gbuffer_attr_pass", no_attr_pass)
    cfg = _cfg(fused_shadow=False)
    for table in (s["tst"], None):
        want, _ = tapp.gbuffer_production(s["acc"], s["tmesh"], s["tcam"],
                                          cfg, None, table)
        got, _ = tapp.gbuffer_production(s["acc"], s["tmesh"], s["tcam"],
                                         cfg, s["tat"], table)
        assert torch.equal(want["tri_id"], got["tri_id"])
        assert torch.equal(want["normal"], got["normal"])
    lights = [Light.directional(DIRECTION)]
    a = tapp.render_frame_fn(s["acc"], s["tmesh"], s["tcam"], lights, cfg,
                             attr_tables=s["tat"], shade_table=s["tst"])
    b = tapp.render_frame_fn(s["acc"], s["tmesh"], s["tcam"], lights, cfg,
                             shade_table=s["tst"])
    assert torch.equal(a["image"], b["image"])
