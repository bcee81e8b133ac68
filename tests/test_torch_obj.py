"""The port's OBJ/MTL loader (``tpurt_torch.io.obj``) against the JAX
package's (``tpurt.io.obj``) on the same files: an OBJ with v/vt/vn,
negative indices, a quad, faces with and without materials, an MTL with
two diffuse maps (PNG, one of them not square), a flat Kd, a material
without Kd and an unresolved name. Each parser (the shared native one and
the pure-Python one) must give arrays equal to ``tpurt``'s same parser:
vertices, normals, indices, albedo, uv, tri_tex and the atlas."""

import numpy as np
import pytest

import tpurt.io.obj as jobj
import tpurt_torch.io.obj as tobj
import tpurt_torch.scenes as tscenes
from tpurt_torch import native
from tpurt_torch.io.image import write_png

from test_torch_native import ensure_native_libraries

ensure_native_libraries()

FIELDS = ("vertices", "normals", "indices", "albedo", "uv", "tri_tex",
          "tex_atlas")


def _write_scene(d):
    rng = np.random.default_rng(11)
    write_png(str(d / "bricks.png"),
              (rng.random((16, 12, 3)) * 255).astype(np.uint8))
    write_png(str(d / "tiles.png"),
              (rng.random((5, 5, 3)) * 255).astype(np.uint8))
    (d / "scene.mtl").write_text(
        "# materials\n"
        "newmtl bricks\nKd 0.9 0.2 0.1\nmap_Kd bricks.png\n"
        "newmtl tiles\nKd 0.1 0.2 0.3\nmap_Kd -s 1 1 1 tiles.png\n"
        "newmtl flat\nKd 0.2 0.9 0.2\n"
        "newmtl nokd\n"
        "newmtl missing_map\nmap_Kd nowhere.png\n")
    lines = ["mtllib scene.mtl"]
    for y in range(4):
        for x in range(4):
            lines.append(f"v {x * 0.5} {y * 0.5} {0.1 * x * y}")
            lines.append(f"vt {x * 0.7 - 0.4} {y * 1.3}")
            lines.append(f"vn {0.1 * x} 1 {0.05 * y}")
    lines.append("f 1/1/1 2/2/2 6/6/6")
    lines.append("usemtl bricks")
    lines.append("f 2/2/2 3/3/3 7/7/7 6/6/6")              # a quad
    lines.append("f -13/-13/-13 -12/-12/-12 -9/-9/-9")    # negative refs
    lines.append("usemtl tiles")
    lines.append("f 5/5/5 6/6/6 10/10/10")
    lines.append("f 6/6 7/7 11/11")
    lines.append("usemtl flat")
    lines.append("f 9//9 10//10 14//14")
    lines.append("usemtl nokd")
    lines.append("f 10/10/10 11/11/11 15/15/15")
    lines.append("usemtl unknown_name")
    lines.append("f 11/11/11 12/12/12 16/16/16")
    lines.append("usemtl missing_map")
    lines.append("f 3/3/3 4/4/4 8/8/8")
    lines.append("usemtl bricks")
    lines.append("f 9 13 14")
    (d / "scene.obj").write_text("\n".join(lines) + "\n")
    return str(d / "scene.obj")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _write_scene(tmp_path_factory.mktemp("obj"))


def _assert_equal_meshes(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


@pytest.mark.parametrize("use_native", [False, True])
def test_load_obj_equals_jax(scene, use_native):
    if use_native:
        assert native.available()
    got = tobj.load_obj(scene, use_native=use_native)
    want = jobj.load_obj(scene, use_native=use_native)
    assert got.textured and want.textured
    _assert_equal_meshes(got, want)
    assert got.tex_atlas.shape == (2, tobj.ATLAS_RES, tobj.ATLAS_RES, 3)
    assert sorted(set(np.asarray(got.tri_tex).tolist())) == [-1, 0, 1]


def test_both_parsers_agree(scene):
    """The parsers number the deduplicated vertices in different orders
    (first use against a sorted unique), as ``tpurt``'s do: every
    triangle's corners, its layer and albedo, and the atlas agree."""
    a = tobj.load_obj(scene, use_native=True)
    b = tobj.load_obj(scene, use_native=False)
    ia, ib = np.asarray(a.indices), np.asarray(b.indices)
    assert a.num_vertices == b.num_vertices
    for f in ("vertices", "normals", "uv"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[ia],
                                      np.asarray(getattr(b, f))[ib],
                                      err_msg=f)
    for f in ("albedo", "tri_tex", "tex_atlas"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_default_parser_is_the_native_one(scene):
    _assert_equal_meshes(tobj.load_obj(scene),
                         tobj.load_obj(scene, use_native=True))


def test_parse_mtl_defaults_and_maps(scene, tmp_path):
    import os
    table = tobj.parse_mtl(os.path.join(os.path.dirname(scene), "scene.mtl"))
    want = jobj.parse_mtl(os.path.join(os.path.dirname(scene), "scene.mtl"))
    assert table.keys() == want.keys()
    for name in table:
        np.testing.assert_array_equal(table[name]["kd"], want[name]["kd"])
        assert table[name]["map_kd"] == want[name]["map_kd"]
    np.testing.assert_array_equal(table["nokd"]["kd"],
                                  np.full(3, 0.8, np.float32))
    assert table["nokd"]["map_kd"] is None
    assert table["tiles"]["map_kd"] == "tiles.png"
    assert tobj.parse_mtl(str(tmp_path / "absent.mtl")) == {}


def test_untextured_obj_has_no_atlas(tmp_path):
    (tmp_path / "plain.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\n"
        "f 1/1 2/1 3/1\nf 2 4 3\n")
    for use_native in (False, True):
        got = tobj.load_obj(str(tmp_path / "plain.obj"),
                            use_native=use_native)
        assert not got.textured and got.uv is None
        _assert_equal_meshes(got, jobj.load_obj(str(tmp_path / "plain.obj"),
                                                use_native=use_native))


@pytest.mark.parametrize("use_native", [False, True])
def test_no_faces_raises(tmp_path, use_native):
    (tmp_path / "empty.obj").write_text("v 0 0 0\nv 1 0 0\n")
    with pytest.raises(ValueError, match="no faces"):
        tobj.load_obj(str(tmp_path / "empty.obj"), use_native=use_native)


def test_save_obj_round_trip(tmp_path):
    mesh = tscenes.teapot_scene(800)
    path = str(tmp_path / "teapot.obj")
    tobj.save_obj(path, mesh)
    jpath = str(tmp_path / "teapot_jax.obj")
    jobj.save_obj(jpath, mesh)
    assert open(path).read() == open(jpath).read()
    back = tobj.load_obj(path)
    np.testing.assert_array_equal(np.asarray(back.vertices)[
        np.asarray(back.indices)], np.asarray(mesh.vertices)[
        np.asarray(mesh.indices)])
    np.testing.assert_allclose(np.asarray(back.normals)[
        np.asarray(back.indices)], np.asarray(mesh.normals)[
        np.asarray(mesh.indices)], atol=1e-6)
    _assert_equal_meshes(back, jobj.load_obj(path))
