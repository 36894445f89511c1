"""The port's host scene core (pathtracer_tpu_torch/native.py,
csrc/scenecore.cpp) against the port's Python path (scene/objfile.py,
scene/bvh.py _emit_python) and the JAX package's NumPy path, exactly:
every float compared bit for bit (NaN by position), the exception type
where the Python parser raises, the packed scene field by field.

CPU only: the core is built with the host's C++ compiler at first use
(render/_build.py build_host). No JAX compile. The JAX package's native
core is never used: its parser and NumPy builder are called directly, and
its scenes are packed through _torch_parity.jax_twin (its native core
patched off).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_fields_np, jax_twin
from _torch_scenes import size_check_scene
from pathtracer_tpu.scene import bvh as jbvh
from pathtracer_tpu.scene import objfile as jobj
from pathtracer_tpu_torch import assets, native
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render import _build
from pathtracer_tpu_torch.scene import bvh, objfile, shapes
from pathtracer_tpu_torch.scenes import _models, get_scene

FIELDS = ("p1", "p2", "p3", "n1", "n2", "n3", "face_n", "color", "refr")
CFG = RenderConfig(width=16, height=12, samples=2)


def same_bits(a, b) -> bool:
    """Equal shapes, NaN at the same places, every other value the same
    bits (so -0.0 differs from 0.0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.uint64), b[~nb].view(np.uint64))


def python_parse(mod, text, normals_groups, mtl_dir="."):
    """A package's Python parse of `text` (`mod`: its scene.objfile) with
    load_model's vertex normals, as soup arrays; the exception type if it
    raises."""
    try:
        model = mod.parse_obj(text, mtl_dir=mtl_dir)
    except Exception as e:
        return type(e)
    group = model.to_group()
    if normals_groups:
        n = len(group.children) if normals_groups < 0 else normals_groups
        mod.compute_vertex_normals(
            [t for c in group.children[:n] for t in c.children])
    tris = model.all_triangles()

    def stack(f):
        return np.array([np.asarray(f(t), np.float64)[:3] for t in tris],
                        np.float64).reshape(-1, 3)
    arrays = {k: stack(lambda t, k=k: getattr(t, k)) for k in FIELDS[:6]}
    arrays["face_n"] = stack(lambda t: t.n)
    arrays["color"] = stack(lambda t: t.material.color)
    arrays["refr"] = np.array([t.material.refractive_index for t in tris],
                              np.float64)
    return arrays, model.group_order, model.ignored_lines


def native_parse(text, normals_groups, mtl_dir="."):
    try:
        s = native.parse_obj(text, mtl_dir=mtl_dir,
                             normals_groups=normals_groups)
    except Exception as e:
        return type(e)
    return {k: getattr(s, k) for k in FIELDS}, s.group_names, s.ignored_lines


def assert_same_parse(got, want):
    if isinstance(want, type):
        assert got is want
        return
    assert not isinstance(got, type), got
    for k in FIELDS:
        assert same_bits(got[0][k], want[0][k]), k
    assert got[1:] == want[1:]


def assert_all_agree(text, normals_groups, mtl_dir="."):
    """The core, the port's parser and the JAX package's parser agree;
    returns the core's result."""
    got = native_parse(text, normals_groups, mtl_dir)
    assert_same_parse(got, python_parse(objfile, text, normals_groups,
                                        mtl_dir))
    assert_same_parse(got, python_parse(jobj, text, normals_groups, mtl_dir))
    return got


MTL = ("newmtl red\nKa 0.1 0 0\nKd 0.5 0.1 0.1\nKs 0 0 0.2\nNi 1.4\n"
       "newmtl blue\nKd 0.1 0.2 0.9\n")
MTL2 = "newmtl red\nKd 0.3 0.3 0.3\nNi 1.1\n"
MIXED = "\n".join([
    "# a model whose groups interleave", "usemtl red", "v 0 0 0",
    "v 1 0 0", "v 1 1 0", "v 0 1 0.5", "v 0.5 0.5 1", "vt 0 0",
    "vn 0 0 1", "vn 0 1 0", "f 1 2 3", "mtllib m.mtl", "g a", "usemtl red",
    "f 1//1 2//1 3//2 4//2", "g b", "f -1 -2 -3", "usemtl blue",
    "f 2/1/2 3/1/1 5/1/1", "g a", "f 1/1 3/1 5/1", "o c",
    "usemtl nothing", "f 1//2 4//2 5//1", "mtllib m2.mtl", "g b",
    "usemtl red", "f 2//1 4//1 5//2 1//2", "g DefaultGroup", "f 5 4 3",
    "s off", "", "   "]) + "\r\n"
MODELS = {
    "sphere": lambda d: assets.uv_sphere_obj(12, 16),
    "goblet": lambda d: assets.goblet_obj(12),
    "mixed": lambda d: MIXED,
}


@pytest.fixture
def mtl_dir(tmp_path):
    (tmp_path / "m.mtl").write_text(MTL)
    (tmp_path / "m2.mtl").write_text(MTL2)
    return str(tmp_path)


@pytest.mark.parametrize("normals_groups", [0, 1, -1])
@pytest.mark.parametrize("model", list(MODELS))
def test_parse_equals_python(model, normals_groups, mtl_dir):
    got = assert_all_agree(MODELS[model](mtl_dir), normals_groups, mtl_dir)
    assert len(got[0]["p1"]) > 0


BASE = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nvn 0 0 1\n"
# (text, the outcome: a triangle count or the exception type)
EDGE = {
    "negative": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1", 1),
    "negative_placeholder": ("v 1 0 0\nv 0 1 0\nf -2 -1 -3", 1),
    "out_of_range": (BASE + "f 1 2 3\nf 1 2 99", IndexError),
    "zero_is_the_placeholder": (BASE + "f 0 1 2", 1),
    "bad_int": (BASE + "f 1 2 xyz", ValueError),
    "bad_float": ("v a b c", ValueError),
    "negative_out_of_range": (BASE + "f -99 1 2", IndexError),
    "normal_out_of_range": (BASE + "f 1//1 2//9 3//1", IndexError),
    "slash_without_normals": (BASE + "f 1/1 2/2 3/3 4/4", 2),
    "four_pieces": (BASE + "f 1/1/1/1 2/2/1 3/3/1", 1),
    "missing_normal_piece": (BASE + "f 1//1 2 3//1", IndexError),
    "empty_normal_piece": (BASE + "f 1/2/ 2/3/1 3//1", 1),
    "first_corner_slashless": (BASE + "f 1 2//1 3//1", 1),
    "empty_vertex_piece": (BASE + "f /1/1 2//1 3//1", ValueError),
    "short_faces": (BASE + "f 1 2\nf\nf 1", 0),
    "short_v": ("v 1 2", IndexError),
    "short_vn": ("vn 1", IndexError),
    "extra_fields": ("v 0 0 0 1\nv 1 0 0 1\nv 0 1 0 1 2\nf 1 2 3 junk",
                     ValueError),
    "g_alone": ("g", IndexError),
    "usemtl_alone": ("usemtl", IndexError),
    "mtllib_alone": ("mtllib", IndexError),
    "mtllib_missing": (BASE + "mtllib nope.mtl", FileNotFoundError),
    "error_before_mtllib": ("v 1 2\nmtllib nope.mtl", IndexError),
    "usemtl_before_mtllib": ("usemtl red\n" + BASE + "mtllib m.mtl\n"
                             "f 1/1/1 2/1/1 3/1/1\nusemtl red\n"
                             "f 1/1/1 3/1/1 4/1/1", 2),
    "ignored_lines": ("# c\n\n  \n\t\nvt 0 0\ns off\nl 1 2\nv 0 0 0\r\n"
                      "v 1 0 0\r\nv 0 1 0\r\nf 1 2 3\r\n", 1),
    "empty": ("", 0),
    "numbers": ("v 1_0 -2.5e1_0 .5\nv 1. +3 -0\nv 0 0 4.9e-324\n"
                "v 1e400 -1E-400 0_0.0_1\nf 1 2 3\nf 2 3 4\nf 0_1 +2 3", 3),
    "inf_nan": ("v inf -Infinity 1\nv NaN -nan 0\nv 0 1 0\nv 1 1 1\n"
                "f 1 2 3\nf 2 3 4\nf 3 4 1", 3),
    "hex_float": ("v 0x1p3 0 0", ValueError),
    "trailing_underscore": ("v 1_ 0 0", ValueError),
    "double_underscore": ("v 1__0 0 0", ValueError),
    "leading_underscore": ("v _1 0 0", ValueError),
    "bare_exponent": ("v 1e 0 0", ValueError),
    "bare_point": ("v . 0 0", ValueError),
    "suffix": ("v 1.5f 0 0", ValueError),
    "nan_payload": ("v nan(1) 0 0", ValueError),
    "underscore_after_point": ("v 1._5 0 0", ValueError),
    "double_sign": ("v ++1 0 0", ValueError),
    "float_index": (BASE + "f 1.0 2 3", ValueError),
    "long_index": (BASE + "f " + "0" * 4299 + "1 2 3", 1),
    "too_many_digits": (BASE + "f " + "0" * 5000 + "1 2 3", ValueError),
    "huge_index": (BASE + "f 99999999999999999999999 1 2", IndexError),
    "unicode_digits": ("v \u0661 \u0662.\u0665 3\nv 1 0 0\nv 0 1 0\n"
                       "f \u0661 2 x\u0663", ValueError),
    "unicode_indices": ("v \u0661 \u0662.\u0665 3\nv 1 0 0\nv 0 1 0\n"
                        "vn 0 0 1\nf \u0661 2 \u0663\n"
                        "f \u0661//\u0661 2//\u0661 3//1", 2),
    "unicode_space": ("v\u00a01\u20030\u30000\nv 1 0 0\u2028\n"
                      "v\x1c0 1 0\nf\u00851 2 3\ng gr\u00fcppe\u205fx\n"
                      "f 3 2 1", 2),
    "unicode_junk": ("v \u0661x 0 0", ValueError),
    "nul": ("v 0 0 0\x00\nv 1 0 0", ValueError),
    "surrogate_group": (BASE + "g \ud800x\nf 1 2 3", 1),
    "groups_interleave": (BASE + "g a\nf 1 2 3\ng b\nf 2 3 4\ng a\n"
                          "f 3 4 1\no b\nf 1 3 4\ng DefaultGroup\n"
                          "f 1 2 4", 5),
    "degenerate": ("v 1 1 1\nv 1 1 1\nv 1 1 1\nv 2 1 1\nf 1 2 3\n"
                   "f 1 2 4", 2),
}


@pytest.mark.parametrize("case", list(EDGE))
def test_parse_edge_inputs(case, mtl_dir):
    text, outcome = EDGE[case]
    for normals_groups in (0, -1):
        got = assert_all_agree(text, normals_groups, mtl_dir)
        if isinstance(outcome, type):
            assert got is outcome
        else:
            assert len(got[0]["p1"]) == outcome


def test_parse_error_names_the_line():
    with pytest.raises(IndexError, match="line 6 .*'f 1 2 99'"):
        native.parse_obj(BASE + "f 1 2 99")


@functools.lru_cache(maxsize=None)
def _mesh(name):
    text = {"sphere": assets.uv_sphere_obj(12, 16),
            "goblet": assets.goblet_obj(16),
            # the size of the JAX package's timing table's middle row
            "sphere-16380": assets.uv_sphere_obj(66, 126)}[name]
    s = native.parse_obj(text)
    return s.p1, s.p2, s.p3


def assert_bvh_agrees(p1, p2, p3, leaf):
    got = native.build_bvh(p1, p2, p3, leaf)
    boxes = bvh.triangle_boxes(p1, p2, p3)
    for want in (bvh._emit_python(*boxes, len(p1), leaf),
                 jbvh._emit_python(*boxes, len(p1), leaf)):
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert same_bits(g, w) if g.dtype == np.float64 else \
                np.array_equal(g, w)
    return got


@pytest.mark.parametrize("leaf", [4, 8, 16, 32])
@pytest.mark.parametrize("mesh", ["sphere", "goblet", "sphere-16380"])
def test_bvh_equals_python(mesh, leaf):
    p1 = _mesh(mesh)[0]
    got = assert_bvh_agrees(*_mesh(mesh), leaf)
    assert len(p1) == {"sphere": 352, "goblet": 288,
                       "sphere-16380": 16380}[mesh]
    assert got[3].sum() == -(-len(p1) // leaf)     # snapped: full leaves


def _degenerate(case):
    rng = np.random.default_rng(7)
    tri = np.array([[0., 0, 0], [1, 0, 0], [0, 1, 0]])
    if case == "identical":          # every centroid the same
        p = np.repeat(tri[None], 37, axis=0)
    elif case == "fewer_than_a_leaf":
        p = rng.normal(size=(3, 3, 3))
    elif case == "one_more_than_a_leaf":
        p = rng.normal(size=(5, 3, 3))
    elif case == "coplanar":         # a flat grid: no extent in z
        p = rng.normal(size=(60, 3, 3))
        p[:, :, 2] = 0.25
    elif case == "collinear":        # centroids on one line
        p = np.repeat(tri[None], 40, axis=0)
        p[:, :, 0] += np.arange(40)[:, None] // 3
    elif case == "ties":             # centroid ties on every axis
        p = np.round(rng.normal(size=(80, 3, 3)), 1)
        p[40:] = p[:40]
    else:                            # NaN and infinite vertices
        p = rng.normal(size=(50, 3, 3))
        p[3, 1, 0] = np.nan
        p[7, :, 2] = np.nan
        p[11, 2, 1] = np.inf
        p[19, 0, 0] = -np.inf
        p[23] = np.nan
    return [np.ascontiguousarray(p[:, k]) for k in range(3)]


@pytest.mark.parametrize("leaf", [1, 2, 4])
@pytest.mark.parametrize("case", ["identical", "fewer_than_a_leaf",
                                  "one_more_than_a_leaf", "coplanar",
                                  "collinear", "ties", "nan_inf"])
def test_bvh_degenerate(case, leaf):
    assert_bvh_agrees(*_degenerate(case), leaf)


@pytest.mark.parametrize("n,leaf", [(0, 4), (3, 0)])
def test_bvh_refuses_empty_input(n, leaf):
    p = np.zeros((n, 3))
    with pytest.raises(ValueError, match="leaf size"):
        native.build_bvh(p, p, p, leaf)


def _scene(name):
    if name == "size-check":
        return size_check_scene(CFG, get_scene)
    return get_scene(name, CFG)


def _models_of(scene):
    return [o for o in scene.objects if isinstance(o, shapes.Group)
            and o.n_triangles()]


@pytest.mark.parametrize("name", ["teapot", "gopher", "glass",
                                  "size-check"])
def test_pack_native_equals_python(name, monkeypatch):
    sc = _scene(name)
    assert all(isinstance(g.soup, native.ObjData) and not g.children
               for g in _models_of(sc))
    got, got_meta = sc.pack(device="cpu")
    monkeypatch.setenv("PT_NATIVE", "0")
    py = _scene(name)
    assert all(g.soup is None and g.children for g in _models_of(py))
    want, want_meta = py.pack(device="cpu")
    assert got_meta == want_meta
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("name", ["teapot", "gopher", "glass"])
def test_pack_native_equals_jax_numpy_path(name):
    _, _, ja, jm, ts, _ = jax_twin(name, width=16, height=12, samples=2)
    ta, tm = ts.pack(device="cpu")
    assert all(g.soup is not None for g in _models_of(ts))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for field, want in jax_fields_np(ja).items():
        got = getattr(ta, field).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), field


def test_soup_group_reads_as_the_python_group(monkeypatch):
    nat = _models.load_model("glass.obj", normals_groups=-1)
    monkeypatch.setenv("PT_NATIVE", "0")
    py = _models.load_model("glass.obj", normals_groups=-1)
    assert nat.soup is not None and py.soup is None
    assert nat.n_triangles() == py.n_triangles() == 576
    for a, b in ((nat.bounding_box.min, py.bounding_box.min),
                 (nat.bounding_box.max, py.bounding_box.max)):
        assert same_bits(a, b)
    got, want = nat.all_triangles(), py.all_triangles()
    assert len(shapes.flatten(nat)) == len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("p1", "p2", "p3", "e1", "e2", "n", "n1", "n2", "n3"):
            assert same_bits(getattr(a, f), getattr(b, f)), f
        assert dataclasses.asdict(a.material) == \
            dataclasses.asdict(b.material)


def test_pt_native_0_is_the_only_python_path(monkeypatch):
    assert native.enabled() and native.available()
    for value in ("1", "", "yes"):
        monkeypatch.setenv("PT_NATIVE", value)
        assert native.available()
        assert _models.load_model("teapot.obj").soup is not None
    monkeypatch.setenv("PT_NATIVE", "0")
    assert not native.enabled() and not native.available()
    assert _models.load_model("teapot.obj").soup is None


@pytest.mark.parametrize("how", ["broken source", "failing compiler",
                                 "no compiler"])
def test_core_that_fails_to_build_raises(how, monkeypatch, tmp_path):
    if how == "broken source":
        (tmp_path / "scenecore.cpp").write_text("this is not C++;\n")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        match = "failed for"
    elif how == "failing compiler":
        monkeypatch.setenv("CXX", "false")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        match = "failed for"
    else:
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        match = r"no C\+\+ compiler"
    for call in (native.available, lambda: _models.load_model("teapot.obj"),
                 lambda: get_scene("teapot", CFG).pack(device="cpu")):
        with pytest.raises(RuntimeError, match=match):
            call()
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").glob("*.so"))
    # no fallback but the one that is asked for
    monkeypatch.setenv("PT_NATIVE", "0")
    arrays, meta = get_scene("teapot", CFG).pack(device="cpu")
    assert meta.has_groups
