"""ctypes bindings of the host scene core (csrc/scenecore.cpp): the .obj
parse, the vertex normals and the skip-link BVH build in C++.

Counterpart of pathtracer_tpu.native, with two differences. Its results
equal the Python path's bit for bit (scene/objfile.py parse_obj and
compute_vertex_normals, scene/bvh.py _emit_python), on every input that
path accepts, and it raises where that path raises, with the same
exception type. And it never falls back: PT_NATIVE=0 is the one way to
select the Python path; otherwise the core is built from the checkout's
source at first use (render/_build.py build_host, the host's C++
compiler) and a missing compiler or a failed build raises.

The Python path stays as the plain version the tests hold the core to.
"""
from __future__ import annotations

import ctypes as ct
import dataclasses
import os
import re
import sys
from typing import List, Tuple

import numpy as np

from .render import _build

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I64P = ct.POINTER(ct.c_int64)
_SIGNATURES = {
    "sc_parse_obj": ([ct.c_char_p, ct.c_int64, ct.c_char_p, _i64, ct.c_int64,
                      _i32, _f64, _i64, _i64, ct.c_int64, ct.c_char_p, _i64,
                      _f64, _f64, ct.c_int64, _i64], ct.c_void_p),
    "sc_obj_counts": ([ct.c_void_p] + [_I64P] * 4, None),
    "sc_obj_group_names": ([ct.c_void_p, ct.c_char_p, _i64], None),
    "sc_obj_tris": ([ct.c_void_p] + [_f64] * 9 + [_i32], None),
    "sc_obj_free": ([ct.c_void_p], None),
    "sc_vertex_normals": ([_f64] * 4 + [ct.c_int64] + [_f64] * 3,
                          ct.c_int64),
    "sc_build_bvh": ([_f64, _f64, _f64, ct.c_int64, ct.c_int64, _i64],
                     ct.c_void_p),
    "sc_bvh_counts": ([ct.c_void_p, _I64P, _I64P], None),
    "sc_bvh_nodes": ([ct.c_void_p, _f64, _f64, _i32, _i32, _i32, _i32],
                     None),
    "sc_bvh_free": ([ct.c_void_p], None),
}
# err[0] of a failed call (csrc/scenecore.cpp ErrKind)
_E_VALUE, _E_INDEX, _E_MTLLIB, _E_MEMORY = 1, 2, 3, 5


def enabled() -> bool:
    """Whether mesh set-up takes the scene core: unless PT_NATIVE=0."""
    return os.environ.get("PT_NATIVE") != "0"


def library() -> ct.CDLL:
    """The scene core, built at first use; raises if it cannot be."""
    return _build.load_host("scenecore", _SIGNATURES)


def available() -> bool:
    """False under PT_NATIVE=0; otherwise builds and loads the core and
    returns True, or raises (a missing compiler, a failed build)."""
    if not enabled():
        return False
    library()
    return True


@dataclasses.dataclass
class ObjData:
    """A parsed .obj as a triangle soup: float64 [n, 3] arrays in the order
    of the Python parser's Obj.all_triangles() (by group, the groups in
    the order they first appear, "DefaultGroup" first, each group's
    triangles in file order). n1-n3 are the vertex normals, face_n the
    face normals (Triangle.n), color and refr the material's color and
    refractive index (Material.default() for plain-vertex faces), group_id
    the index into group_names of each triangle's group."""
    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    n3: np.ndarray
    face_n: np.ndarray
    color: np.ndarray
    refr: np.ndarray
    group_id: np.ndarray
    group_names: List[str]
    ignored_lines: int

    @property
    def n_tris(self) -> int:
        return self.p1.shape[0]

    def group_counts(self) -> np.ndarray:
        """Triangles a group, in group_names' order."""
        return np.bincount(self.group_id, minlength=len(self.group_names))

    def group_points(self):
        """Each non-empty group's vertices [3 m, 3], a triangle's p1, p2,
        p3 after another (the order scene/bounds.py bounds_of stacks a
        group's triangles in)."""
        end = np.cumsum(self.group_counts())
        for a, b in zip(np.concatenate([[0], end[:-1]]), end):
            if b > a:
                yield np.stack([self.p1[a:b], self.p2[a:b], self.p3[a:b]],
                               axis=1).reshape(-1, 3)

    def triangles(self):
        """The soup as Triangle objects, each with its material's color and
        refractive index: what the Python parser's triangles hold."""
        from .scene.material import Material
        from .scene.shapes import Triangle
        out = []
        for i in range(self.n_tris):
            t = Triangle(*(np.append(a[i], 1.0) for a in (self.p1, self.p2,
                                                          self.p3)),
                         *(np.append(a[i], 0.0) for a in (self.n1, self.n2,
                                                          self.n3)))
            t.material = Material(
                color=tuple(float(c) for c in self.color[i]),
                refractive_index=float(self.refr[i]))
            out.append(t)
        return out


def _encode(s: str) -> bytes:
    return s.encode("utf-8", "surrogatepass")


def _blob(strings) -> Tuple[bytes, np.ndarray]:
    raw = [_encode(s) for s in strings]
    off = np.zeros(len(raw) + 1, np.int64)
    off[1:] = np.cumsum([len(r) for r in raw]) if raw else []
    return b"".join(raw), off


# a whitespace-separated field with a character that is not ASCII
_NON_ASCII_FIELD = re.compile(r"\S*[^\s\x00-\x7f]\S*")
_INT_CAP = 1 << 62


def _token_table(text: str):
    """Python's float() and int() of every field of `text` that is not
    ASCII, and of each "/" piece of one (Unicode digits, which the core
    does not convert): (blob, offsets, count, flags, floats, ints)."""
    pieces = set()
    if not text.isascii():
        for field in set(_NON_ASCII_FIELD.findall(text)):
            pieces.add(field)
            pieces.update(field.split("/"))
    keys = sorted(p for p in pieces if not p.isascii())
    flags = np.zeros(len(keys), np.int32)
    floats = np.zeros(len(keys), np.float64)
    ints = np.zeros(len(keys), np.int64)
    for k, s in enumerate(keys):
        try:
            floats[k] = float(s)
            flags[k] |= 1
        except ValueError:
            pass
        try:
            ints[k] = max(-_INT_CAP, min(_INT_CAP, int(s)))
            flags[k] |= 2
        except ValueError:
            pass
    return (*_blob(keys), len(keys), flags, floats, ints)


# a line whose first field is "mtllib" (objfile.parse_obj's test)
_MTLLIB_LINE = re.compile(r"^[^\S\n]*mtllib(?!\S)[^\n]*", re.M)


def _mtl_tables(text: str, mtl_dir: str):
    """The .mtl table of each mtllib line of `text`, in order, read as the
    Python parser reads it at that line: (material counts, -1 where the
    read raised; names blob, offsets; colors [m, 3]; refractive indices
    [m]; {line's index: the exception})."""
    from .scene.objfile import parse_mtl
    counts, names, colors, refrs, errors = [], [], [], [], {}
    if "mtllib" in text:
        for j, m in enumerate(_MTLLIB_LINE.finditer(text)):
            # the Python parser raises this when it reaches the line, if
            # nothing before it raised; the core tells when that is
            try:
                with open(os.path.join(mtl_dir, m.group(0).split()[1])) as f:
                    mats = parse_mtl(f.read())
            except Exception as e:
                errors[j] = e
                counts.append(-1)
                continue
            counts.append(len(mats))
            for name, mtl in mats.items():
                mat = mtl.to_material()
                names.append(name)
                colors.append(mat.color)
                refrs.append(mat.refractive_index)
    return (np.asarray(counts, np.int64), *_blob(names),
            np.asarray(colors, np.float64).reshape(-1, 3),
            np.asarray(refrs, np.float64), errors)


def _raise(err: np.ndarray, errors: dict, text: str):
    kind, row, detail = (int(v) for v in err)
    if kind == _E_MTLLIB:
        raise errors[detail]
    if kind == _E_MEMORY:
        raise MemoryError("the scene core ran out of memory")
    line = text.split("\n")[row - 1] if row > 0 else ""
    where = f"line {row} of the .obj ({line[:80]!r})"
    if kind == _E_VALUE:
        raise ValueError(f"{where}: a field is not a number to float() or "
                         "int()")
    if kind == _E_INDEX:
        raise IndexError(f"{where}: a field is missing or an index is out "
                         "of range")
    raise RuntimeError(f"{where}: the scene core's token or .mtl tables do "
                       f"not cover the line (error {kind})")


def parse_obj(text: str, mtl_dir: str = ".",
              normals_groups: int = 0) -> ObjData:
    """objfile.parse_obj(text, mtl_dir) as a triangle soup, then, if
    normals_groups != 0, the vertex normals of the triangles of the first
    `normals_groups` groups (all of them when < 0) as
    scenes/_models.load_model computes them. Raises what the Python
    parser raises."""
    lib = library()
    raw = _encode(text)
    tok = _token_table(text)
    counts, mtl_blob, mtl_off, colors, refrs, errors = _mtl_tables(
        text, mtl_dir)
    err = np.zeros(3, np.int64)
    h = lib.sc_parse_obj(raw, len(raw), *tok, counts, len(counts), mtl_blob,
                         mtl_off, colors, refrs,
                         sys.get_int_max_str_digits(), err)
    if not h:
        _raise(err, errors, text)
    try:
        n_tris, n_groups, names_len, ignored = (ct.c_int64() for _ in
                                                range(4))
        lib.sc_obj_counts(h, ct.byref(n_tris), ct.byref(n_groups),
                          ct.byref(names_len), ct.byref(ignored))
        n = n_tris.value
        vecs = [np.empty((n, 3), np.float64) for _ in range(8)]
        refr = np.empty(n, np.float64)
        gid = np.empty(n, np.int32)
        lib.sc_obj_tris(h, *vecs, refr, gid)
        buf = ct.create_string_buffer(names_len.value + 1)
        off = np.empty(n_groups.value + 1, np.int64)
        lib.sc_obj_group_names(h, buf, off)
        names = [buf.raw[a:b].decode("utf-8", "surrogatepass")
                 for a, b in zip(off[:-1], off[1:])]
    finally:
        lib.sc_obj_free(h)
    soup = ObjData(*vecs, refr, gid, names, ignored.value)
    vertex_normals(soup, normals_groups)
    return soup


def vertex_normals(soup: ObjData, normals_groups: int) -> None:
    """objfile.compute_vertex_normals over the triangles of the soup's
    first `normals_groups` groups (all when < 0; none when 0), in place."""
    if normals_groups == 0:
        return
    counts = soup.group_counts()
    m = int(counts.sum() if normals_groups < 0
            else counts[:normals_groups].sum())
    if m and library().sc_vertex_normals(
            soup.p1[:m], soup.p2[:m], soup.p3[:m], soup.face_n[:m], m,
            soup.n1[:m], soup.n2[:m], soup.n3[:m]):
        raise MemoryError("the scene core ran out of memory")


def build_bvh(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
              leaf_size: int):
    """bvh._emit_python over the triangles (p1, p2, p3 [n, 3]): (bb_min
    [Nn, 3], bb_max [Nn, 3], tri_start [Nn], is_leaf [Nn], exit [Nn],
    slots [Ns]), local indices, slots the triangle ids, -1 padding."""
    from .scene.bvh import triangle_boxes
    n = len(p1)
    if n < 1 or leaf_size < 1:
        raise ValueError(f"a BVH needs a triangle and a leaf size >= 1 "
                         f"({n} triangles, leaf {leaf_size})")
    boxes = [np.ascontiguousarray(a, np.float64)
             for a in triangle_boxes(p1, p2, p3)]
    if any(a.shape != (n, 3) for a in boxes):
        raise ValueError(f"triangle arrays must be [n, 3], got "
                         f"{[a.shape for a in boxes]}")
    lib = library()
    err = np.zeros(3, np.int64)
    h = lib.sc_build_bvh(*boxes, n, leaf_size, err)
    if not h:
        raise MemoryError("the scene core ran out of memory")
    try:
        nn, ns = ct.c_int64(), ct.c_int64()
        lib.sc_bvh_counts(h, ct.byref(nn), ct.byref(ns))
        out = (np.empty((nn.value, 3), np.float64),
               np.empty((nn.value, 3), np.float64),
               *(np.empty(nn.value, np.int32) for _ in range(3)),
               np.empty(ns.value, np.int32))
        lib.sc_bvh_nodes(h, *out)
    finally:
        lib.sc_bvh_free(h)
    return out
