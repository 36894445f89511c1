// scenecore: the host scene core of pathtracer_tpu_torch: the .obj parse,
// the vertex-normal pass and the snapped-SAH skip-link BVH build.
//
// Each function gives, bit for bit, what the package's Python path gives
// on the same input:
//   sc_parse_obj       scene/objfile.py parse_obj (the triangles in
//                      Obj.all_triangles() order, ignored_lines, and the
//                      exception type where that parser raises)
//   sc_vertex_normals  scene/objfile.py compute_vertex_normals
//   sc_build_bvh       scene/bvh.py _emit_python (_build_tree's splits)
// So every floating-point expression below is the Python one term by term:
// a 4-vector's squared magnitude is ((x*x + y*y) + z*z) + w*w, NumPy's sum
// order, with w = 0; a node's area is (d0*d1 + d1*d2) + d2*d0. It must be
// compiled without contracting a multiply and an add into one fused
// operation (-ffp-contract=off, no -ffast-math): render/_build.py
// HOST_FLAGS. Minima and maxima propagate NaN as NumPy's do, and the sorts
// are stable with NaN last, as np.argsort(kind="stable") sorts.
//
// Built at first use by render/_build.py build_host and bound with ctypes
// (native.py). No exception crosses the C interface: each entry point
// catches and reports through its `err` argument, and native.py raises.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <locale.h>
#include <memory>
#include <new>
#include <stdlib.h>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// err[0] of a failed call: the exception native.py raises
enum ErrKind : int64_t {
  kOk = 0,
  kValueError = 1,      // float() or int() refused a field
  kIndexError = 2,      // a missing field or an index out of range
  kMtllibError = 3,     // the mtllib line whose table failed (err[2])
  kMissingEntry = 4,    // a non-ASCII field or an mtllib line that the
                        // caller's tables do not cover
  kNoMemory = 5,
};

struct Fail {
  int64_t kind, detail;
};

[[noreturn]] static void fail(int64_t kind, int64_t detail = 0) {
  throw Fail{kind, detail};
}

// ---- Python's str.split() whitespace, in UTF-8 --------------------------

// The length of the whitespace character at p (0 if there is none): the
// code points for which str.isspace() is true, which str.strip() and
// str.split() remove.
static int ws_len(const unsigned char *p, const unsigned char *e) {
  unsigned c = p[0];
  if ((c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x20)) return 1;
  if (e - p >= 2 && c == 0xc2 && (p[1] == 0x85 || p[1] == 0xa0)) return 2;
  if (e - p >= 3) {
    if (c == 0xe1 && p[1] == 0x9a && p[2] == 0x80) return 3;     // U+1680
    if (c == 0xe2 && p[1] == 0x80 &&
        ((p[2] >= 0x80 && p[2] <= 0x8a) || p[2] == 0xa8 || p[2] == 0xa9 ||
         p[2] == 0xaf))
      return 3;                             // U+2000-200A, 2028, 2029, 202F
    if (c == 0xe2 && p[1] == 0x81 && p[2] == 0x9f) return 3;     // U+205F
    if (c == 0xe3 && p[1] == 0x80 && p[2] == 0x80) return 3;     // U+3000
  }
  return 0;
}

using Tok = std::pair<const char *, const char *>;

static void split_ws(const char *b, const char *e, std::vector<Tok> &out) {
  out.clear();
  auto *p = reinterpret_cast<const unsigned char *>(b);
  auto *end = reinterpret_cast<const unsigned char *>(e);
  while (p < end) {
    int w = ws_len(p, end);
    if (w) {
      p += w;
      continue;
    }
    auto *s = p;
    while (p < end && !ws_len(p, end)) ++p;
    out.emplace_back(reinterpret_cast<const char *>(s),
                     reinterpret_cast<const char *>(p));
  }
}

static bool is(const Tok &t, const char *word) {
  size_t n = std::strlen(word);
  return static_cast<size_t>(t.second - t.first) == n &&
         std::memcmp(t.first, word, n) == 0;
}

static bool ascii(const char *b, const char *e) {
  for (; b < e; ++b)
    if (static_cast<unsigned char>(*b) >= 0x80) return false;
  return true;
}

// ---- float() and int() of an ASCII field ---------------------------------

static bool digit(char c) { return c >= '0' && c <= '9'; }

// digitpart ::= digit (["_"] digit)*, its digits appended to `out`;
// returns the end of the part, or nullptr if there is none at p
static const char *digitpart(const char *p, const char *e, std::string &out) {
  if (p >= e || !digit(*p)) return nullptr;
  out.push_back(*p++);
  while (p < e) {
    if (digit(*p)) {
      out.push_back(*p++);
    } else if (*p == '_' && p + 1 < e && digit(p[1])) {
      out.push_back(p[1]);
      p += 2;
    } else {
      break;
    }
  }
  return p;
}

static bool lower_is(const char *b, const char *e, const char *word) {
  size_t n = std::strlen(word);
  if (static_cast<size_t>(e - b) != n) return false;
  for (size_t i = 0; i < n; ++i)
    if ((b[i] | 0x20) != word[i]) return false;
  return true;
}

static locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", static_cast<locale_t>(0));
  return loc;
}

// Python's float() of an ASCII string without whitespace: [sign] then
// "inf", "infinity" or "nan" in any case, or a decimal number whose digit
// runs may hold single underscores between digits. The value is glibc's
// correctly rounded strtod of the digits, as CPython's is.
static bool py_float(const char *b, const char *e, double &v) {
  const char *p = b;
  bool neg = false;
  if (p < e && (*p == '+' || *p == '-')) neg = *p++ == '-';
  if (lower_is(p, e, "inf") || lower_is(p, e, "infinity")) {
    v = neg ? -HUGE_VAL : HUGE_VAL;
    return true;
  }
  if (lower_is(p, e, "nan")) {
    v = std::copysign(std::numeric_limits<double>::quiet_NaN(),
                      neg ? -1.0 : 1.0);
    return true;
  }
  std::string s(neg ? "-" : "");
  if (p < e && digit(*p)) {
    p = digitpart(p, e, s);
    if (p < e && *p == '.') {
      s.push_back('.');
      ++p;
      if (p < e && digit(*p)) p = digitpart(p, e, s);
    }
  } else if (p < e && *p == '.') {
    s.push_back('.');
    p = digitpart(p + 1, e, s);
    if (!p) return false;
  } else {
    return false;
  }
  if (p < e && (*p == 'e' || *p == 'E')) {
    s.push_back('e');
    ++p;
    if (p < e && (*p == '+' || *p == '-')) s.push_back(*p++);
    p = digitpart(p, e, s);
    if (!p) return false;
  }
  if (p != e) return false;
  v = strtod_l(s.c_str(), nullptr, c_locale());
  return true;
}

// Python's int() of an ASCII string without whitespace, base 10: [sign]
// digitpart. The value saturates at +-2^62 (any index that far is out of
// range); more digits than sys.get_int_max_str_digits() (max_digits > 0)
// is a ValueError, as CPython's limit makes it.
static bool py_int(const char *b, const char *e, int64_t max_digits,
                   int64_t &v) {
  const char *p = b;
  bool neg = false;
  if (p < e && (*p == '+' || *p == '-')) neg = *p++ == '-';
  std::string s;
  p = digitpart(p, e, s);
  if (!p || p != e) return false;
  if (max_digits > 0 && static_cast<int64_t>(s.size()) > max_digits)
    return false;
  const int64_t cap = int64_t(1) << 62;
  int64_t x = 0;
  for (char c : s) x = x >= cap / 10 ? cap : x * 10 + (c - '0');
  v = neg ? -x : x;
  return true;
}

// ---- the parse -----------------------------------------------------------

struct V3 {
  double x = 0, y = 0, z = 0;
};

struct Tri {
  V3 p[3];          // positions
  V3 n[3];          // vertex normals
  V3 fn;            // face normal, Triangle.n
  V3 color{1, 1, 1};
  double refr = 1.0;
  int32_t group = 0;
};

struct Obj {
  std::vector<Tri> tris;
  std::vector<std::string> group_names;
  int64_t ignored_lines = 0;
};

// The squared magnitude of a 4-vector with w = 0 in NumPy's sum order
// (geometry/tuple4.py magnitude: np.sum(a * a)), then its square root.
static double magnitude(const V3 &a) {
  return std::sqrt(((a.x * a.x + a.y * a.y) + a.z * a.z) + 0.0 * 0.0);
}

// Triangle.__init__'s face normal: cross(e2, e1) divided by its
// magnitude where that is > 0 (a degenerate or NaN triangle keeps it).
static V3 face_normal(const V3 &p1, const V3 &p2, const V3 &p3) {
  V3 a{p3.x - p1.x, p3.y - p1.y, p3.z - p1.z};    // e2
  V3 b{p2.x - p1.x, p2.y - p1.y, p2.z - p1.z};    // e1
  V3 c{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
  double m = magnitude(c);
  if (m > 0.0) return {c.x / m, c.y / m, c.z / m};
  return c;
}

struct Tables {
  // fields that are not ASCII, converted by Python's float() and int()
  std::unordered_map<std::string, int64_t> token_index;
  const int32_t *tok_ok;    // bit 0: float() accepted it, bit 1: int()
  const double *tok_float;
  const int64_t *tok_int;
  // the .mtl table of each mtllib line: its first material, its count
  // (-1: reading it raised)
  std::vector<int64_t> first, count;
  std::vector<std::string> mtl_names;
  const double *mtl_color, *mtl_refr;
  int64_t max_digits;
};

struct Parser {
  const Tables &tab;
  Obj &obj;
  std::vector<V3> verts{V3{}}, normals{V3{}};   // slot 0: the placeholders
  std::unordered_map<std::string, int32_t> group_ids{{"DefaultGroup", 0}};
  int32_t group = 0;
  int64_t table = -1;          // the current mtllib line's table
  V3 color{1, 1, 1};           // current_material (Material.default())
  double refr = 1.0;

  const int64_t *token(const char *b, const char *e) {
    auto it = tab.token_index.find(std::string(b, e));
    if (it == tab.token_index.end()) fail(kMissingEntry);
    return &it->second;
  }

  double to_float(const Tok &t) {
    double v;
    if (ascii(t.first, t.second)) {
      if (!py_float(t.first, t.second, v)) fail(kValueError);
      return v;
    }
    int64_t i = *token(t.first, t.second);
    if (!(tab.tok_ok[i] & 1)) fail(kValueError);
    return tab.tok_float[i];
  }

  int64_t to_int(const char *b, const char *e) {
    int64_t v;
    if (ascii(b, e)) {
      if (!py_int(b, e, tab.max_digits, v)) fail(kValueError);
      return v;
    }
    int64_t i = *token(b, e);
    if (!(tab.tok_ok[i] & 2)) fail(kValueError);
    return tab.tok_int[i];
  }
  int64_t to_int(const Tok &t) { return to_int(t.first, t.second); }

  // list[i] of Python: i in [-size, size), negative from the end
  static const V3 &at(const std::vector<V3> &list, int64_t i) {
    int64_t n = static_cast<int64_t>(list.size());
    if (i < 0) i += n;
    if (i < 0 || i >= n) fail(kIndexError);
    return list[static_cast<size_t>(i)];
  }

  V3 vec3(const std::vector<Tok> &f) {
    V3 v;
    double *c[3] = {&v.x, &v.y, &v.z};
    for (size_t k = 1; k <= 3; ++k) {
      if (k >= f.size()) fail(kIndexError);
      *c[k - 1] = to_float(f[k]);
    }
    return v;
  }

  void add(const V3 &p1, const V3 &p2, const V3 &p3, const V3 *n,
           bool material) {
    Tri t;
    t.p[0] = p1;
    t.p[1] = p2;
    t.p[2] = p3;
    t.fn = face_normal(p1, p2, p3);
    for (int k = 0; k < 3; ++k) t.n[k] = n ? n[k] : t.fn;
    if (material) {
      t.color = color;
      t.refr = refr;
    }
    t.group = group;
    obj.tris.push_back(t);
  }

  static std::vector<Tok> split_slash(const Tok &t) {
    std::vector<Tok> out;
    const char *s = t.first;
    for (const char *p = t.first; p < t.second; ++p)
      if (*p == '/') {
        out.emplace_back(s, p);
        s = p + 1;
      }
    out.emplace_back(s, t.second);
    return out;
  }

  void face(const std::vector<Tok> &f, bool slash) {
    for (size_t i = 2; i + 1 < f.size(); ++i) {
      if (!slash) {
        int64_t i1 = to_int(f[1]), i2 = to_int(f[i]), i3 = to_int(f[i + 1]);
        const V3 &p1 = at(verts, i1), &p2 = at(verts, i2),
                 &p3 = at(verts, i3);
        // plain-vertex faces keep the default material
        add(p1, p2, p3, nullptr, false);
        continue;
      }
      std::vector<Tok> sp[3] = {split_slash(f[1]), split_slash(f[i]),
                                split_slash(f[i + 1])};
      int64_t vi[3], ni[3] = {0, 0, 0};
      for (int k = 0; k < 3; ++k) vi[k] = to_int(sp[k][0]);
      if (sp[0].size() == 3 && sp[0][2].first != sp[0][2].second) {
        for (int k = 0; k < 3; ++k) {
          if (sp[k].size() < 3) fail(kIndexError);
          ni[k] = to_int(sp[k][2]);
        }
      }
      const V3 &p1 = at(verts, vi[0]), &p2 = at(verts, vi[1]),
               &p3 = at(verts, vi[2]);
      V3 n[3];
      for (int k = 0; k < 3; ++k) n[k] = at(normals, ni[k]);
      add(p1, p2, p3, n, true);
    }
  }

  void line(const char *b, const char *e, std::vector<Tok> &f) {
    split_ws(b, e, f);
    if (f.empty()) {
      obj.ignored_lines++;
      return;
    }
    const Tok &tag = f[0];
    if (is(tag, "mtllib")) {
      if (++table >= static_cast<int64_t>(tab.count.size()))
        fail(kMissingEntry);
      if (tab.count[static_cast<size_t>(table)] < 0)
        fail(kMtllibError, table);
    } else if (is(tag, "usemtl")) {
      if (f.size() < 2) fail(kIndexError);
      if (table < 0) return;
      std::string name(f[1].first, f[1].second);
      size_t t = static_cast<size_t>(table);
      for (int64_t m = tab.first[t]; m < tab.first[t] + tab.count[t]; ++m)
        if (tab.mtl_names[static_cast<size_t>(m)] == name) {
          color = {tab.mtl_color[3 * m], tab.mtl_color[3 * m + 1],
                   tab.mtl_color[3 * m + 2]};
          refr = tab.mtl_refr[m];
          break;
        }
    } else if (is(tag, "v")) {
      verts.push_back(vec3(f));
    } else if (is(tag, "vn")) {
      normals.push_back(vec3(f));
    } else if (is(tag, "f")) {
      face(f, std::memchr(b, '/', static_cast<size_t>(e - b)) != nullptr);
    } else if (is(tag, "g") || is(tag, "o")) {
      if (f.size() < 2) fail(kIndexError);
      std::string name(f[1].first, f[1].second);
      auto it = group_ids.find(name);
      if (it == group_ids.end()) {
        group = static_cast<int32_t>(obj.group_names.size());
        group_ids.emplace(name, group);
        obj.group_names.push_back(name);
      } else {
        group = it->second;
      }
    } else {
      obj.ignored_lines++;
    }
  }
};

// ---- vertex normals --------------------------------------------------------

// The position key of compute_vertex_normals: the bits of (x, y, z)
struct PosKey {
  uint64_t a, b, c;
  bool operator==(const PosKey &o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};
struct PosKeyHash {
  size_t operator()(const PosKey &k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t v : {k.a, k.b, k.c}) {
      h ^= v;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};
static PosKey key_of(const double *p) {
  PosKey k;
  std::memcpy(&k.a, p, 8);
  std::memcpy(&k.b, p + 1, 8);
  std::memcpy(&k.c, p + 2, 8);
  return k;
}

// ---- the BVH -----------------------------------------------------------

// np.minimum(a, b) / np.maximum(a, b) as NumPy 2 computes them: NaN if
// either is NaN, and b where a == b (so a reduction keeps the later of
// 0.0 and -0.0, which only the node boxes' zero signs can show)
static double nmin(double a, double b) { return (a < b || a != a) ? a : b; }
static double nmax(double a, double b) { return (a > b || a != a) ? a : b; }

struct BVH {
  std::vector<double> bb_min, bb_max;   // [Nn * 3]
  std::vector<int32_t> start, leaf, exit;
  std::vector<int32_t> slots;           // triangle ids, -1 for padding
};

struct Builder {
  const double *bmin, *bmax, *cent;     // per triangle [n * 3]
  int64_t leaf_size;
  BVH &out;

  // _build_tree's split of `ids` (more than leaf_size of them): the ids
  // in the chosen order and the cut
  size_t split(std::vector<int32_t> &ids) const {
    const size_t n = ids.size();
    double cmin[3], cmax[3];
    for (int a = 0; a < 3; ++a) {
      cmin[a] = cmax[a] = cent[3 * static_cast<size_t>(ids[0]) + a];
      for (size_t i = 1; i < n; ++i) {
        double v = cent[3 * static_cast<size_t>(ids[i]) + a];
        cmin[a] = nmin(cmin[a], v);
        cmax[a] = nmax(cmax[a], v);
      }
    }
    const size_t leaf = static_cast<size_t>(leaf_size);
    double best_cost = std::numeric_limits<double>::infinity();
    std::vector<int32_t> best;
    size_t best_cut = 0;
    std::vector<int32_t> order;
    std::vector<double> lmn(3 * n), lmx(3 * n), rmn(3 * n), rmx(3 * n);
    for (int axis = 0; axis < 3; ++axis) {
      if (cmax[axis] - cmin[axis] <= 0.0) continue;
      order = ids;
      // np.argsort(kind="stable"): NaN after every number
      std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        double x = cent[3 * static_cast<size_t>(a) + axis];
        double y = cent[3 * static_cast<size_t>(b) + axis];
        return x < y || (y != y && x == x);
      });
      for (size_t i = 0; i < n; ++i) {
        size_t t = 3 * static_cast<size_t>(order[i]);
        for (int a = 0; a < 3; ++a) {
          lmn[3 * i + a] = i ? nmin(lmn[3 * (i - 1) + a], bmin[t + a])
                             : bmin[t + a];
          lmx[3 * i + a] = i ? nmax(lmx[3 * (i - 1) + a], bmax[t + a])
                             : bmax[t + a];
        }
      }
      for (size_t i = n; i-- > 0;) {
        size_t t = 3 * static_cast<size_t>(order[i]);
        for (int a = 0; a < 3; ++a) {
          rmn[3 * i + a] = i + 1 < n ? nmin(rmn[3 * (i + 1) + a], bmin[t + a])
                                     : bmin[t + a];
          rmx[3 * i + a] = i + 1 < n ? nmax(rmx[3 * (i + 1) + a], bmax[t + a])
                                     : bmax[t + a];
        }
      }
      auto area = [](const double *mn, const double *mx) {
        double d0 = mx[0] - mn[0], d1 = mx[1] - mn[1], d2 = mx[2] - mn[2];
        return d0 * d1 + d1 * d2 + d2 * d0;
      };
      // np.argmin over the cuts: the first NaN, else the first minimum
      double k_cost = 0.0;
      size_t k_cut = 0;
      for (size_t cut = leaf; cut < n; cut += leaf) {
        double cost =
            area(&lmn[3 * (cut - 1)], &lmx[3 * (cut - 1)]) *
                static_cast<double>(cut) +
            area(&rmn[3 * cut], &rmx[3 * cut]) * static_cast<double>(n - cut);
        if (cost != cost) {
          k_cost = cost;
          k_cut = cut;
          break;
        }
        if (k_cut == 0 || cost < k_cost) {
          k_cost = cost;
          k_cut = cut;
        }
      }
      if (k_cost < best_cost) {
        best_cost = k_cost;
        best.swap(order);
        best_cut = k_cut;
      }
    }
    if (best.empty()) {
      // all centroids identical: snapped even split, original order
      size_t n_leaves = (n + leaf - 1) / leaf;
      return std::min(leaf * (n_leaves / 2), n - 1);
    }
    ids.swap(best);
    return best_cut;
  }

  // _emit_python's depth-first emit of _build_tree, with a stack of its
  // own: a frame either builds the node of `ids` or, once the node's
  // subtree is out, sets its skip link (finish >= 0)
  void build(std::vector<int32_t> root) {
    struct Frame {
      std::vector<int32_t> ids;
      int64_t finish;
    };
    std::vector<Frame> stack;
    stack.push_back({std::move(root), -1});
    while (!stack.empty()) {
      Frame fr = std::move(stack.back());
      stack.pop_back();
      if (fr.finish >= 0) {
        out.exit[static_cast<size_t>(fr.finish)] =
            static_cast<int32_t>(out.leaf.size());
        continue;
      }
      std::vector<int32_t> &ids = fr.ids;
      const size_t my = out.leaf.size();
      for (int a = 0; a < 3; ++a) {
        double mn = bmin[3 * static_cast<size_t>(ids[0]) + a];
        double mx = bmax[3 * static_cast<size_t>(ids[0]) + a];
        for (size_t i = 1; i < ids.size(); ++i) {
          mn = nmin(mn, bmin[3 * static_cast<size_t>(ids[i]) + a]);
          mx = nmax(mx, bmax[3 * static_cast<size_t>(ids[i]) + a]);
        }
        out.bb_min.push_back(mn);
        out.bb_max.push_back(mx);
      }
      out.exit.push_back(0);
      if (static_cast<int64_t>(ids.size()) <= leaf_size) {
        out.leaf.push_back(1);
        out.start.push_back(static_cast<int32_t>(out.slots.size()));
        out.slots.insert(out.slots.end(), ids.begin(), ids.end());
        out.slots.insert(out.slots.end(),
                         static_cast<size_t>(leaf_size) - ids.size(), -1);
        out.exit[my] = static_cast<int32_t>(out.leaf.size());
        continue;
      }
      out.leaf.push_back(0);
      out.start.push_back(0);
      size_t cut = split(ids);
      std::vector<int32_t> left(ids.begin(),
                                ids.begin() + static_cast<long>(cut));
      std::vector<int32_t> right(ids.begin() + static_cast<long>(cut),
                                 ids.end());
      stack.push_back({{}, static_cast<int64_t>(my)});
      stack.push_back({std::move(right), -1});
      stack.push_back({std::move(left), -1});
    }
  }
};

template <class F>
static void *guarded(int64_t *err, F &&f) {
  err[0] = kOk;
  try {
    return f();
  } catch (const Fail &e) {
    err[0] = e.kind;
    err[2] = e.detail;
  } catch (const std::bad_alloc &) {
    err[0] = kNoMemory;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Parse .obj `text` (`len` bytes of UTF-8). The token table holds every
// whitespace-separated field (and each "/" piece of one) that is not
// ASCII, with what Python's float() and int() make of it; `tables` the
// material count of each mtllib line's .mtl (-1: reading it raised), their
// names, Mtl.to_material() colors and refractive indices in order.
// Returns a handle, or NULL with err = (kind, line, detail).
void *sc_parse_obj(const char *text, int64_t len, const char *tok_blob,
                   const int64_t *tok_off, int64_t n_tok,
                   const int32_t *tok_ok, const double *tok_float,
                   const int64_t *tok_int, const int64_t *tables,
                   int64_t n_tables, const char *mtl_blob,
                   const int64_t *mtl_off, const double *mtl_color,
                   const double *mtl_refr, int64_t max_digits, int64_t *err) {
  err[1] = 0;
  return guarded(err, [&]() -> void * {
    Tables tab;
    for (int64_t i = 0; i < n_tok; ++i)
      tab.token_index.emplace(
          std::string(tok_blob + tok_off[i], tok_blob + tok_off[i + 1]), i);
    tab.tok_ok = tok_ok;
    tab.tok_float = tok_float;
    tab.tok_int = tok_int;
    int64_t m = 0;
    for (int64_t t = 0; t < n_tables; ++t) {
      tab.first.push_back(m);
      tab.count.push_back(tables[t]);
      for (int64_t k = 0; k < tables[t]; ++k, ++m)
        tab.mtl_names.emplace_back(mtl_blob + mtl_off[m],
                                   mtl_blob + mtl_off[m + 1]);
    }
    tab.mtl_color = mtl_color;
    tab.mtl_refr = mtl_refr;
    tab.max_digits = max_digits;

    auto obj = std::make_unique<Obj>();
    obj->group_names.push_back("DefaultGroup");
    Parser ps{tab, *obj};
    std::vector<Tok> fields;
    // data.split("\n"): a row per newline and one after the last
    const char *p = text, *end = text + len;
    for (int64_t row = 1;; ++row) {
      const char *nl = static_cast<const char *>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      const char *e = nl ? nl : end;
      err[1] = row;
      ps.line(p, e, fields);
      if (!nl) break;
      p = nl + 1;
    }
    // Obj.all_triangles() order: by group, first-seen group first, each
    // group's triangles in file order
    std::vector<size_t> at(obj->group_names.size() + 1, 0);
    for (const Tri &t : obj->tris) at[static_cast<size_t>(t.group) + 1]++;
    for (size_t g = 1; g < at.size(); ++g) at[g] += at[g - 1];
    std::vector<Tri> sorted(obj->tris.size());
    for (const Tri &t : obj->tris) sorted[at[static_cast<size_t>(t.group)]++] = t;
    obj->tris.swap(sorted);
    return obj.release();
  });
}

void sc_obj_counts(void *h, int64_t *n_tris, int64_t *n_groups,
                   int64_t *names_len, int64_t *ignored) {
  auto *o = static_cast<Obj *>(h);
  *n_tris = static_cast<int64_t>(o->tris.size());
  *n_groups = static_cast<int64_t>(o->group_names.size());
  int64_t len = 0;
  for (const auto &n : o->group_names) len += static_cast<int64_t>(n.size());
  *names_len = len;
  *ignored = o->ignored_lines;
}

// the group names concatenated into buf, their offsets [n_groups + 1]
void sc_obj_group_names(void *h, char *buf, int64_t *off) {
  auto *o = static_cast<Obj *>(h);
  int64_t at = 0;
  off[0] = 0;
  for (size_t g = 0; g < o->group_names.size(); ++g) {
    const std::string &n = o->group_names[g];
    std::memcpy(buf + at, n.data(), n.size());
    at += static_cast<int64_t>(n.size());
    off[g + 1] = at;
  }
}

void sc_obj_tris(void *h, double *p1, double *p2, double *p3, double *n1,
                 double *n2, double *n3, double *face_n, double *color,
                 double *refr, int32_t *group_id) {
  auto *o = static_cast<Obj *>(h);
  double *ds[8] = {p1, p2, p3, n1, n2, n3, face_n, color};
  for (size_t i = 0; i < o->tris.size(); ++i) {
    const Tri &t = o->tris[i];
    const V3 *vs[8] = {&t.p[0], &t.p[1], &t.p[2], &t.n[0],
                       &t.n[1], &t.n[2], &t.fn,   &t.color};
    for (int k = 0; k < 8; ++k) {
      ds[k][3 * i] = vs[k]->x;
      ds[k][3 * i + 1] = vs[k]->y;
      ds[k][3 * i + 2] = vs[k]->z;
    }
    refr[i] = t.refr;
    group_id[i] = t.group;
  }
}

void sc_obj_free(void *h) { delete static_cast<Obj *>(h); }

// compute_vertex_normals over n triangles ([n, 3] arrays): each vertex
// normal is the sum of the face normals of the triangles that share its
// position (in triangle order, corners p1, p2, p3), divided by its
// magnitude. Returns 0, or kNoMemory.
int64_t sc_vertex_normals(const double *p1, const double *p2,
                          const double *p3, const double *face_n, int64_t n,
                          double *n1, double *n2, double *n3) {
  try {
    std::unordered_map<PosKey, V3, PosKeyHash> acc;
    acc.reserve(static_cast<size_t>(n) * 2);
    const double *ps[3] = {p1, p2, p3};
    double *ns[3] = {n1, n2, n3};
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) {
        V3 &a = acc[key_of(ps[k] + 3 * i)];
        a.x += face_n[3 * i];
        a.y += face_n[3 * i + 1];
        a.z += face_n[3 * i + 2];
      }
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) {
        const V3 &a = acc[key_of(ps[k] + 3 * i)];
        double m = magnitude(a);
        ns[k][3 * i] = a.x / m;
        ns[k][3 * i + 1] = a.y / m;
        ns[k][3 * i + 2] = a.z / m;
      }
  } catch (const std::bad_alloc &) {
    return kNoMemory;
  }
  return kOk;
}

// _emit_python over n triangles: tri_min, tri_max, centroid [n, 3] each,
// as bvh.build_bvh_arrays computes them. Returns a handle, or NULL with
// err[0] = kNoMemory.
void *sc_build_bvh(const double *tri_min, const double *tri_max,
                   const double *centroid, int64_t n, int64_t leaf_size,
                   int64_t *err) {
  return guarded(err, [&]() -> void * {
    auto bvh = std::make_unique<BVH>();
    Builder b{tri_min, tri_max, centroid, leaf_size, *bvh};
    std::vector<int32_t> ids(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) ids[static_cast<size_t>(i)] =
        static_cast<int32_t>(i);
    b.build(std::move(ids));
    return bvh.release();
  });
}

void sc_bvh_counts(void *h, int64_t *n_nodes, int64_t *n_slots) {
  auto *b = static_cast<BVH *>(h);
  *n_nodes = static_cast<int64_t>(b->leaf.size());
  *n_slots = static_cast<int64_t>(b->slots.size());
}

void sc_bvh_nodes(void *h, double *bb_min, double *bb_max, int32_t *start,
                  int32_t *is_leaf, int32_t *exit_idx, int32_t *slots) {
  auto *b = static_cast<BVH *>(h);
  std::memcpy(bb_min, b->bb_min.data(), b->bb_min.size() * 8);
  std::memcpy(bb_max, b->bb_max.data(), b->bb_max.size() * 8);
  std::memcpy(start, b->start.data(), b->start.size() * 4);
  std::memcpy(is_leaf, b->leaf.data(), b->leaf.size() * 4);
  std::memcpy(exit_idx, b->exit.data(), b->exit.size() * 4);
  std::memcpy(slots, b->slots.data(), b->slots.size() * 4);
}

void sc_bvh_free(void *h) { delete static_cast<BVH *>(h); }

}  // extern "C"
