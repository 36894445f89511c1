// Forward path-tracing megakernel for scenes of primitives, triangle meshes
// and textures, for Hopper (sm_90a).
//
// Replaces pathtracer_tpu/render/pallas_kernel.py::_make_kernel, launched by
// trace_tiles: per tile slot,
// `spp / spp_pack` samples of a jittered camera ray (sunflower depth of field
// when the aperture is set), each bounced up to `max_bounces` times through
// the plane/sphere/cylinder/box tests and the BVH walk of triangle groups
// (K1-mesh: _packet_traverse :1334, _leaf_tests :1256, _group_octant_base
// :1231), the material roulette (reflect, thin shell, Schlick refraction,
// diffuse), the cosine hemisphere and the forward-folded resolve. Output: the
// f32 RGB radiance sum per slot.
//
// Design. One thread owns one tile slot (one path at a time): the thread
// derives (tile = row / S, r0 = row % S, r1 = lane) from its global index,
// so the JAX package's (S, L) tile survives only as a numbering of the
// random stream, of the sample replicas (spp_pack copies of a pixel block
// along the rows or the 128-lane chunks of a tile) and of the coherent draws
// they share. The object table (<= 64 rows of 45 floats) and the camera
// vector are staged in shared memory once per block, each object row at a
// 48-float stride, so that the object loop reads each row of an inverse
// transform as one 16-byte load (12 scalar loads a sphere became 3; K1 6%
// faster on an H100, PERF.md §6: R4), and the type codes and
// group node ranges ride in the launch parameters; the TPU kernel's static
// unroll over objects becomes a loop with a switch on the type. Its per-tile
// early exit becomes a per-ray break, which is equivalent because dead rays
// are inert. Random numbers come from the stateless murmur3 counter hash of
// pallas_kernel._prng_seed/_uniform, keyed on (seed, tile, draw id, sample,
// bounce, slot), so the kernel traces the same paths as the interpret-mode
// JAX kernel and the plain PyTorch version. Compiled with -fmad=false and
// IEEE sqrt/division so each operation rounds as theirs do.
//
// The BVH walk. The TPU kernel walks the skip-link BVH with one scalar node
// pointer for a whole (8, 512) packet, because its vector unit has no
// per-lane control flow. Here each thread walks alone: on the node copy of
// its own object-space direction octant, a slab hit steps to idx + 1 and a
// miss to the node's exit; a hit leaf tests its leaf_size slots one after
// the other with a strict `<` (the JAX min-tree's winner: the lowest slot on
// ties). A child box lies inside its parent's, so a ray visits every leaf
// the packet walk lets it test; only the order differs, which matters only
// on exact-t ties. The tables stay in global memory and are read through
// the read-only cache in 16-byte records: a node is two float4 [9 Nn, 8]
// (its leaf flag the sign of its first slot), a triangle's test record
// three float4 (p1, Ng, U, V) [Ns, 12], and its shading record (normals,
// color) three more in an array of its own [Ns, 12], read for the winner
// alone. The TPU layout's 96-byte slot and 64-byte node put shading data
// and padding into every cache line the walk pulled in. Even a
// 16640-triangle mesh's tables (~2 MB) sit in the 50 MB L2.
// The walk is compiled only into the kMesh instantiation, so primitive
// scenes run the code (and registers) they ran before.
//
// What bounds it: arithmetic and divergence, not bytes. Each slot reads two
// ints and writes three floats; the rest lives in registers, shared memory
// and the L2-resident mesh tables. Paths end at different bounces and walks
// visit different nodes, so warps diverge. The kernel allocates nothing and
// does not synchronise; it runs on the stream it is given.
//
// Textures (K1-tex). Replaces the texture block of _make_kernel
// (pallas_kernel.py:1933-1942, :2230-2302), which computes procedural
// texels in the kernel (_sample_proc :968) and fetches small file images by
// one-hot matmuls from a staged atlas (_sample_staged :999,
// _sample_staged_unified :1130), because a TPU lane cannot gather. Here
// every texture is one bilinear fetch from the full-resolution rgb8 texel
// pool (sample_pool): four point loads through the read-only cache, whose
// REPEAT wrap takes no division (wrap_fast; the JAX formula, one IEEE
// division a wrap, stays in a cold branch where the two could differ),
// decoded as q * f32(1/255) where the blend uses them and blended in f32
// in the JAX order (x first), so the result is the plain version's bit for
// bit. (Quad rows, each texel with its three REPEAT neighbours, make a
// fetch one 16-byte load for 4x the pool's memory; on the card they did
// not clear the margin that would pay for that, PERF.md §6.) No texture
// object: hardware filtering blends with 9-bit fixed-point weights. The
// per-object texture table ([n_obj, 12]: color flag, base, w, h, sx, sy,
// normal-map flag, base, w, h, sxn, syn) is staged in shared memory beside
// the object table, with the reciprocals of the sides. A
// plane's normal map replaces the object-space normal before the
// inverse-transpose; a textured plane, sphere or box takes the texel as
// its color, by the UV map of its type (the JAX kernel's polynomial
// atan2/acos and truncating fmod, pallas_kernel.py:881-965); both go
// through one helper, fetch_texture. Triangle and cylinder hits ignore
// textures, as there. The code is compiled only into the kTex
// instantiations; the pools of the repository's scenes (<= 8 MiB) sit in
// the 50 MB L2.
//
// The gradient kernel (K6). Replaces pathtracer_tpu/render/pallas_grad.py::
// _make_grad_kernel, launched by grad_tiles: the same template instantiated
// with kGrad replays each slot's forward paths operation for operation (the
// replay cannot drift from the forward, because it is the forward's code),
// records a tape of the bounces that add to the sum (winner, cos, mask
// before the update, color, and whether the mask was updated), and after
// each sample walks the tape backwards:
//     T_b = e_{b+1} + (upd_{b+1} ? c_{b+1} cos_{b+1} : 1) T_{b+1}
//     dS/dc_b = upd_b ? cot cos_b m_b T_b : 0,   dS/de_b = cot m_b,
// except that a direct light hit (which overwrote the sum with the light's
// color) gives that color `cot` and nothing else a gradient. A refraction
// bounce adds nothing and leaves T unchanged, so it takes no tape entry,
// and entries past a path's end do not exist.
//
// The tape is a per-thread array of at most kMaxTape entries (local
// memory).
//
// What bounds it: the replay is K1's work, and on the card the tape's
// writes and the reverse walk's arithmetic add 5-20% to it; the adds cost
// the rest, about 60% of the kernel with one lane an add (PERF.md §6).
// Most lanes of a warp add into the same few objects' sums at each step,
// and a shared float atomic serialises over the lanes that share an
// address. So the warp walks its lanes' tapes backwards together, and at
// each step the lanes with one target are merged first (warp_sum:
// __match_any_sync, then shuffles in a fixed lane order), the lowest
// adding once: into n_obj*6 floats of shared memory (one global add per
// nonzero entry per block at the end), or, for per-triangle sums, into
// gtri [n, 4] in global memory by one 16-byte atomic, where the TPU needed
// a one-hot MXU scatter or an HBM tape. (A tape in shared memory, slimmer
// and sized by max_bounces, was no faster for K6 and made K6-tex slower:
// fewer blocks an SM; PERF.md §6.) Float atomics add in any order, so the
// gradient sums are not bit-reproducible; the forward instantiations
// (kGrad = false) compile to the code they had before: every grad-only
// variable is dead there.
//
// Texel gradients (K6-tex). Replaces the tex_grads mode of _make_grad_kernel
// (pallas_grad.py:601-653, :877-925) and its transposed one-hot scatters
// (_scatter_staged :65, _scatter_staged_unified :148), which the TPU needed
// because a lane cannot scatter. The trainable texels are an f32 copy of
// the pool, laid out [T, 4] (rgb and one pad float, so a tap is one 16-byte
// load); the kF32 instantiations fetch from it (sample_texels: the same
// wrap, clamp and x-first blend as sample_pool, so with the pool's decoded
// values they render the rgb8 image bit for bit). The kGrad + kTex + kF32
// instantiation tapes the (u, v) of each bounce's color fetch and, in the
// reverse walk, adds the bounce's dS/dc times the four bilinear weights
// into gtex [T, 4] by one 16-byte atomic a tap (scatter_texels; a lane's
// four taps are four targets, so they are not merged), for winners whose
// texture is trainable (bit j of tex_train: a texture the JAX package
// stages). A textured winner's object color gets no gradient (the texel
// overwrote it); its emission still does.
//
// Next-event estimation (K1-nee). Replaces the NEE block of _make_kernel
// (pallas_kernel.py:2421-2513): at every bounce that hits a surface that is
// neither refracting nor a light, one shadow ray per light toward a random
// point on the light's sphere (the reference's randomPointOnSphere, its
// latitude offset kept); when the light is the shadow ray's nearest hit,
// the sum gains mask * color * emission * ldn * attenuation, with the mask
// before this bounce's update and the color after the texel fetch. Its two
// draws (ids 6 + 2 li, 7 + 2 li) are coherent draws, like the roulette's.
// The JAX block finds the shadow ray's nearest hit over every object and
// compares the winner with the light; the estimator needs one bit and the
// light's t. So on the per-thread walk the shadow ray asks light_visible,
// an occlusion query: the light is tested first, a missed light ends it,
// and the first occluder ends it (a GROUP's walk stops at its first
// occluding triangle), with no hit record kept. It decides by nearest_hit's
// rule on nearest_hit's values of t, so the sums are the plain version's
// (which keeps the nearest hit) bit for bit; light_visible says why, and
// where a GROUP before the light must keep nearest_hit's running bt. The
// packet walks (kWalk) keep nearest_hit for their shadow rays: every lane
// must reach the group's votes, which a per-lane early exit would break. A
// fifth template flag, kNee, compiles the block into four forward
// instantiations (kMesh x kTex) and the walk variants only: the light
// indices ride in the launch parameters, and the instantiations without
// NEE keep the code (and the registers) they had. The gradient and
// f32-texel instantiations have no NEE: the differentiable render refuses
// it, as the JAX package's does.
//
// The intersect-only kernel (K5). Replaces _make_intersect_kernel
// (pallas_kernel.py:2690, launched by intersect_tiles :2814 for
// intersect_batch :2916): the nearest hit over the whole scene for a flat
// batch of rays, one thread a ray, with no shading. It writes t (at most
// t_max), the winner (0 on a miss), the winner's object-space ray (the
// world ray on a miss), that triangle's smooth normal and color, its slot
// (-1 unless a triangle won: the wavefront's autograd gathers the
// triangle's color by it, so that the color carries a gradient) and
// whether a triangle won, one byte a ray; a scene without groups stores
// none of the triangle outputs, which are constants there. The TPU's (8,
// 512) tiling and padding rays are not carried over. Its bound: 85 bytes a
// ray in and out (56 without groups) against one transform and test an
// object (and the walk's nodes and slots), so bytes on primitive scenes and
// operations on meshes. Its launcher (render/megakernel.py intersect_batch)
// builds what depends on the scene alone once (IntersectTables, IsectScene
// here) and hands a call's outputs over as two buffers, so that a call's
// host time stays near the kernel's at the wavefront's batch sizes.
//
// The mesh walks of the JAX package's knobs (template arguments kWalk,
// kLeaf of the forward mesh and intersect instantiations; the section
// "the warp-packet walks" below): Kernel A, the warp-packet walk, counts
// of _packet_traverse_gated (PT_SUBPACKET=2), its cond gating (=1) and
// the per-chunk walks (=3); Kernel B, the tensor-core leaf test of the
// MXU leaf machine (_packet_traverse_mxu, PT_TRAVERSAL=mxu) as FP64 DMMA;
// and the node walk alone (PT_ABLATE_LEAF=1). Each gives the per-thread
// walk's hits. The leaf microbenchmark (leaf_bench, the counterpart of
// tools/leaf_microbench.py) times the leaf bodies alone.
//
// The frame's finish (finish_frame, launched by render/megakernel.py
// finish_frame from the render driver after a frame's last segment). It
// replaces no TPU kernel: the JAX package, like the host path of the
// port's driver, copies the slot sums to the host and scatters them into
// pixels there in float64 (untile_image's np.add.at), and on the card the
// device idled through that. One thread a base slot (replica 0 of its
// pixel; a valid pixel has exactly one): it adds the pixel's spp_pack
// replicas, which the layout puts at a fixed stride after it, in float64
// from 0.0 in slot order (np.add.at's order), divides by the frame's
// samples in float64 and rounds to f32, each operation rounded
// explicitly, and writes the pixel's three channels. Every pixel is
// written by one thread, so there are no atomics and the image is the host
// path's bit for bit. Bytes bound it: 12 bytes a slot in, 4 a base slot
// (the map) and 12 a pixel out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kObjCols = 45;
// an object row as the megakernel stages it in shared memory: its 45
// columns and 3 zeros, so that every row, and each row of its inverse, is
// 16-byte aligned (the intersect-only kernel stages the 45-float rows as
// they are: with these, its mesh batches ran 2% slower, PERF.md §6)
constexpr int kObjStride = 48;
constexpr int kCamCols = 17;
// The mesh tables (render/megakernel.py build_mesh_tables), 16-byte records
// read by __ldg of float4 from 16-byte-aligned bases:
//   node [2 float4]: (bbmin xyz, tri_start, or -1 for an inner node),
//                    (bbmax xyz, exit)
//   triangle test [3 float4]: p1 xyz, Ng xyz, U xyz, V xyz
//   triangle shading [3 float4]: n1 xyz, n2-n1 xyz, n3-n1 xyz, color rgb
constexpr int kNodeVecs = 2;
constexpr int kTriVecs = 3;
constexpr int kThreads = 128;
constexpr int kMaxObjects = 64;  // type codes travel in the launch params
constexpr int kMaxTape = 16;     // grad kernel: tape entries >= max_bounces
constexpr int kGradCols = 6;     // grad kernel: color rgb | emission rgb
constexpr int kNoTarget = -2147483647 - 1;  // grad kernel: a lane adds nothing
constexpr int kTexCols = 12;     // texture table columns (see above)
// a texture row staged in shared memory: the table's 12 columns, then the
// reciprocals 1/w, 1/h of the color texture and 1/w, 1/h of the normal map
// (computed once a block, by IEEE division), which the fetches' wrap takes
constexpr int kTexRecip = kTexCols;
constexpr int kTexRow = kTexCols + 4;
constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24
// f32 roundings of the double constants of the JAX UV maps and the pool's
// rgb8 decode: pi/2, pi, 1/(2 pi), 1/pi, 1/255
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kInvTwoPi = 0x1.45f306p-3f;
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kInv255 = 0x1.010102p-8f;
constexpr float kQuarterPi = 0x1.921fb6p-1f;  // NEE: f32 of pi * 0.25

enum { PLANE = 0, SPHERE = 1, CYLINDER = 2, BOX = 3, GROUP = 4 };
// The mesh walks (render/megakernel.py WALK_CODES, LEAF_CODES): each
// thread alone, or the warp-packet walks on the block's or the warp's
// majority octant; the leaf tests on the SIMT cores, on the tensor cores,
// or none
enum { WALK_THREAD = 0, WALK_BLOCK = 1, WALK_WARP = 2 };
enum { LEAF_SIMT = 0, LEAF_MMA = 1, LEAF_NONE = 2 };

// ---- counter-hash PRNG (pallas_kernel.py:660-731) -------------------------

__device__ __forceinline__ uint32_t tile_key(uint32_t seed, uint32_t tile) {
  return (seed * 0x9E3779B1u) ^ (tile * 0x85EBCA77u);
}

// A draw without a bounce index (the jitter) is the b == 0 case: the hash
// adds b * 0x165667B1.
__device__ __forceinline__ float hash_uniform(uint32_t key, uint32_t elem,
                                              uint32_t did, uint32_t n,
                                              uint32_t b) {
  uint32_t h = key ^ (did * 0xC2B2AE3Du);
  h += n * 0x27D4EB2Fu;
  h += b * 0x165667B1u;
  uint32_t x = h + elem;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (float)(x >> 8) * kInv24;
}

// ---- ray-primitive functions (pallas_kernel.py:761-878) -------------------

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ void axis_slab(float o, float d, float mn, float mx,
                                          float eps, float& lo, float& hi) {
  float t1, t2;
  if (fabsf(d) >= eps) {
    t1 = (mn - o) / d;
    t2 = (mx - o) / d;
  } else {
    t1 = (mn - o) * kBig;
    t2 = (mx - o) * kBig;
  }
  lo = fminf(t1, t2);
  hi = fmaxf(t1, t2);
}

__device__ __forceinline__ float plane_t(float oy, float dy, float eps) {
  if (!(fabsf(dy) > eps)) return kBig;
  const float t = -oy / dy;
  return t > eps ? t : kBig;
}

__device__ __forceinline__ float sphere_t(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float eps) {
  const float a = dx * dx + dy * dy + dz * dz;
  const float t_mid = -(ox * dx + oy * dy + oz * dz) / a;
  const float mx = ox + dx * t_mid;
  const float my = oy + dy * t_mid;
  const float mz = oz + dz * t_mid;
  const float perp2 = mx * mx + my * my + mz * mz;
  if (!(perp2 < 1.0f)) return kBig;
  const float dt = sqrtf((1.0f - perp2) / a);
  const float t1 = t_mid - dt;
  const float t2 = t_mid + dt;
  return fminf(t1 > eps ? t1 : kBig, t2 > eps ? t2 : kBig);
}

__device__ __forceinline__ float cylinder_t(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float min_y, float max_y,
                                            float eps) {
  const float a = dx * dx + dz * dz;
  if (!(fabsf(a) >= eps)) return kBig;
  const float t_mid = -(ox * dx + oz * dz) / a;
  const float mx = ox + dx * t_mid;
  const float mz = oz + dz * t_mid;
  const float perp2 = mx * mx + mz * mz;
  if (!(perp2 <= 1.0f)) return kBig;
  const float dt = sqrtf((1.0f - perp2) / a);
  const float t0 = t_mid - dt;
  const float t1 = t_mid + dt;
  const float y0 = oy + t0 * dy;
  const float y1 = oy + t1 * dy;
  const bool v0 = (y0 > min_y) && (y0 < max_y) && (t0 > eps);
  const bool v1 = (y1 > min_y) && (y1 < max_y) && (t1 > eps);
  return fminf(v0 ? t0 : kBig, v1 ? t1 : kBig);
}

// ---- the object loop's filter ----------------------------------------------
//
// The object loop (nearest_hit, object_t) replaces its winner only on a t
// below the running threshold T (the winner's t, kBig before one; the
// shadow query's max(bt, cut)), and T > eps. The filter decides from
// undivided f32 products that an object's exact test cannot give a t below
// T; a loop that then takes kBig for it leaves the winner, and every later
// step (a GROUP's pretest and walk from the running t included), as the
// exact test does, and skips the IEEE division (on a hit also the square
// root and second division). It is built from IEEE-rounded multiplies,
// adds and comparisons alone (-fmad=false keeps each rounded), so a numpy
// float32 copy reproduces it bit for bit (the CPU tests), and filter_check
// holds it to the exact tests on the card. The loop does not take it: on
// the card it made K1 3.4% slower, K1-nee 21% (the divisions are 4% of K1,
// and a warp skips only where all its lanes do; PERF.md §6, PR 12);
// tools/k1_variants.py `filter` puts it into the loop. The argument, with
// u = 2^-24 and every bound for round to nearest:
//
// Plane (plane_t: t = -oy / dy where |dy| > eps, else kBig). Where oy and dy
// have one sign bit, -oy / dy is <= 0 or NaN, so t is not above eps: kBig.
// Else, where lim = fl(T |dy|) >= 2^-126 (a normal number, so each product
// below is within a factor 1 +- u of its real value) and
// fl(|oy| kShrink) >= lim, kShrink = 1 - 2^-21: |oy| / |dy| >=
// T (1 - u) / (kShrink (1 + u)) >= T, and rounding is monotone, so t >= T
// (an infinite lim needs |oy| infinite, and t is then +-inf or NaN, never
// below T). Where |dy| <= eps the exact test gives kBig whatever the filter
// says.
//
// Sphere and cylinder (round_skip: a, b, c the f32 sums |d|^2, o.d, |o|^2
// over x, y, z, or over x, z for the cylinder, the exact test's own a and
// b). A certain miss: fl(c a) - fl(b b) >= fl(a + kMiss fl(c a)), kMiss =
// 2^-12, with 2^-40 <= a and fl(c a) <= 2^100 (no product then overflows,
// and underflow errors stay below 2^-149, far inside the margins). With
// A, B, C the real sums and D = C - B^2 / A the real squared distance of
// the line from the axis or center: each of a, b, c is within 3.01 u of
// its value (b within 3.01 u |o||d|), so C >= 1 - 12 u and
// D >= 1 - 5.03 u + C (kMiss (1 - 10.2 u) - 14.2 u) >= 1 + 4075 u C. The
// exact test's t_mid = fl(-b / a) is within 7.1 u sqrt(C / A) of -B / A,
// its m within 9.11 u sqrt(C) of the real perpendicular (its three
// roundings, the product's and the sum's per component), and its perp2 =
// fl(|m|^2) >= (sqrt(D) - 9.11 u sqrt(C))^2 (1 - 3 u) >= 1 + 4050 u C - 3 u
// > 1: both the sphere's `perp2 < 1` and the cylinder's `perp2 <= 1` fail,
// and the test gives kBig. Not nearer: where the miss test fails, y =
// fl(-b - fl(T fl(a kGrow))) > 0, kGrow = 1 + 2^-19, and fl(y y) >= fl(a
// fl(1 + kFar fl(1 + c))), kFar = 2^-16: then -B - T A (1 + 2^-20) >=
// sqrt(A) (1 + 2^-20 (sqrt(C) + 1)), so the nearer root's computed value,
// fl(t_mid - dt) with dt = fl(sqrt(fl(fl(1 - perp2) / a))) <= (1 + 3.02 u)
// / sqrt(A) (perp2 >= 0), is at least T (1 + 2^-20)(1 - u) >= T > eps: the
// sphere returns it (the farther root is not below it) and the cylinder a
// valid root or kBig, none below T (T A overflowing gives y = -inf: no
// skip). NaN and inf fail a comparison or a bound, and take the exact
// test.
constexpr float kShrink = 0x1.fffff0p-1f;  // 1 - 2^-21
constexpr float kMiss = 0x1p-12f;
constexpr float kGrow = 0x1.00002p+0f;     // 1 + 2^-19
constexpr float kFar = 0x1p-16f;
constexpr float kTinyNormal = 0x1p-126f;

// Whether plane_t(oy, dy, eps) is certainly not below T (T > eps).
__device__ __forceinline__ bool plane_skip(float oy, float dy, float T) {
  const float lim = T * fabsf(dy);
  return ((__float_as_int(oy) ^ __float_as_int(dy)) >= 0) ||
         (fabsf(oy) * kShrink >= lim && lim >= kTinyNormal);
}

// Whether the sphere's or the cylinder's test is certainly not below T
// (T > eps), from its a = |d|^2, b = o.d and c = |o|^2.
__device__ __forceinline__ bool round_skip(float a, float b, float c,
                                           float T) {
  const float ca = c * a;
  if (!(a >= 0x1p-40f && ca <= 0x1p100f)) return false;
  if (ca - b * b >= a + kMiss * ca) return true;  // the line misses
  const float y = -b - T * (a * kGrow);           // the nearer root past T
  return y > 0.0f && y * y >= a * (1.0f + kFar * (1.0f + c));
}

__device__ __forceinline__ bool sphere_skip(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float T) {
  return round_skip(dx * dx + dy * dy + dz * dz, ox * dx + oy * dy + oz * dz,
                    ox * ox + oy * oy + oz * oz, T);
}

__device__ __forceinline__ bool cylinder_skip(float ox, float oz, float dx,
                                              float dz, float T) {
  return round_skip(dx * dx + dz * dz, ox * dx + oz * dz, ox * ox + oz * oz,
                    T);
}

__device__ __forceinline__ float box_t(float ox, float oy, float oz, float dx,
                                       float dy, float dz, float eps) {
  float x1, x2, y1, y2, z1, z2;
  axis_slab(ox, dx, -1.0f, 1.0f, eps, x1, x2);
  axis_slab(oy, dy, -1.0f, 1.0f, eps, y1, y2);
  axis_slab(oz, dz, -1.0f, 1.0f, eps, z1, z2);
  const float tmin = fmaxf(fmaxf(x1, y1), z1);
  const float tmax = fminf(fminf(x2, y2), z2);
  if (!(tmin <= tmax)) return kBig;
  return fminf(tmin > eps ? tmin : kBig, tmax > eps ? tmax : kBig);
}

// tracer.cl:485-505
__device__ __forceinline__ float schlick(float cx, float cy, float cz,
                                         float nx, float ny, float nz,
                                         float n1, float n2) {
  const float cos = dot3(cx, cy, cz, nx, ny, nz);
  const float n = n1 / n2;
  const float sin2t = (n * n) * (1.0f - cos * cos);
  if ((n1 > n2) && (sin2t > 1.0f)) return 1.0f;
  const float cos_t = sqrtf(fmaxf(1.0f - sin2t, 0.0f));
  const float cos_eff = n1 > n2 ? cos_t : cos;
  const float temp = (n1 - n2) / (n1 + n2);
  const float r0 = temp * temp;
  const float m = 1.0f - cos_eff;
  const float m2 = m * m;
  return r0 + (1.0f - r0) * (m2 * m2 * m);
}

__device__ __forceinline__ void refract(float cx, float cy, float cz,
                                        float nx, float ny, float nz,
                                        float n1, float n2, float& rx,
                                        float& ry, float& rz) {
  const float cos_i = dot3(cx, cy, cz, nx, ny, nz);
  const float ratio = n1 / n2;
  const float sin2t = (ratio * ratio) * (1.0f - cos_i * cos_i);
  const float cos_t = sqrtf(fmaxf(1.0f - sin2t, 0.0f));
  const float k = ratio * cos_i - cos_t;
  if (sin2t <= 1.0f) {
    rx = nx * k - cx * ratio;
    ry = ny * k - cy * ratio;
    rz = nz * k - cz * ratio;
  } else {
    rx = 0.0f;
    ry = 0.0f;
    rz = 0.0f;
  }
}

// ---- UV maps and texel fetch (pallas_kernel.py:881-995) --------------------

// atan(z) for z in [0, 1]: the JAX kernel's odd degree-13 fit
__device__ __forceinline__ float atan_poly(float z) {
  const float z2 = z * z;
  return z * (0.99999659f + z2 * (-0.33319012f + z2 * (0.19823318f +
         z2 * (-0.13294270f + z2 * (0.08076473f + z2 * (-0.03461463f +
         z2 * 0.00715190f))))));
}

// four-quadrant atan2 by octant reduction to atan_poly
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = swap ? ay : ax;
  float r = atan_poly(num / fmaxf(den, 1e-30f));
  if (swap) r = kHalfPi - r;
  if (x < 0.0f) r = kPi - r;
  return y < 0.0f ? -r : r;
}

// unit-sphere local point -> (u, v), the v flip folded in (tracer.cl:178-213)
__device__ __forceinline__ void spherical_uv(float lx, float ly, float lz,
                                             float& u, float& v) {
  const float theta = atan2_poly(lx, lz);
  const float radius = sqrtf(lx * lx + ly * ly + lz * lz);
  const float c = fminf(fmaxf(ly / radius, -1.0f), 1.0f);
  // acos(c) = atan2(sqrt(1 - c^2), c)
  const float phi =
      atan2_poly(sqrtf(fmaxf((1.0f - c) * (1.0f + c), 0.0f)), c);
  u = 1.0f - (theta * kInvTwoPi + 0.5f);
  v = phi * kInvPi;
}

// C fmod by 2 as the JAX kernel computes it: a - 2 * trunc(a * (1/2))
__device__ __forceinline__ float cfmod2(float a) {
  return a - 2.0f * truncf(a * 0.5f);
}

// cube-cross UV of a unit-cube local point (tracer.cl:113-175)
__device__ __forceinline__ void cube_uv(float x, float y, float z, float& u,
                                        float& v) {
  const float coord = fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
  const float third = 0.333333f;
  if (coord == x) {
    u = 0.5f + (cfmod2(1.0f - z) * 0.5f) * 0.25f;
  } else if (coord == -x) {
    u = (cfmod2(z + 1.0f) * 0.5f) * 0.25f;
  } else if (coord == y || coord == -y || coord == z) {
    u = 0.25f + (cfmod2(x + 1.0f) * 0.5f) * 0.25f;
  } else {
    u = 0.75f + (cfmod2(1.0f - x) * 0.5f) * 0.25f;
  }
  if (coord != x && coord != -x && coord == y) {
    v = 1.0f - (cfmod2(1.0f - z) * 0.5f) * third;
  } else if (coord != x && coord != -x && coord == -y) {
    v = (cfmod2(z + 1.0f) * 0.5f) * third;
  } else {
    v = 0.6666666f - (cfmod2(y + 1.0f) * 0.5f) * third;
  }
}

// floor-mod wrap of a float-held integer coordinate to [0, m): the JAX
// kernel's formula, one IEEE division (the fetches' cold branch)
__device__ __forceinline__ float wrap_tex(float a, float m) {
  return a - m * floorf(a / m);
}

// The fetches' wrap without a division. For an integer-valued a with
// |a| < 2^22, an integer-valued m in [1, 2^24) and im = fl(1/m):
// fl(a * im) lies within |a/m| 2^-23 (1 + 2^-25) <= (1 + 2^-25) / (2m) of
// a/m (exactly on it for m = 1, 2), and adding and taking off 1.5 * 2^23
// rounds it to the nearest integer q (the sum lies in [2^23, 2^24], where
// the ulp is 1), so |q - a/m| < 1; then m q, r = a - m q (|r| < m) and
// r + m are integers below 2^24, exact in f32, and wrap_fast(a) is the
// exact floor-mod. wrap_tex gives the exact floor-mod too wherever
// |a| + m < 2^24: a/m rounded once cannot cross the integer above it (it
// lies at least 1/m below it, more than half its ulp), and m floor(a/m)
// and the difference are exact. The fetches take the fast wrap where
// |x0|, |y0| < kWrapFast and w, h <= kSideFast, so that both hold for x0
// and x0 + 1 and the two agree bit for bit (chip_smoke.py also checks it
// on the card, over every integer in [-2^25, 2^25] for each texture side
// of the repository's scenes: wrap_check); elsewhere, NaN and inf
// included, they keep wrap_tex.
constexpr float kWrapFast = 4194304.0f;   // 2^22
constexpr float kSideFast = 8388608.0f;   // 2^23
constexpr float kRoundInt = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ float wrap_fast(float a, float m, float im) {
  const float q = (a * im + kRoundInt) - kRoundInt;
  const float r = a - m * q;
  return r < 0.0f ? r + m : r;
}

__device__ __forceinline__ bool wrap_is_fast(float x0, float y0, float w,
                                             float h) {
  return fabsf(x0) < kWrapFast && fabsf(y0) < kWrapFast && w <= kSideFast &&
         h <= kSideFast;
}

// Byte k (0 r, 1 g, 2 b) of an rgb8 texel as q * f32(1/255). One byte
// permute puts the byte into the mantissa of 2^23, and taking 2^23 off
// again leaves its exact value: the int-to-float conversion's result,
// without the conversion unit.
__device__ __forceinline__ float texel_channel(int q, int k) {
  return (__int_as_float(__byte_perm(q, 0x4B000000, 0x7650 + k)) -
          8388608.0f) *
         kInv255;
}

// the x-first bilinear blend of one channel (the JAX order)
__device__ __forceinline__ float blend(float c00, float c01, float c10,
                                       float c11, float tx, float ty) {
  const float top = c00 * (1.0f - tx) + c01 * tx;
  const float bot = c10 * (1.0f - tx) + c11 * tx;
  return top * (1.0f - ty) + bot * ty;
}

// the blend of four rgb8 taps, each channel decoded where it is blended
__device__ __forceinline__ void blend_rgb8(int4 q, float tx, float ty,
                                           float& r, float& g, float& b) {
  r = blend(texel_channel(q.x, 0), texel_channel(q.y, 0),
            texel_channel(q.z, 0), texel_channel(q.w, 0), tx, ty);
  g = blend(texel_channel(q.x, 1), texel_channel(q.y, 1),
            texel_channel(q.z, 1), texel_channel(q.w, 1), tx, ty);
  b = blend(texel_channel(q.x, 2), texel_channel(q.y, 2),
            texel_channel(q.z, 2), texel_channel(q.w, 2), tx, ty);
}

// The four taps (y0, x0), (y0, x1), (y1, x0), (y1, x1) of a bilinear REPEAT
// fetch of texture (base, w, h) anchored at (x0, y0), by the JAX kernel's
// wrap_tex, each index clamped into [base, base + w*h) as
// jnp.take(mode="clip") does: the fetch's cold branch.
__device__ __forceinline__ int4 taps_take4(const int* __restrict__ pool,
                                           float base, float w, float h,
                                           float x0, float y0) {
  const int bi = (int)base, wi = (int)w;
  const int last = bi + wi * (int)h - 1;
  const int c0 = (int)wrap_tex(x0, w), c1 = (int)wrap_tex(x0 + 1.0f, w);
  const int r0 = (int)wrap_tex(y0, h), r1 = (int)wrap_tex(y0 + 1.0f, h);
  const auto tap = [&](int r, int c) {
    return __ldg(pool + min(max(bi + r * wi + c, bi), last));
  };
  return make_int4(tap(r0, c0), tap(r0, c1), tap(r1, c0), tap(r1, c1));
}

// Bilinear REPEAT sample (tracer.cl:829: normalized coords, REPEAT, LINEAR)
// at (u, v) of the texture tex = (base, w, h) with reciprocals iw, ih, from
// the rgb8 pool: four 4-byte loads through the read-only cache, their
// indices all known before the first. Where wrap_is_fast, the columns
// c0 = wrap_fast(x0), c1 = c0 + 1 (0 at w), the rows the same, and the
// indices base + r w + c are exact in f32 and lie in [base, base + w*h),
// so jnp.take's clip leaves them as they are; elsewhere, and without kFast
// (the texel-fetch probe's reference), taps_take4. Decoded as
// q * f32(1/255) where the blend uses them and blended in f32 in the JAX
// order (x first), so the result is the plain version's bit for bit.
template <bool kFast = true>
__device__ __forceinline__ void sample_pool(const int* __restrict__ pool,
                                            const float* tex, float iw,
                                            float ih, float u, float v,
                                            float& r, float& g, float& b) {
  const float base = tex[0], w = tex[1], h = tex[2];
  const float fx = u * w - 0.5f;
  const float fy = v * h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  int4 q;
  if (kFast && wrap_is_fast(x0, y0, w, h)) {
    const float c0 = wrap_fast(x0, w, iw), r0 = wrap_fast(y0, h, ih);
    const float c1 = c0 + 1.0f == w ? 0.0f : c0 + 1.0f;
    const float r1 = r0 + 1.0f == h ? 0.0f : r0 + 1.0f;
    const float row0 = base + r0 * w, row1 = base + r1 * w;
    q = make_int4(__ldg(pool + (int)(row0 + c0)),
                  __ldg(pool + (int)(row0 + c1)),
                  __ldg(pool + (int)(row1 + c0)),
                  __ldg(pool + (int)(row1 + c1)));
  } else {
    q = taps_take4(pool, base, w, h, x0, y0);
  }
  blend_rgb8(q, tx, ty, r, g, b);
}

// The four texel indices of a bilinear REPEAT fetch at (u, v) of texture
// tex = (base, w, h) (reciprocals iw, ih) and its x/y weights, the taps of
// sample_pool; the indices also stay below n, the texel count (a table
// that reaches past the texels reads and writes the last one instead of
// other memory). The fast wrap gives c0 and r0; c1 = c0 + 1, or 0 at w.
__device__ __forceinline__ void texel_taps(const float* tex, float iw,
                                           float ih, float u, float v, int n,
                                           int (&idx)[4], float& tx,
                                           float& ty) {
  const float base = tex[0], w = tex[1], h = tex[2];
  const float fx = u * w - 0.5f;
  const float fy = v * h - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  tx = fx - x0;
  ty = fy - y0;
  const int bi = (int)base, wi = (int)w, hi = (int)h;
  const int last = min(bi + wi * hi, n) - 1;
  int c0, c1, r0, r1;
  if (wrap_is_fast(x0, y0, w, h)) {
    c0 = (int)wrap_fast(x0, w, iw);
    r0 = (int)wrap_fast(y0, h, ih);
    c1 = c0 + 1 == wi ? 0 : c0 + 1;
    r1 = r0 + 1 == hi ? 0 : r0 + 1;
  } else {
    c0 = (int)wrap_tex(x0, w);
    c1 = (int)wrap_tex(x0 + 1.0f, w);
    r0 = (int)wrap_tex(y0, h);
    r1 = (int)wrap_tex(y0 + 1.0f, h);
  }
  idx[0] = min(max(bi + r0 * wi + c0, bi), last);
  idx[1] = min(max(bi + r0 * wi + c1, bi), last);
  idx[2] = min(max(bi + r1 * wi + c0, bi), last);
  idx[3] = min(max(bi + r1 * wi + c1, bi), last);
}

// sample_pool on the n f32 texels [n, 4]: one 16-byte load a tap, the same
// blend
__device__ __forceinline__ void sample_texels(const float4* __restrict__ tex,
                                              int n, const float* tt,
                                              float iw, float ih, float u,
                                              float v, float& r, float& g,
                                              float& b) {
  int idx[4];
  float tx, ty;
  texel_taps(tt, iw, ih, u, v, n, idx, tx, ty);
  const float4 c00 = __ldg(tex + idx[0]), c01 = __ldg(tex + idx[1]);
  const float4 c10 = __ldg(tex + idx[2]), c11 = __ldg(tex + idx[3]);
  r = blend(c00.x, c01.x, c10.x, c11.x, tx, ty);
  g = blend(c00.y, c01.y, c10.y, c11.y, tx, ty);
  b = blend(c00.z, c01.z, c10.z, c11.z, tx, ty);
}

struct Params {
  float* out_r;
  float* out_g;
  float* out_b;
  const int* px;
  const int* py;
  const float* obj;
  const float* cam;
  const float4* __restrict__ nodes;
  const float4* __restrict__ tris;
  int n_obj, n_slots, S, L, waves, spp_pack, chunk_axis;  // waves = spp/pack
  uint32_t seed;
  int sample_base, max_bounces, max_eff, leaf_size, oct_nodes;
  float eps, t_max, sun_cut, sun_den, golden2;
  int coherent;
  int obj_types[kMaxObjects];
  int group_root[kMaxObjects];  // node range [root, end) of each GROUP
  int group_end[kMaxObjects];
  // grad kernel only: the per-slot cotangents of the r/g/b sums, the
  // [n_obj, 6] color | emission gradient sums and the [n_tri_slots, 3]
  // triangle color gradient sums (null: object gradients only)
  const float* cot_r;
  const float* cot_g;
  const float* cot_b;
  float* gobj;
  float* gtri;
  // textured scenes only: the rgb8 texel pool and the [n_obj, 12] texture
  // table
  const int* __restrict__ tex_pool;
  const float* tex_table;
  // kF32 only: the f32 texels [T, 4] fetched in place of the pool; with
  // kGrad the [T, 3] texel gradient sums and the objects whose texture
  // takes them (bit j for object j)
  const float4* __restrict__ tex_texels;
  float* gtex;
  unsigned long long tex_train;
  int n_texels;
  // kNee only: the lights (meta.light_indices), in the JAX order
  int n_lights;
  int light_idx[kMaxObjects];
  // LEAF_MMA only: the leaves' plane tiles (render/megakernel.py
  // mxu_fragments: [n_leaves, leaf_tiles(K), 32] f32)
  const float* __restrict__ mxu;
  // the triangles' shading records, read for the winner alone
  const float4* __restrict__ shade;
};

// The bilinear fetch of texture tex = (base, w, h) (reciprocals iw, ih) at
// (u, v): from the rgb8 pool, or (kF32) from the f32 texels.
template <bool kF32>
__device__ __forceinline__ void fetch_texture(const Params& p,
                                              const float* tex, float iw,
                                              float ih, float u, float v,
                                              float& r, float& g, float& b) {
  if constexpr (kF32)
    sample_texels(p.tex_texels, p.n_texels, tex, iw, ih, u, v, r, g, b);
  else
    sample_pool(p.tex_pool, tex, iw, ih, u, v, r, g, b);
}

__device__ __forceinline__ void add_nonzero(float* a, float v) {
  if (v != 0.0f) atomicAdd(a, v);
}

// (r, g, b) added into a 16-byte row of a [n, 4] table in global memory by
// one vector atomic (compute capability 9.x), skipped when all are zero
__device__ __forceinline__ void add_rgb(float* row, float r, float g,
                                        float b) {
  if (r != 0.0f || g != 0.0f || b != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(r, g, b, 0.0f));
}

// Transpose of sample_texels: the bounce's dS/dc (gr, gg, gb) times each
// tap's bilinear weight, added into gtex [n, 4] (rgb and a pad column that
// stays 0) at the fetch's indices, one vector atomic a tap (tt: the
// winner's staged texture row, whose color texture was fetched).
__device__ __forceinline__ void scatter_texels(float* gtex, int n,
                                               const float* tt, float u,
                                               float v, float gr, float gg,
                                               float gb) {
  int idx[4];
  float tx, ty;
  texel_taps(tt + 1, tt[kTexRecip], tt[kTexRecip + 1], u, v, n, idx, tx,
             ty);
  const float wt[4] = {(1.0f - tx) * (1.0f - ty), tx * (1.0f - ty),
                       (1.0f - tx) * ty, tx * ty};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    add_rgb(gtex + (size_t)idx[k] * 4, gr * wt[k], gg * wt[k], gb * wt[k]);
}

constexpr int kGradThreads = kThreads;  // a gradient block's threads

// Sum v over the lanes of `lanes` whose key is this lane's (grouped by
// __match_any_sync), by shuffles in a fixed order: a tree over the group's
// ranks (its lanes in increasing order), so a group's sum depends on its
// members alone. Every lane of `lanes` must call it with the same N.
// Returns whether this lane is its group's lowest, which then holds the
// sums.
template <int N>
__device__ __forceinline__ bool warp_sum(unsigned lanes, int key,
                                         float (&v)[N]) {
  const unsigned peers = __match_any_sync(lanes, key);
  const unsigned lane = threadIdx.x & 31u;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int n = __popc(peers);
  const int most = (int)__reduce_max_sync(lanes, (unsigned)n);
  for (int off = 1; off < most; off <<= 1) {
    // the lane of rank `rank + off` (fns: its (rank + off + 1)-th set bit)
    const bool take = (rank & (2 * off - 1)) == 0 && rank + off < n;
    const int src = take ? (int)__fns(peers, 0u, rank + off + 1) : (int)lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = __shfl_sync(lanes, v[i], src);
      if (take) v[i] += x;
    }
  }
  return rank == 0;
}

// ---- BVH walk (pallas_kernel.py:1231-1540, one ray) -------------------------

// 1/d for the slab tests, hoisted out of the walk (pallas_kernel.py:1428)
__device__ __forceinline__ float inv_safe(float d, float eps) {
  return fabsf(d) >= eps ? 1.0f / d : kBig;
}

// The dual-basis tests of one leaf's leaf_size triangle slots from s0
// (pallas_kernel.py:1256-1331), one after the other with a strict `<`: a
// slot hit below bt and t_max becomes the winner (its slot and
// barycentrics) and the new bt, which is returned. The per-thread walk, the
// warp-packet walk and the leaf microbenchmark (P3) share it. kAny (the
// shadow query, light_visible): return at the first winner below `cut`.
template <bool kAny = false>
__device__ __forceinline__ float leaf_simt(const Params& p, int s0, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float bt,
                                           int& slot, float& wu, float& wv,
                                           float cut = 0.0f) {
  const float eps = p.eps;
  for (int k = 0; k < p.leaf_size; ++k) {
    // (p1 xyz, Ng x), (Ng yz, U xy), (U z, V xyz)
    const float4* tr = p.tris + (size_t)(s0 + k) * kTriVecs;
    const float4 a = __ldg(tr), b = __ldg(tr + 1), c = __ldg(tr + 2);
    const float pxx = ox - a.x;
    const float pyy = oy - a.y;
    const float pzz = oz - a.z;
    const float den = dx * a.w + dy * b.x + dz * b.y;
    const float num_t = -(pxx * a.w + pyy * b.x + pzz * b.y);
    const bool den_ok = fabsf(den) >= eps;
    const float f = 1.0f / (den_ok ? den : 1.0f);
    const float t = num_t * f;
    const float hx = pxx + t * dx;
    const float hy = pyy + t * dy;
    const float hz = pzz + t * dz;
    const float u = hx * b.z + hy * b.w + hz * c.x;
    const float v = hx * c.y + hy * c.z + hz * c.w;
    if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps &&
        t < bt && t < p.t_max) {
      bt = t;
      slot = s0 + k;
      wu = u;
      wv = v;
      if constexpr (kAny) {
        if (bt < cut) return bt;
      }
    }
  }
  return bt;
}

// Skip-link walk of one group's nodes [root, end) in object space. `bt` is
// the closest hit among the objects before this one; returns the closest
// triangle hit below it (and below t_max), or `bt` unchanged. On a hit,
// `slot` is the winning triangle slot and (u, v) its barycentrics. kLeaf
// LEAF_NONE walks the nodes alone (PT_ABLATE_LEAF=1: no triangle is hit).
// kAny, the shadow query's any-hit walk: it returns as soon as a winner
// lies below `cut` (cut <= bt on entry), which decides the query; until
// then it walks, prunes and tests exactly as the nearest-hit walk does.
template <int kLeaf = LEAF_SIMT, bool kAny = false>
__device__ __forceinline__ float walk_group(const Params& p, int root, int end,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float bt, int& slot, float& wu,
                                         float& wv, float cut = 0.0f) {
  const float eps = p.eps;
  const float ivx = inv_safe(dx, eps);
  const float ivy = inv_safe(dy, eps);
  const float ivz = inv_safe(dz, eps);
  int base = 0;
  if (p.oct_nodes) {
    // the node copy of this ray's direction octant (bvh.octant_node_orders)
    const int oct = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
    base = (1 + oct) * p.oct_nodes;
  }
  int idx = root + base;
  const int stop = end + base;
  while (idx < stop) {
    const float4* nd = p.nodes + (size_t)idx * kNodeVecs;
    const float4 lo = __ldg(nd), hi = __ldg(nd + 1);
    const float ax1 = (lo.x - ox) * ivx;
    const float ax2 = (hi.x - ox) * ivx;
    const float ay1 = (lo.y - oy) * ivy;
    const float ay2 = (hi.y - oy) * ivy;
    const float az1 = (lo.z - oz) * ivz;
    const float az2 = (hi.z - oz) * ivz;
    const float tmin = fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)),
                             fminf(az1, az2));
    const float tmax = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)),
                             fmaxf(az1, az2));
    const bool hit = (tmin <= tmax) && (tmax > eps) && (tmin < bt);
    if (hit && lo.w >= 0.0f) {  // a leaf: its first slot
      if constexpr (kLeaf == LEAF_SIMT) {
        bt = leaf_simt<kAny>(p, (int)lo.w, ox, oy, oz, dx, dy, dz, bt, slot,
                             wu, wv, cut);
        if constexpr (kAny) {
          if (bt < cut) return bt;
        }
      }
    }
    idx = hit ? idx + 1 : (int)hi.w;
  }
  return bt;
}

// The winning triangle's smooth normal n1 + u*(n2-n1) + v*(n3-n1)
// (tracer.cl:669) and its color, from its shading record: (n1 xyz,
// (n2-n1) x), ((n2-n1) yz, (n3-n1) xy), ((n3-n1) z, color rgb).
__device__ __forceinline__ void tri_shading(const Params& p, int tri, float u,
                                            float v, float& nx, float& ny,
                                            float& nz, float& r, float& g,
                                            float& b) {
  const float4* sh = p.shade + (size_t)tri * kTriVecs;
  const float4 s0 = __ldg(sh), s1 = __ldg(sh + 1), s2 = __ldg(sh + 2);
  nx = s0.x + s0.w * u + s1.z * v;
  ny = s0.y + s1.x * u + s1.w * v;
  nz = s0.z + s1.y * u + s2.x * v;
  r = s2.y;
  g = s2.z;
  b = s2.w;
}

// ---- the warp-packet walks (pallas_kernel.py:1334-1900) --------------------
//
// The TPU walks one node pointer per (8, 512) tile, or per 128-lane chunk
// (PT_SUBPACKET=3), because its vector unit has no per-lane control flow.
// Here the 32 lanes of a warp share one: each lane runs the slab test
// against its own running best t, the warp enters the node when any lane
// hits it (__any_sync) and skips to its exit otherwise, and a leaf's tests
// run only when some lane's slab hit it; a lane merges a leaf's winner
// only where its own slab test hit the leaf (the `hb` mask of
// _packet_traverse :1500). Inactive lanes carry best t = -kBig, which fails
// every slab test and merge (_packet_traverse_gated :1596). A child box
// lies inside its parent's, so each lane tests exactly the leaves its
// per-thread walk would test, in the same order of the same octant copy:
// with the same copy, the same hit bit for bit. The copy is the majority
// octant of the group's active lanes (_group_octant_base :1238-1245):
// WALK_BLOCK votes over the thread block (the TPU tile's counterpart;
// PT_SUBPACKET=1 and 2, PT_TRAVERSAL=mxu), WALK_WARP over the warp (the
// 128-lane chunk's; PT_SUBPACKET=3). Every lane of the group must call the
// walk together: the megakernel keeps the lanes whose paths ended in its
// bounce loop, inactive, until the group's last path ends.

constexpr unsigned kFull = 0xffffffffu;

// Whether any thread of the group holds v.
template <int kWalk>
__device__ __forceinline__ bool group_any(bool v) {
  if constexpr (kWalk == WALK_BLOCK) return __syncthreads_or(v);
  return __any_sync(kFull, v);
}

// The group's octant: per axis, strictly more than half of the active
// lanes negative.
template <int kWalk>
__device__ __forceinline__ int group_octant(bool act, float dx, float dy,
                                            float dz) {
  int n, cx, cy, cz;
  if constexpr (kWalk == WALK_BLOCK) {
    n = __syncthreads_count(act);
    cx = __syncthreads_count(act && dx < 0.0f);
    cy = __syncthreads_count(act && dy < 0.0f);
    cz = __syncthreads_count(act && dz < 0.0f);
  } else {
    n = __popc(__ballot_sync(kFull, act));
    cx = __popc(__ballot_sync(kFull, act && dx < 0.0f));
    cy = __popc(__ballot_sync(kFull, act && dy < 0.0f));
    cz = __popc(__ballot_sync(kFull, act && dz < 0.0f));
  }
  return (2 * cx > n) + 2 * (2 * cy > n) + 4 * (2 * cz > n);
}

// One m8n8k4 FP64 tensor-core product D = A B of one warp: A [8, 4] row
// major with a0 = A[lane / 4][lane % 4], B [4, 8] column major with b0 =
// B[lane % 4][lane / 4], D [8, 8] with d_i = D[lane / 4][2 (lane % 4) + i].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
}

// The warp's rays in shared memory, [warp][half][32 rays][4]: half 0
// holds each ray's q = [o, 1], half 1 its q = [d, 0]. The A fragment of
// 8-ray tile ct (component lane % 4 of ray ct * 8 + lane / 4) is float
// ct * 32 + lane of its half, read where a product takes it (frag_o,
// frag_d), so that no fragment stays live in registers across the walk.
__shared__ __align__(16) float s_rays[kThreads / 32][2][128];

struct RayFrags {
  const float* s;  // the warp's rays
};

__device__ __forceinline__ RayFrags ray_frags(float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  const int lane = threadIdx.x & 31;
  float* s = s_rays[threadIdx.x >> 5][0];
  __syncwarp();  // the warp's last walk has read its rays
  reinterpret_cast<float4*>(s)[lane] = make_float4(ox, oy, oz, 1.0f);
  reinterpret_cast<float4*>(s + 128)[lane] = make_float4(dx, dy, dz, 0.0f);
  __syncwarp();
  return RayFrags{s};
}

__device__ __forceinline__ double frag_o(const RayFrags& q, int ct) {
  return q.s[ct * 32 + (threadIdx.x & 31)];
}

__device__ __forceinline__ double frag_d(const RayFrags& q, int ct) {
  return q.s[128 + ct * 32 + (threadIdx.x & 31)];
}

// The plane groups of an MXU block (den, num_t, ou, du, ov, dv) that read
// the direction half of q; the others read the origin half.
__device__ __forceinline__ bool d_half(int g) {
  return g == 0 || g == 3 || g == 5;
}

// The leaves' plane tiles (render/megakernel.py mxu_fragments), each the B
// fragment of one DMMA whose A is a ray tile: this lane holds coefficient
// lane % 4 (of the half of q its group reads) of column lane / 4, so the
// DMMA's d_i are ray ct * 8 + lane / 4 against column 2 (lane % 4) + i. A
// leaf of K > 4 triangles has 6 ceil(K/8) tiles, tile g ceil(K/8) + kt
// holding group g of triangles 8 kt .. 8 kt + 7 in its columns. A leaf of
// K <= 4 has four, each with two groups of one half of q, triangle c's in
// columns 2c and 2c + 1: (den, du), (dv, none), (num_t, ou), (ov, none);
// so each lane holds all six dots of one (ray, triangle) pair.
constexpr int kPackLeaf = 4;

__device__ __forceinline__ int leaf_tiles(int K) {
  return K <= kPackLeaf ? 4 : 6 * ((K + 7) >> 3);
}

// The triangle test from a pair's six plane dots (_packet_traverse_mxu
// :1799-1810), each rounded once to f32: t = num_t / den as num_t *
// (1 / den), u = ou + t du, v = ov + t dv; returns t, or kBig when the
// pair does not hit.
__device__ __forceinline__ float pair_test(double den_d, double num_d,
                                           double ou_d, double du_d,
                                           double ov_d, double dv_d,
                                           float eps, float& u, float& v) {
  const float den = (float)den_d, num_t = (float)num_d;
  const bool den_ok = fabsf(den) >= eps;
  const float f = 1.0f / (den_ok ? den : 1.0f);
  const float t = num_t * f;
  u = (float)ou_d + t * (float)du_d;
  v = (float)ov_d + t * (float)dv_d;
  return (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > eps)
             ? t : kBig;
}

// This lane's pair tests in ray tile ct (q's fragments qo, qd) against the
// leaf whose tiles start at `a` (this lane's float of the first): ray
// ct * 8 + lane / 4 against triangle lane % 4 (K <= 4), or against
// triangles 8 kt + 2 (lane % 4) + i, i = 0, 1, for each kt in turn (K > 4);
// f(t, k, u, v) for each pair, k ascending. Every product of two f32 is
// exact in f64.
template <class F>
__device__ __forceinline__ void tile_pairs(const float* a, int K, double qo,
                                           double qd, float eps, F&& f) {
  const int c = threadIdx.x & 3;
  float u, v;
  if (K <= kPackLeaf) {
    double den, du, dv, num_t, ou, ov, none;
    dmma(den, du, qd, (double)__ldg(a));
    dmma(dv, none, qd, (double)__ldg(a + 32));
    dmma(num_t, ou, qo, (double)__ldg(a + 64));
    dmma(ov, none, qo, (double)__ldg(a + 96));
    const float t = pair_test(den, num_t, ou, du, ov, dv, eps, u, v);
    f(t, c, u, v);
    return;
  }
  const int nkt = (K + 7) >> 3;
  for (int kt = 0; kt < nkt; ++kt) {
    double d[6][2];
#pragma unroll
    for (int g = 0; g < 6; ++g)
      dmma(d[g][0], d[g][1], d_half(g) ? qd : qo,
           (double)__ldg(a + (g * nkt + kt) * 32));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float t = pair_test(d[0][i], d[1][i], d[2][i], d[3][i], d[4][i],
                                d[5][i], eps, u, v);
      f(t, 8 * kt + 2 * c + i, u, v);
    }
  }
}

// The tensor-core leaf test (Kernel B, the counterpart of
// _packet_traverse_mxu's leaf machine): one leaf's K triangles against the
// warp's 32 rays, the plane dots by DMMA (tile_pairs), then t, the
// barycentrics and validity on the SIMT cores, each ray's closest hit
// (the lowest slot on ties) reduced over the 4 lanes that hold its pairs
// and handed to the ray's lane, which merges it where its own slab test hit the leaf
// (`hit`). A ray tile in which no slab hit the leaf is skipped. The whole
// warp calls it.
__device__ __forceinline__ float leaf_mma(const Params& p, int s0,
                                          const RayFrags& q, bool hit,
                                          float bt, int& slot, float& wu,
                                          float& wv) {
  const int K = p.leaf_size;
  const int lane = threadIdx.x & 31, r = lane & 7;
  const float* a = p.mxu + (size_t)(s0 / K) * leaf_tiles(K) * 32 + lane;
  const unsigned hits = __ballot_sync(kFull, hit);
  float mt = kBig, mu = 0.0f, mv = 0.0f;
  int mk = 0;
  for (int ct = 0; ct < 4; ++ct) {
    if (!((hits >> (8 * ct)) & 0xffu)) continue;
    float wt = kBig, bu = 0.0f, bv = 0.0f;
    int wk = K;
    tile_pairs(a, K, frag_o(q, ct), frag_d(q, ct), p.eps,
               [&](float t, int k, float u, float v) {
                 if (t < wt) {  // k ascending: the lowest slot on ties
                   wt = t;
                   wk = k;
                   bu = u;
                   bv = v;
                 }
               });
    // (t, k)-lexicographic minimum over the 4 lanes of the ray
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ot = __shfl_xor_sync(kFull, wt, off);
      const int ok = __shfl_xor_sync(kFull, wk, off);
      const float ou = __shfl_xor_sync(kFull, bu, off);
      const float ov = __shfl_xor_sync(kFull, bv, off);
      if (ot < wt || (ot == wt && ok < wk)) {
        wt = ot;
        wk = ok;
        bu = ou;
        bv = ov;
      }
    }
    // ray ct * 8 + r: from lane 4 r
    const float t = __shfl_sync(kFull, wt, 4 * r);
    const int k = __shfl_sync(kFull, wk, 4 * r);
    const float u = __shfl_sync(kFull, bu, 4 * r);
    const float v = __shfl_sync(kFull, bv, 4 * r);
    if ((lane >> 3) == ct) {
      mt = t;
      mk = k;
      mu = u;
      mv = v;
    }
  }
  if (hit && mt < bt && mt < p.t_max) {
    bt = mt;
    slot = s0 + mk;
    wu = mu;
    wv = mv;
  }
  return bt;
}

// The warp-packet walk (Kernel A; with LEAF_MMA Kernel B's, with LEAF_NONE
// the node walk alone) of one group's nodes [root, end): walk_group's
// arguments and result, `active` false for a lane with no ray in it.
template <int kWalk, int kLeaf>
__device__ __forceinline__ float walk_packet(const Params& p, int root,
                                             int end, bool active, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float bt,
                                             int& slot, float& wu,
                                             float& wv) {
  const float eps = p.eps;
  const float ivx = inv_safe(dx, eps);
  const float ivy = inv_safe(dy, eps);
  const float ivz = inv_safe(dz, eps);
  int base = 0;
  if (p.oct_nodes)
    base = (1 + group_octant<kWalk>(active, dx, dy, dz)) * p.oct_nodes;
  float lbt = active ? bt : -kBig;
  int idx = (__any_sync(kFull, active) ? root : end) + base;
  const int stop = end + base;
  RayFrags q;
  if constexpr (kLeaf == LEAF_MMA) q = ray_frags(ox, oy, oz, dx, dy, dz);
  while (idx < stop) {  // idx is the warp's
    const float4* nd = p.nodes + (size_t)idx * kNodeVecs;
    const float4 lo = __ldg(nd), hi = __ldg(nd + 1);
    const float ax1 = (lo.x - ox) * ivx;
    const float ax2 = (hi.x - ox) * ivx;
    const float ay1 = (lo.y - oy) * ivy;
    const float ay2 = (hi.y - oy) * ivy;
    const float az1 = (lo.z - oz) * ivz;
    const float az2 = (hi.z - oz) * ivz;
    const float tmin = fmaxf(fmaxf(fminf(ax1, ax2), fminf(ay1, ay2)),
                             fminf(az1, az2));
    const float tmax = fminf(fminf(fmaxf(ax1, ax2), fmaxf(ay1, ay2)),
                             fmaxf(az1, az2));
    const bool hit = (tmin <= tmax) && (tmax > eps) && (tmin < lbt);
    const bool any = __any_sync(kFull, hit);
    if (any && lo.w >= 0.0f) {
      const int s0 = (int)lo.w;
      if constexpr (kLeaf == LEAF_SIMT) {
        if (hit)
          lbt = leaf_simt(p, s0, ox, oy, oz, dx, dy, dz, lbt, slot, wu, wv);
      } else if constexpr (kLeaf == LEAF_MMA) {
        lbt = leaf_mma(p, s0, q, hit, lbt, slot, wu, wv);
      }
    }
    idx = any ? idx + 1 : (int)hi.w;
  }
  return active ? lbt : bt;
}

// The nearest hit of a ray over the whole scene.
struct Hit {
  float t;                             // kBig when nothing is hit
  int w;                               // the winning object, -1 on a miss
  float lox, loy, loz, ldx, ldy, ldz;  // its object-space ray (0 on a
                                       // miss)
  int tri;                             // the winning triangle slot, or -1
  float tu, tv;                        // its barycentrics
};

// Row r of object row m's inverse (3x4) applied to a point and to a vector.
// Rows staged at kObjStride are 16-byte aligned, and each row of the
// inverse is one float4 load; rows staged at kObjCols (the intersect-only
// kernel's) are read a float at a time. The same products and sums in the
// same order either way.
template <int kStride>
__device__ __forceinline__ float row_point(const float* m, int r, float x,
                                           float y, float z) {
  if constexpr (kStride % 4 == 0) {
    const float4 q = reinterpret_cast<const float4*>(m)[r];
    return q.x * x + q.y * y + q.z * z + q.w;
  }
  return m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2] * z + m[4 * r + 3];
}

template <int kStride>
__device__ __forceinline__ float row_vec(const float* m, int r, float x,
                                         float y, float z) {
  if constexpr (kStride % 4 == 0) {
    const float4 q = reinterpret_cast<const float4*>(m)[r];
    return q.x * x + q.y * y + q.z * z;
  }
  return m[4 * r] * x + m[4 * r + 1] * y + m[4 * r + 2] * z;
}

// Object row m's transform of the ray into object space (the winner's,
// after nearest_hit's loop, and object_t's for the types that read it all).
template <int kStride>
__device__ __forceinline__ void object_ray(const float* m, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& tox, float& toy,
                                           float& toz, float& tdx, float& tdy,
                                           float& tdz) {
  tox = row_point<kStride>(m, 0, ox, oy, oz);
  toy = row_point<kStride>(m, 1, ox, oy, oz);
  toz = row_point<kStride>(m, 2, ox, oy, oz);
  tdx = row_vec<kStride>(m, 0, dx, dy, dz);
  tdy = row_vec<kStride>(m, 1, dx, dy, dz);
  tdz = row_vec<kStride>(m, 2, dx, dy, dz);
}

// Every object's test in table order, a GROUP's object-space box pretest
// and then its walk, the winner replaced on a strictly smaller t: the TPU
// kernels' unrolled object loop (the intersect section of _make_kernel,
// the NEE shadow loop pallas_kernel.py:2452-2498, _make_intersect_kernel
// :2741-2790). Each test transforms only what it reads: a plane its y row
// (object_ray's own operations for toy and tdy), the other types the whole
// ray. The loop keeps the winner's (t, object, slot, u, v), and the
// winner's object-space ray is computed once, after it, by object_ray: the
// same operations on the same inputs, so the same bits as a loop that
// carries every object's ray. The bounce and the intersect-only kernel
// call it, and the shadow rays of the packet walks; the per-thread shadow
// rays ask light_visible, which answers by this rule. `s_obj` is the
// object table. Under a packet walk (kWalk) every lane of the group calls
// it together, `active` false for a lane without a ray, which no walk then
// counts.
template <bool kMesh, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT,
          int kStride = kObjStride>
__device__ __forceinline__ Hit nearest_hit(const Params& p,
                                           const float* s_obj, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz,
                                           bool active = true) {
  const float eps = p.eps;
  Hit h{kBig, -1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0.f, 0.f};
  for (int j = 0; j < p.n_obj; ++j) {
    const float* m = s_obj + j * kStride;
    const int type = p.obj_types[j];
    int g_slot = -1;
    float g_u = 0.f, g_v = 0.f;
    float t;
    if (type == PLANE) {
      t = plane_t(row_point<kStride>(m, 1, ox, oy, oz),
                  row_vec<kStride>(m, 1, dx, dy, dz), eps);
    } else {
      float tox, toy, toz, tdx, tdy, tdz;
      object_ray<kStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                          tdz);
      if (type == SPHERE) {
        t = sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
      } else if (type == CYLINDER) {
        t = cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps);
      } else if (!kMesh || type == BOX) {
        // BOX, the last type a scene without groups has
        t = box_t(tox, toy, toz, tdx, tdy, tdz, eps);
      } else {
        // GROUP: object-space bbox pretest, then the walk
        t = kBig;
        float x1, x2, y1, y2, z1, z2;
        axis_slab(tox, tdx, m[34], m[37], eps, x1, x2);
        axis_slab(toy, tdy, m[35], m[38], eps, y1, y2);
        axis_slab(toz, tdz, m[36], m[39], eps, z1, z2);
        const float gtmin = fmaxf(fmaxf(x1, y1), z1);
        const float gtmax = fminf(fminf(x2, y2), z2);
        if constexpr (kWalk == WALK_THREAD) {
          if (gtmin <= gtmax && gtmax > eps && gtmin < h.t) {
            t = walk_group<kLeaf>(p, p.group_root[j], p.group_end[j], tox,
                                  toy, toz, tdx, tdy, tdz, h.t, g_slot, g_u,
                                  g_v);
          }
        } else {
          // the whole group walks (its votes), each lane active where its
          // pretest passes; an inactive lane gets h.t back
          const bool pre = active && gtmin <= gtmax && gtmax > eps &&
                           gtmin < h.t;
          t = walk_packet<kWalk, kLeaf>(p, p.group_root[j], p.group_end[j],
                                        pre, tox, toy, toz, tdx, tdy, tdz,
                                        h.t, g_slot, g_u, g_v);
        }
      }
    }
    if (t < h.t) {
      h.t = t;
      h.w = j;
      h.tri = g_slot;
      h.tu = g_u;
      h.tv = g_v;
    }
  }
  if (h.w >= 0)
    object_ray<kStride>(s_obj + h.w * kStride, ox, oy, oz, dx, dy, dz, h.lox,
                        h.loy, h.loz, h.ldx, h.ldy, h.ldz);
  return h;
}

// Object j's t for the ray, by nearest_hit's transforms and tests: a
// GROUP's box pretest against bt and then walk_group from bt with the
// any-hit exit below `cut` (kBig when the pretest fails, bt when no
// triangle wins). The type switch is nearest_hit's, kept apart: one
// function for both moved the register count of the intersect kernel's
// mesh instantiation.
template <bool kMesh, int kLeaf>
__device__ __forceinline__ float object_t(const Params& p, const float* s_obj,
                                          int j, float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float bt, float cut) {
  const float eps = p.eps;
  const float* m = s_obj + j * kObjStride;
  const int type = p.obj_types[j];
  if (type == PLANE)
    return plane_t(row_point<kObjStride>(m, 1, ox, oy, oz),
                   row_vec<kObjStride>(m, 1, dx, dy, dz), eps);
  float tox, toy, toz, tdx, tdy, tdz;
  object_ray<kObjStride>(m, ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy,
                         tdz);
  switch (type) {
    case SPHERE: return sphere_t(tox, toy, toz, tdx, tdy, tdz, eps);
    case CYLINDER:
      return cylinder_t(tox, toy, toz, tdx, tdy, tdz, m[32], m[33], eps);
    default:
      if constexpr (kMesh) {
        if (type != BOX) {
          float x1, x2, y1, y2, z1, z2;
          axis_slab(tox, tdx, m[34], m[37], eps, x1, x2);
          axis_slab(toy, tdy, m[35], m[38], eps, y1, y2);
          axis_slab(toz, tdz, m[36], m[39], eps, z1, z2);
          const float gtmin = fmaxf(fmaxf(x1, y1), z1);
          const float gtmax = fminf(fminf(x2, y2), z2);
          if (!(gtmin <= gtmax && gtmax > eps && gtmin < bt)) return kBig;
          int slot;
          float u, v;
          return walk_group<kLeaf, true>(p, p.group_root[j], p.group_end[j],
                                         tox, toy, toz, tdx, tdy, tdz, bt,
                                         slot, u, v, cut);
        }
      }
      return box_t(tox, toy, toz, tdx, tdy, tdz, eps);
  }
}

// The shadow ray's query on the per-thread walk: whether light l is the
// ray's nearest hit, with eps < t < t_max, and at what t (t_l, for the
// attenuation). nearest_hit replaces its winner on a strictly smaller t in
// table order, so l wins exactly when eps < t_l < t_max, t_l < kBig, no
// object j < l has t_j <= t_l and no object j > l has t_j < t_l; every t_j
// is nearest_hit's value, so the answer is its answer bit for bit. A
// primitive light is tested first and a missed light ends the query; then
// the others in table order, the first occluder ending it (t_j < cut, with
// cut = the float after t_l before l, t_l after it). A GROUP before l
// pretests and walks from the running minimum of the objects before it, as
// in nearest_hit, not from t_l: the walk's node pruning (tmin < bt) must
// see nearest_hit's bt; its any-hit exit below cut decides the query
// without changing what the walk tests before it. A GROUP light (none of
// the repository's scenes has one) is walked in its place in the table.
// The light's own test is the loop's iteration -1, so object_t has one
// call site and one walk is inlined.
template <bool kMesh, int kLeaf>
__device__ __forceinline__ bool light_visible(const Params& p,
                                              const float* s_obj, int l,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& t_l) {
  const float eps = p.eps;
  const bool group_light = kMesh && p.obj_types[l] == GROUP;
  float tl = kBig, cut = -kBig;
  float bt = kBig;  // the running minimum before l; tl from l on
  for (int k = group_light ? 0 : -1; k < p.n_obj; ++k) {
    if (k == l && !group_light) {
      bt = tl;
      cut = tl;
      continue;
    }
    const float t = object_t<kMesh, kLeaf>(p, s_obj, k < 0 ? l : k, ox, oy,
                                           oz, dx, dy, dz, bt,
                                           k == l ? -kBig : cut);
    if (k < 0) {
      if (!(t > eps && t < p.t_max && t < kBig)) return false;
      tl = t;
      cut = nextafterf(t, kBig);  // t_j <= tl exactly when t_j < cut
    } else if (k == l) {  // the GROUP light
      if (!(t < bt && t > eps && t < p.t_max)) return false;
      tl = t;
      bt = t;
      cut = t;
    } else {
      if (t < cut) return false;
      if (t < bt) bt = t;
    }
  }
  t_l = tl;
  return true;
}

// The sine and cosine of one of the light point's angles, by one sincosf.
// The plain version takes torch.sin and torch.cos (sinf and cosf on the
// card); sincos_check holds this to them on every f32 of the angles'
// ranges, latitude [-2 pi, -pi] and longitude [0, 2 pi).
__device__ __forceinline__ void light_sincos(float a, float& s, float& c) {
  sincosf(a, &s, &c);
}

// acos(x) = atan2(sqrt(1 - x^2), x) for x in [-1, 1], by the polynomial
__device__ __forceinline__ float acos_poly(float x) {
  return atan2_poly(sqrtf(fmaxf((1.0f - x) * (1.0f + x), 0.0f)), x);
}

// kF32 (with kTex): fetch from the f32 texels, not the rgb8 pool.
// kNee (forward only, not kF32): next-event estimation toward p.light_idx.
// kWalk, kLeaf (kMesh only): the mesh walk. Under a packet walk
// (WALK_BLOCK, WALK_WARP) the group's lanes call nearest_hit together, so
// the bounce loop runs until the group's last path ends (the TPU tile's
// per-tile exit), a lane whose path ended riding along inactive (`live`
// false: its sums and, under kGrad, its tape no longer change), and every
// light's shadow walk is called by every lane, active where the lane casts
// that shadow ray.
// The forward kernels (megakernel) and the gradient kernels
// (grad_megakernel) run this body.
template <bool kMesh, bool kGrad, bool kTex, bool kF32 = false,
          bool kNee = false, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT>
__device__ __forceinline__ void megakernel_body(const Params& p) {
  constexpr bool kPacket = kWalk != WALK_THREAD;
  extern __shared__ __align__(16) float smem[];
  float* s_obj = smem;
  float* s_cam = s_obj + p.n_obj * kObjStride;
  float* s_g = s_cam + kCamCols;  // kGrad: the block's [n_obj, 6] sums
  // kTex: the texture table, after the sums when both are there
  float* s_tex = s_g + (kGrad ? p.n_obj * kGradCols : 0);
  for (int i = threadIdx.x; i < p.n_obj * kObjStride; i += blockDim.x) {
    const int o = i / kObjStride, c = i - o * kObjStride;
    s_obj[i] = c < kObjCols ? p.obj[o * kObjCols + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) s_cam[i] = p.cam[i];
  if constexpr (kGrad) {
    for (int i = threadIdx.x; i < p.n_obj * kGradCols; i += blockDim.x)
      s_g[i] = 0.0f;
  }
  if constexpr (kTex) {
    for (int i = threadIdx.x; i < p.n_obj * kTexRow; i += blockDim.x) {
      const int o = i / kTexRow, c = i - o * kTexRow;
      const float* row = p.tex_table + o * kTexCols;
      // columns 12-15 divide by columns 2, 3 (w, h) and 8, 9 (nm w, h)
      s_tex[i] = c < kTexCols
                     ? row[c]
                     : 1.0f / row[2 + (c - kTexRecip) % 2 +
                                  6 * ((c - kTexRecip) / 2)];
    }
  }
  __syncthreads();

  // kGrad launches whole blocks only, so no thread of it returns here and
  // every one reaches the barrier before the block's gradient flush
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!kPacket) {
    if (idx >= p.n_slots) return;
  }
  // kPacket: every thread stays for the group's votes; one past the last
  // slot (its reads clamped to it) never goes live and writes nothing
  const bool in_range = idx < p.n_slots;
  const int sidx = kPacket ? min(idx, p.n_slots - 1) : idx;
  float cot_r = 0.f, cot_g = 0.f, cot_b = 0.f;
  if constexpr (kGrad) {
    cot_r = p.cot_r[idx];
    cot_g = p.cot_g[idx];
    cot_b = p.cot_b[idx];
  }
  uint32_t key, elem, u_elem;
  {
    // (row, lane) are recomputed from idx where needed, not kept live
    const int row = idx / p.L;
    const int lane = idx - row * p.L;
    const int r0 = row % p.S;
    key = tile_key(p.seed, (uint32_t)(row / p.S));
    elem = (uint32_t)(r0 * p.L + lane);
    // coherent sampling (PT_COHERENT=1): roulette and hemisphere draws are
    // shared by a tile row (lane 0 of the row), or, when the sample
    // replicas run along the lane chunks, by a 128-lane chunk (lane c*128
    // of row 0)
    u_elem = !p.coherent ? elem
             : (p.chunk_axis && p.L >= 128) ? (uint32_t)((lane / 128) * 128)
                                            : (uint32_t)(r0 * p.L);
  }
  const float eps = p.eps;

  const float fx = (float)p.px[sidx];
  const float fy = (float)p.py[sidx];
  const float pixel_size = s_cam[12], half_w = s_cam[13], half_h = s_cam[14];
  const float aperture = s_cam[15], focal = s_cam[16];
  const float oxw = s_cam[3], oyw = s_cam[7], ozw = s_cam[11];

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int n = 0; n < p.waves; ++n) {
    // ---- rayForPixel (tracer.cl:745-779) ----------------------------------
    const float jx = hash_uniform(key, elem, 0u, (uint32_t)n, 0u);
    const float jy = hash_uniform(key, elem, 1u, (uint32_t)n, 0u);
    const float vx = half_w - pixel_size * (fx + jx);
    const float vy = half_h - pixel_size * (fy + jy);
    const float vz = -1.0f;
    float dx = (s_cam[0] * vx + s_cam[1] * vy + s_cam[2] * vz + s_cam[3]) - oxw;
    float dy = (s_cam[4] * vx + s_cam[5] * vy + s_cam[6] * vz + s_cam[7]) - oyw;
    float dz = (s_cam[8] * vx + s_cam[9] * vy + s_cam[10] * vz + s_cam[11]) - ozw;
    normalize3(dx, dy, dz);
    float ox = oxw, oy = oyw, oz = ozw;
    if (aperture != 0.0f) {
      // DoF via sunflower(totalSamples, alpha=2, global sample index): the
      // slot's sample replica rep counts n*spp_pack + rep + sample base
      const int row = idx / p.L;
      const int rep = p.chunk_axis ? (idx - row * p.L) / (p.L / p.spp_pack)
                                   : (row % p.S) / (p.S / p.spp_pack);
      const float nf = (float)(n * p.spp_pack + rep + p.sample_base);
      const float r_sun =
          nf <= p.sun_cut ? sqrtf(fmaxf(nf - 0.5f, 0.0f)) / p.sun_den : 1.0f;
      const float theta = (kTwoPi * nf) / p.golden2;
      const float sun_x = r_sun * cosf(theta);
      const float sun_y = r_sun * sinf(theta);
      const float fpx = oxw + dx * focal;
      const float fpy = oyw + dy * focal;
      const float fpz = ozw + dz * focal;
      ox = oxw + sun_y * aperture;  // the reference swaps x/y
      oy = oyw + sun_x * aperture;
      dx = fpx - ox;
      dy = fpy - oy;
      dz = fpz - oz;
    }

    float mask_r = 1.0f, mask_g = 1.0f, mask_b = 1.0f;
    float sr = 0.0f, sg = 0.0f, sb = 0.0f;
    bool inside = false;
    int n_hits = 0, eff = 0;
    // kGrad: this sample's tape of contributing bounces. t_id is the
    // winning object, or -1 - slot for a mesh hit; bit k of upd_bits says
    // that entry k updated the mask
    int t_id[kMaxTape];
    float t_cos[kMaxTape], t_m[3 * kMaxTape], t_c[3 * kMaxTape];
    float t_u[kMaxTape], t_v[kMaxTape];  // kTex: the color fetch's (u, v)
    int nb = 0;
    uint32_t upd_bits = 0u;
    bool direct = false;
    bool live = in_range;  // kPacket: the path has not ended
    for (int b = 0; b < p.max_bounces; ++b) {
      if constexpr (kPacket) {
        if (!group_any<kWalk>(live)) break;
      }
      // ---- intersect: nearest object -------------------------------------
      const Hit hit = nearest_hit<kMesh, kWalk, kLeaf>(p, s_obj, ox, oy, oz,
                                                       dx, dy, dz, live);
      // a miss ends the path with nothing added (every update is gated on
      // alive & hit_ok in the TPU kernel)
      if constexpr (kPacket) {
        live = live && hit.t < p.t_max;
      } else {
        if (!(hit.t < p.t_max)) break;
      }
      const float t = hit.t;
      const int w = kPacket ? max(hit.w, 0) : hit.w;
      const int tri = hit.tri;  // winning triangle slot when a group wins
      const float tu = hit.tu, tv = hit.tv;
      const float* wm = s_obj + w * kObjStride;
      const int w_type = p.obj_types[w];
      const bool on_tri = kMesh && tri >= 0;

      // ---- surface normal by type (tracer.cl:903-950) ---------------------
      const float lx = hit.lox + hit.ldx * t;
      const float ly = hit.loy + hit.ldy * t;
      const float lz = hit.loz + hit.ldz * t;
      float nlx, nly, nlz;
      float tcr = 0.f, tcg = 0.f, tcb = 0.f;
      if (on_tri) {
        // the smooth normal and the triangle's color
        tri_shading(p, tri, tu, tv, nlx, nly, nlz, tcr, tcg, tcb);
      } else if (w_type == PLANE) {
        nlx = 0.0f; nly = 1.0f; nlz = 0.0f;
      } else if (w_type == CYLINDER) {
        const float dist = lx * lx + lz * lz;
        const bool top = (dist < 1.0f) && (ly >= wm[33] - eps);
        const bool bot = (dist < 1.0f) && (ly <= wm[32] + eps);
        nlx = (top || bot) ? 0.0f : lx;
        nly = top ? 1.0f : (bot ? -1.0f : 0.0f);
        nlz = (top || bot) ? 0.0f : lz;
      } else if (w_type == BOX) {
        const float ax = fabsf(lx), ay = fabsf(ly), az = fabsf(lz);
        const float maxc = fmaxf(fmaxf(ax, ay), az);
        const bool sel_x = maxc == ax;
        const bool sel_y = !sel_x && (maxc == ay);
        nlx = sel_x ? lx : 0.0f;
        nly = sel_y ? ly : 0.0f;
        nlz = (sel_x || sel_y) ? 0.0f : lz;
      } else {
        nlx = lx; nly = ly; nlz = lz;
      }
      // the color: the triangle's, the texel's, or the object row's (read
      // where it is used, below)
      bool own_col = on_tri;
      float tex_u = 0.f, tex_v = 0.f;  // kGrad: the color fetch's (u, v)
      if constexpr (kTex) {
        // the winner's texture row (none for a triangle hit): its normal
        // map (a plane's: the texel is the object-space normal, normalized
        // after the inverse-transpose, tracer.cl:907-911), then its color
        // texture (tracer.cl:1075-1093) by the UV map of the type. Two
        // inlined fetches: one call site for both in a loop (#pragma unroll
        // 1) ran K1-tex 7% slower on `textures` (PERF.md §6, R3).
        const float* tt = s_tex + w * kTexRow;
        if (!on_tri && tt[6] > 0.5f) {
          fetch_texture<kF32>(p, tt + 7, tt[kTexRecip + 2],
                              tt[kTexRecip + 3], fabsf(lx) * tt[10],
                              fabsf(lz) * tt[11], nlx, nly, nlz);
        }
        if (!on_tri && tt[0] > 0.5f) {
          float su, sv;
          if (w_type == PLANE) {
            su = lx * tt[4];
            sv = lz * tt[5];
          } else if (w_type == SPHERE) {
            spherical_uv(lx, ly, lz, su, sv);
          } else {
            cube_uv(lx, ly, lz, su, sv);
          }
          fetch_texture<kF32>(p, tt + 1, tt[kTexRecip], tt[kTexRecip + 1],
                              su, sv, tcr, tcg, tcb);
          own_col = true;
          if constexpr (kGrad) {
            tex_u = su;
            tex_v = sv;
          }
        }
      }
      float nx = wm[12] * nlx + wm[13] * nly + wm[14] * nlz;
      float ny = wm[16] * nlx + wm[17] * nly + wm[18] * nlz;
      float nz = wm[20] * nlx + wm[21] * nly + wm[22] * nlz;
      normalize3(nx, ny, nz);
      const float ex = -dx, ey = -dy, ez = -dz;
      if (dot3(ex, ey, ez, nx, ny, nz) < 0.0f) {
        nx = -nx; ny = -ny; nz = -nz;
      }

      // ---- material roulette (tracer.cl:982-1061) -------------------------
      const uint32_t un = (uint32_t)n, ub = (uint32_t)b;
      const float u_refl = hash_uniform(key, u_elem, 2u, un, ub);
      const float u_schl = hash_uniform(key, u_elem, 3u, un, ub);
      const float u1 = hash_uniform(key, u_elem, 4u, un, ub);
      const float u2 = hash_uniform(key, u_elem, 5u, un, ub);
      const float refr = wm[30], refl = wm[31];
      const float wx = ox + dx * t, wy = oy + dy * t, wz = oz + dz * t;

      const bool do_reflect = (refl != 0.0f) && (u_refl < refl);
      const bool thin = !do_reflect && (refr == -1.0f);
      bool thin_pass = false, thin_reflect = false;
      if (thin) {
        thin_pass = schlick(ex, ey, ez, nx, ny, nz, 1.0f, 1.5f) < u_schl;
        thin_reflect = !thin_pass;
      }
      const bool solid = !do_reflect && !thin && (refr != 1.0f);
      const bool outside = !inside;
      bool do_refract = false, solid_reflect = false;
      float rfx = 0.f, rfy = 0.f, rfz = 0.f;
      if (solid) {
        const float n1 = outside ? 1.0f : refr;
        const float n2 = outside ? refr : 1.0f;
        do_refract = schlick(ex, ey, ez, nx, ny, nz, n1, n2) < u_schl;
        solid_reflect = !do_refract;
        if (do_refract) refract(ex, ey, ez, nx, ny, nz, n1, n2, rfx, rfy, rfz);
      }
      const bool diffuse = !do_reflect && !thin && !solid;
      const bool any_reflect = do_reflect || thin_reflect || solid_reflect;

      float ndx, ndy, ndz, cosw = 1.0f;
      if (any_reflect) {
        const float ddn = 2.0f * dot3(dx, dy, dz, nx, ny, nz);
        ndx = dx - nx * ddn;
        ndy = dy - ny * ddn;
        ndz = dz - nz * ddn;
      } else if (thin_pass) {
        ndx = dx; ndy = dy; ndz = dz;
      } else if (do_refract) {
        ndx = rfx; ndy = rfy; ndz = rfz;
      } else {
        // cosine-weighted hemisphere (tracer.cl:348-366)
        const float rand1 = kTwoPi * u1;
        const float rand2s = sqrtf(u2);
        const bool pick = fabsf(nx) > 0.1f;
        const float axx = pick ? 0.0f : 1.0f;
        const float axy = pick ? 1.0f : 0.0f;
        float ux = axy * nz, uy = -(axx * nz), uz = axx * ny - axy * nx;
        normalize3(ux, uy, uz);
        const float vx2 = ny * uz - nz * uy;
        const float vy2 = nz * ux - nx * uz;
        const float vz2 = nx * uy - ny * ux;
        const float cu = cosf(rand1) * rand2s;
        const float cv = sinf(rand1) * rand2s;
        const float cn = sqrtf(1.0f - u2);
        ndx = ux * cu + vx2 * cv + nx * cn;
        ndy = uy * cu + vy2 * cv + ny * cn;
        ndz = uz * cu + vz2 * cv + nz * cn;
        cosw = dot3(ndx, ndy, ndz, nx, ny, nz);
      }
      const bool go_under = thin_pass || do_refract;

      // ---- fold resolve forward (tracer.cl:1116-1176) ---------------------
      // mesh hits emit nothing (tracer.cl:672-673) and take the triangle's
      // color; the object row is read here, where it is used, so the
      // primitive instantiation keeps no more values live than before
      const float emi_r = on_tri ? 0.0f : wm[27];
      const bool is_light = emi_r > 0.0f;
      if constexpr (kGrad) {
        if (!do_refract && (!kPacket || live)) {
          // tape entry (pallas_grad.py:755-778): the winner, cos, the mask
          // before this bounce's update and the color that updates it
          t_id[nb] = on_tri ? -1 - tri : w;
          t_cos[nb] = cosw;
          t_m[3 * nb] = mask_r;
          t_m[3 * nb + 1] = mask_g;
          t_m[3 * nb + 2] = mask_b;
          t_c[3 * nb] = own_col ? tcr : wm[24];
          t_c[3 * nb + 1] = own_col ? tcg : wm[25];
          t_c[3 * nb + 2] = own_col ? tcb : wm[26];
          if constexpr (kTex) {
            t_u[nb] = tex_u;
            t_v[nb] = tex_v;
          }
          if (!is_light) upd_bits |= 1u << nb;
          direct = is_light && n_hits == 0;
          ++nb;
        }
      }
      // kPacket: every lane enters (the shadow walks' votes); `res` says
      // whether this bounce resolves into the sums
      if (kPacket || !do_refract) {
        const bool res = !kPacket || (live && !do_refract);
        if (res) {
          sr = sr + mask_r * emi_r;
          sg = sg + mask_g * (on_tri ? 0.0f : wm[28]);
          sb = sb + mask_b * (on_tri ? 0.0f : wm[29]);
        }
        if constexpr (kNee) {
          // ---- next-event estimation (pallas_kernel.py:2421-2513) -------
          // nee_cond: a surface hit that neither refracts nor is a light.
          // The estimator is the reference's: biased, since a BSDF ray
          // that hits a light is not discounted by the shadow test
          if (kPacket || !is_light) {
            const float cr = own_col ? tcr : wm[24];
            const float cg = own_col ? tcg : wm[25];
            const float cb = own_col ? tcb : wm[26];
            for (int li = 0; li < p.n_lights; ++li) {
              const int l = p.light_idx[li];
              const float* lm = s_obj + l * kObjStride;
              const float nu1 = hash_uniform(key, u_elem, 6u + 2u * li, un, ub);
              const float nu2 = hash_uniform(key, u_elem, 7u + 2u * li, un, ub);
              // randomPointOnSphere (tracer.cl:321-336) kept verbatim,
              // its latitude offset and y term included
              const float lat = acos_poly(2.0f * nu1 - 1.0f) - kTwoPi;
              const float lon = kTwoPi * nu2;
              float sla, cl, slo, clo;
              light_sincos(lat, sla, cl);
              light_sincos(lon, slo, clo);
              const float lpx = lm[40] + cl * clo * lm[43];
              const float lpy = lm[41] + (sla - kQuarterPi) * lm[43];
              const float lpz = lm[42] + cl * slo * lm[43];
              float sdx = lpx - wx, sdy = lpy - wy, sdz = lpz - wz;
              normalize3(sdx, sdy, sdz);
              const float ldn = dot3(sdx, sdy, sdz, nx, ny, nz);
              // a light behind the surface adds nothing whatever the
              // shadow ray hits: it is not cast
              if constexpr (!kPacket) {
                if (!(ldn > 0.0f)) continue;
              }
              bool lit;
              float st = 0.0f;
              if constexpr (kPacket) {
                // every lane walks (the votes); a per-lane early exit
                // would leave the group's collectives
                const bool cast = res && !is_light && ldn > 0.0f;
                const Hit s = nearest_hit<kMesh, kWalk, kLeaf>(
                    p, s_obj, wx + sdx * eps, wy + sdy * eps, wz + sdz * eps,
                    sdx, sdy, sdz, cast);
                lit = cast && s.w == l && s.t > eps && s.t < p.t_max;
                st = s.t;
              } else {
                lit = light_visible<kMesh, kLeaf>(
                    p, s_obj, l, wx + sdx * eps, wy + sdy * eps,
                    wz + sdz * eps, sdx, sdy, sdz, st);
              }
              if (lit) {
                const float sxl = lm[44];
                const float atten = 1.0f - st / sqrtf(st * st + sxl * sxl);
                const float w_nee = ldn * atten;
                sr = sr + mask_r * cr * lm[27] * w_nee;
                sg = sg + mask_g * cg * lm[28] * w_nee;
                sb = sb + mask_b * cb * lm[29] * w_nee;
              }
            }
          }
        }
        if (res && is_light && n_hits == 0) {
          // a direct light hit returns the light's color (a textured
          // emitter's texel: the env-map sky sphere and cube)
          if constexpr (kTex) {
            sr = own_col ? tcr : wm[24];
            sg = own_col ? tcg : wm[25];
            sb = own_col ? tcb : wm[26];
          } else {
            sr = wm[24]; sg = wm[25]; sb = wm[26];
          }
        }
        if (res && !is_light) {
          mask_r = mask_r * (own_col ? tcr : wm[24]) * cosw;
          mask_g = mask_g * (own_col ? tcg : wm[25]) * cosw;
          mask_b = mask_b * (own_col ? tcb : wm[26]) * cosw;
        }
      }
      if (!do_refract && !any_reflect) eff += 1;
      n_hits += 1;
      if (go_under) {
        ox = wx - nx * eps; oy = wy - ny * eps; oz = wz - nz * eps;
      } else {
        ox = wx + nx * eps; oy = wy + ny * eps; oz = wz + nz * eps;
      }
      dx = ndx; dy = ndy; dz = ndz;
      if (do_refract) inside = outside;
      if constexpr (kPacket) {
        live = live && !(is_light || eff >= p.max_eff);
      } else {
        if (is_light || eff >= p.max_eff) break;
      }
    }
    if constexpr (kGrad) {
      // ---- this sample's backward pass (pallas_grad.py:806-939) --------
      // The warp walks its lanes' tapes backwards together, to the longest
      // (a lane past its own end adds nothing), so that at each step the
      // lanes that add into one target (an object's six sums, a
      // triangle's row) are merged first and the group's lowest lane adds
      // once: into the shared sums, or by one vector atomic into gtri. A
      // direct light hit (the tape's one entry) overwrote the sum with the
      // light's color: that color alone has a gradient, cot (a textured
      // light's: its texels).
      const unsigned lanes = __activemask();
      const int steps = (int)__reduce_max_sync(lanes, (unsigned)nb);
      float T_r = 0.0f, T_g = 0.0f, T_b = 0.0f;
      for (int k = steps - 1; k >= 0; --k) {
        int key = kNoTarget;
        float v[kGradCols] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (k < nb) {
          const int id = t_id[k];
          const bool upd = (upd_bits >> k) & 1u;
          const float cosb = t_cos[k];
          const float mr = t_m[3 * k], mg = t_m[3 * k + 1],
                      mb = t_m[3 * k + 2];
          // dS/dc of this bounce's color, where it has one
          bool col = direct || upd;
          float gr = cot_r, gg = cot_g, gb = cot_b;
          if (!direct) {
            gr = cot_r * cosb * mr * T_r;
            gg = cot_g * cosb * mg * T_g;
            gb = cot_b * cosb * mb * T_b;
          }
          if constexpr (kTex) {
            if (id >= 0) {
              // a textured winner's color is its texel: the gradient goes
              // to the texels when they train, else nowhere
              const float* tt = s_tex + id * kTexRow;
              if (col && ((p.tex_train >> id) & 1ull))
                scatter_texels(p.gtex, p.n_texels, tt, t_u[k], t_v[k], gr,
                               gg, gb);
              if (tt[0] > 0.5f) col = false;
            }
          }
          if (id >= 0) {
            key = id;
            if (col) {
              v[0] = gr;
              v[1] = gg;
              v[2] = gb;
            }
            if (!direct) {
              v[3] = cot_r * mr;
              v[4] = cot_g * mg;
              v[5] = cot_b * mb;
            }
          } else if (col && p.gtri != nullptr) {
            key = id;
            v[0] = gr;
            v[1] = gg;
            v[2] = gb;
          }
          if (!direct && k > 0) {
            // T for the entry before (none after entry 0)
            float er = 0.0f, eg = 0.0f, eb = 0.0f;
            if (id >= 0) {
              er = s_obj[id * kObjStride + 27];
              eg = s_obj[id * kObjStride + 28];
              eb = s_obj[id * kObjStride + 29];
            }
            const float sc_r = upd ? t_c[3 * k] * cosb : 1.0f;
            const float sc_g = upd ? t_c[3 * k + 1] * cosb : 1.0f;
            const float sc_b = upd ? t_c[3 * k + 2] * cosb : 1.0f;
            T_r = er + sc_r * T_r;
            T_g = eg + sc_g * T_g;
            T_b = eb + sc_b * T_b;
          }
        }
        if (warp_sum(lanes, key, v) && key != kNoTarget) {
          if (key >= 0) {
            float* g = s_g + key * kGradCols;
#pragma unroll
            for (int i = 0; i < kGradCols; ++i) add_nonzero(g + i, v[i]);
          } else {
            add_rgb(p.gtri + (size_t)(-1 - key) * 4, v[0], v[1], v[2]);
          }
        }
      }
    }
    acc_r = acc_r + sr;
    acc_g = acc_g + sg;
    acc_b = acc_b + sb;
  }
  if constexpr (kGrad) {
    // the block's per-object sums: one global add per nonzero entry
    __syncthreads();
    for (int i = threadIdx.x; i < p.n_obj * kGradCols; i += blockDim.x)
      add_nonzero(p.gobj + i, s_g[i]);
  } else {
    if constexpr (kPacket) {
      if (!in_range) return;
    }
    p.out_r[idx] = acc_r;
    p.out_g[idx] = acc_g;
    p.out_b[idx] = acc_b;
  }
}

template <bool kMesh, bool kGrad, bool kTex, bool kF32 = false,
          bool kNee = false, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT>
__global__ void __launch_bounds__(kThreads) megakernel(Params p) {
  megakernel_body<kMesh, kGrad, kTex, kF32, kNee, kWalk, kLeaf>(p);
}

// The gradient kernels: at least kGradBlocks blocks an SM, so at most 64
// registers a thread, on every walk. The replay's tape and atomics want the
// warps more than the registers: with the 16-byte records ptxas chose 80
// and K6 in triangle mode ran 13% slower. (A minimum of 1 for the forward
// kernels is not the default: ptxas then takes 90-110 registers and they
// run 5-10% slower.) kWalk, kLeaf: the mesh walks of WalkLaunch.
constexpr int kGradBlocks = 8;
template <bool kMesh, bool kTex, bool kF32, int kWalk = WALK_THREAD,
          int kLeaf = LEAF_SIMT>
__global__ void __launch_bounds__(kGradThreads, kGradBlocks)
    grad_megakernel(Params p) {
  megakernel_body<kMesh, true, kTex, kF32, false, kWalk, kLeaf>(p);
}

// Point the launch parameters at the mesh tables (node, triangle test and
// shading records); false unless each base is 16-byte aligned, as the
// float4 loads need.
bool set_tables(Params& p, const float* nodes, const float* tris,
                const float* shade) {
  const auto misaligned = [](const float* a) {
    return reinterpret_cast<uintptr_t>(a) % 16 != 0;
  };
  if (misaligned(nodes) || misaligned(tris) || misaligned(shade))
    return false;
  p.nodes = reinterpret_cast<const float4*>(nodes);
  p.tris = reinterpret_cast<const float4*>(tris);
  p.shade = reinterpret_cast<const float4*>(shade);
  return true;
}

// Copy the host type codes and group ranges into the launch parameters
// and launch the instantiation the scene needs (kMesh when it has a GROUP,
// kTex when the caller passed a texel pool or f32 texels, kF32 for the
// latter, kNee for next-event estimation).
bool copy_objects(Params& p, const int* obj_types, const int* group_root,
                  const int* group_end) {
  bool mesh = false;
  for (int i = 0; i < p.n_obj; ++i) {
    p.obj_types[i] = obj_types[i];
    p.group_root[i] = group_root[i];
    p.group_end[i] = group_end[i];
    mesh = mesh || obj_types[i] == GROUP;
  }
  return mesh;
}

// Run f.run<kWalk, kLeaf>() for a mesh walk other than the per-thread walk
// with SIMT leaves, by (walk, leaf) code: the ones the JAX package's knobs
// select (render/megakernel.py mesh_walk).
template <class F>
int launch_walk(int walk, int leaf, const F& f) {
  switch (walk * 3 + leaf) {
    case WALK_THREAD * 3 + LEAF_NONE:
      return f.template run<WALK_THREAD, LEAF_NONE>();
    case WALK_BLOCK * 3 + LEAF_SIMT:
      return f.template run<WALK_BLOCK, LEAF_SIMT>();
    case WALK_BLOCK * 3 + LEAF_MMA:
      return f.template run<WALK_BLOCK, LEAF_MMA>();
    case WALK_BLOCK * 3 + LEAF_NONE:
      return f.template run<WALK_BLOCK, LEAF_NONE>();
    case WALK_WARP * 3 + LEAF_SIMT:
      return f.template run<WALK_WARP, LEAF_SIMT>();
    case WALK_WARP * 3 + LEAF_NONE:
      return f.template run<WALK_WARP, LEAF_NONE>();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The megakernel (kGrad: the gradient kernel) of a mesh scene on a walk of
// launch_walk. The gradient kernel takes the walks the JAX gradient
// kernel's knobs select (render/megakernel.py grad_walk: the block walk
// with SIMT leaves or none, the per-thread walk without leaf tests): the
// warp walk and the tensor-core leaves are the forward's alone. The
// f32-texel forward (the texel gradients' primal) takes every walk but
// the tensor-core leaves, which the differentiable render refuses.
template <bool kGrad, bool kTex, bool kF32, bool kNee>
struct WalkLaunch {
  const Params& p;
  size_t smem;
  int blocks;
  cudaStream_t stream;
  template <int kWalk, int kLeaf>
  int run() const {
    if constexpr ((kLeaf == LEAF_MMA && (kGrad || kF32)) ||
                  (kGrad && kWalk == WALK_WARP)) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (blocks > 0) {
        if constexpr (kGrad)
          grad_megakernel<true, kTex, kF32, kWalk, kLeaf>
              <<<blocks, kGradThreads, smem, stream>>>(p);
        else
          megakernel<true, false, kTex, kF32, kNee, kWalk, kLeaf>
              <<<blocks, kThreads, smem, stream>>>(p);
      }
      return (int)cudaGetLastError();
    }
  }
};

// Launch the instantiation p's scene needs on the mesh walk (walk, leaf):
// the per-thread walk with SIMT leaves (the only one of a scene without a
// GROUP) here, any other through launch_walk (WalkLaunch).
template <bool kGrad, bool kTex, bool kF32 = false, bool kNee = false>
int launch(Params& p, const int* obj_types, const int* group_root,
           const int* group_end, void* stream, int walk = WALK_THREAD,
           int leaf = LEAF_SIMT) {
  const bool mesh = copy_objects(p, obj_types, group_root, group_end);
  const size_t smem =
      sizeof(float) * (size_t)(p.n_obj * (kObjStride +
                                          (kGrad ? kGradCols : 0) +
                                          (kTex ? kTexRow : 0)) +
                               kCamCols);
  const int threads = kGrad ? kGradThreads : kThreads;
  const int blocks = (p.n_slots + threads - 1) / threads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (walk != WALK_THREAD || leaf != LEAF_SIMT) {
    if (!mesh)
      return (int)cudaErrorInvalidValue;  // the walks are for meshes
    return launch_walk(walk, leaf,
                       WalkLaunch<kGrad, kTex, kF32, kNee>{p, smem, blocks,
                                                           s});
  }
  if (blocks > 0) {
    if constexpr (kGrad) {
      if (mesh)
        grad_megakernel<true, kTex, kF32><<<blocks, threads, smem, s>>>(p);
      else
        grad_megakernel<false, kTex, kF32><<<blocks, threads, smem, s>>>(p);
    } else {
      if (mesh)
        megakernel<true, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
      else
        megakernel<false, false, kTex, kF32, kNee>
            <<<blocks, kThreads, smem, s>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

// The intersect-only kernel's rays: six f32 [n] inputs, the f32 outputs
// [13, n] (t, object-space origin xyz and direction xyz, the triangle
// normal xyz and color rgb; [7, n] on a scene without groups) and the
// winners, i32 [n].
struct Rays {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  float* out;
  int* idx;
  int n;
};

// The intersect-only kernel's triangle outputs, beside struct Rays (which
// the leaf microbenchmark shares): the winning triangle's slot, i32 [n]
// (-1 unless a triangle won: the wavefront's autograd gathers the
// triangle's color by it, so that the color carries a gradient), and
// whether a triangle won, one byte a ray (0 or 1, which the wrapper views
// as bool).
struct TriOut {
  int* slot;
  uint8_t* is_tri;
};

// Ray i: nearest_hit, then the outputs of _make_intersect_kernel
// (pallas_kernel.py:2792-2806) and, on a scene with groups, the triangle
// outputs (a scene without them has none to store: its triangle normal,
// color, slot and flag are constants, which the wrapper returns as views
// of one value). Under a packet walk every thread of the block calls
// nearest_hit, one past the last ray inactive.
template <bool kMesh, int kWalk, int kLeaf>
__device__ __forceinline__ void intersect_ray(const Params& p, const Rays& r,
                                              const TriOut& tri,
                                              const float* s_obj, int i) {
  constexpr bool kPacket = kWalk != WALK_THREAD;
  const int si = kPacket ? min(i, r.n - 1) : i;
  const float ray[6] = {r.ox[si], r.oy[si], r.oz[si],
                        r.dx[si], r.dy[si], r.dz[si]};
  const Hit h = nearest_hit<kMesh, kWalk, kLeaf, kObjCols>(
      p, s_obj, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], i < r.n);
  if (i >= r.n) return;
  const bool miss = h.w < 0;
  float nrm[3] = {0.f, 0.f, 0.f}, col[3] = {0.f, 0.f, 0.f};
  const bool on_tri = kMesh && h.tri >= 0;
  if (on_tri)
    tri_shading(p, h.tri, h.tu, h.tv, nrm[0], nrm[1], nrm[2], col[0], col[1],
                col[2]);
  const size_t n = (size_t)r.n;
  float* o = r.out + i;
  o[0] = fminf(h.t, p.t_max);
  // the winner's object-space ray, or the world ray on a miss
  o[n] = miss ? ray[0] : h.lox;
  o[2 * n] = miss ? ray[1] : h.loy;
  o[3 * n] = miss ? ray[2] : h.loz;
  o[4 * n] = miss ? ray[3] : h.ldx;
  o[5 * n] = miss ? ray[4] : h.ldy;
  o[6 * n] = miss ? ray[5] : h.ldz;
  r.idx[i] = miss ? 0 : h.w;
  if constexpr (kMesh) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[(7 + k) * n] = nrm[k];
      o[(10 + k) * n] = col[k];
    }
    tri.slot[i] = on_tri ? h.tri : -1;
    tri.is_tri[i] = on_tri ? 1 : 0;
  }
}

// One thread a ray, the object rows staged in shared memory as they are
// (45 floats a row) by each block.
template <bool kMesh, int kWalk = WALK_THREAD, int kLeaf = LEAF_SIMT>
__global__ void __launch_bounds__(kThreads) intersect(Params p, Rays r,
                                                      TriOut tri) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < p.n_obj * kObjCols; i += blockDim.x)
    smem[i] = p.obj[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (kWalk == WALK_THREAD && i >= r.n) return;
  intersect_ray<kMesh, kWalk, kLeaf>(p, r, tri, smem, i);
}

// The intersect-only kernel on a walk of launch_walk.
struct IntersectLaunch {
  const Params& p;
  const Rays& r;
  const TriOut& tri;
  size_t smem;
  cudaStream_t stream;
  template <int kWalk, int kLeaf>
  int run() const {
    const int blocks = (r.n + kThreads - 1) / kThreads;
    if (blocks > 0)
      intersect<true, kWalk, kLeaf><<<blocks, kThreads, smem, stream>>>(
          p, r, tri);
    return (int)cudaGetLastError();
  }
};

// ---- the leaf microbenchmark (P3; tools/leaf_microbench.py) ----------------
//
// Each warp's 32 rays visit `visits` leaves back to back (visit v of warp w
// tests leaf (v + w) % n_leaves), with no walk and every lane taking the
// leaf as hit, through the leaf body of one variant; each ray's closest
// hit over its visits is written (t, and an int that keeps the variant's
// payload alive), so no visit can be optimised away. Variants, the JAX
// harness's where their arithmetic differs on Hopper:
//   BENCH_PROD      leaf_simt, the production body: the hit point form
//                   (h = p + t d, u = h.U), (t, slot, u, v) selected in
//                   order; JAX `nonormal` is this body (the normal is
//                   interpolated once, after the walk, from the slot)
//   BENCH_MMA       leaf_mma, the tensor-core body
//   BENCH_BASE      u = p.U + t (d.U), the smooth normal selected in order
//   BENCH_HITPOINT  the production arithmetic, the smooth normal selected
//   BENCH_TREE      independent per-slot validity and normals, a pairwise
//                   min-tree over each 8 slots, the 8-slot winners folded
//                   in order; JAX `treec` is this (the color comes from
//                   the slot after the walk on Hopper)
//   BENCH_SYNTH     BENCH_BASE with the 24 coefficients synthesized from
//                   the visit and slot numbers instead of loaded
enum {
  BENCH_PROD = 0, BENCH_MMA = 1, BENCH_BASE = 2, BENCH_HITPOINT = 3,
  BENCH_TREE = 4, BENCH_SYNTH = 5
};

// Slot s's 24 coefficients: its test record (p1, Ng, U, V) then its
// shading record (n1, n2-n1, n3-n1, color).
__device__ __forceinline__ void slot_coeffs(const Params& p, int s,
                                            float (&co)[24]) {
  const float4* t = p.tris + (size_t)s * kTriVecs;
  const float4* h = p.shade + (size_t)s * kTriVecs;
#pragma unroll
  for (int j = 0; j < kTriVecs; ++j) {
    const float4 a = __ldg(t + j), b = __ldg(h + j);
    co[4 * j] = a.x;
    co[4 * j + 1] = a.y;
    co[4 * j + 2] = a.z;
    co[4 * j + 3] = a.w;
    co[12 + 4 * j] = b.x;
    co[12 + 4 * j + 1] = b.y;
    co[12 + 4 * j + 2] = b.z;
    co[12 + 4 * j + 3] = b.w;
  }
}

// One slot's test with the normal, for BENCH_BASE/HITPOINT/SYNTH/TREE:
// returns t (kBig unless valid, and below bt when kChain) and the normal.
template <bool kHitpoint, bool kChain>
__device__ __forceinline__ float bench_slot(const float (&co)[24], float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float eps,
                                            float bt, float& nx, float& ny,
                                            float& nz) {
  const float pxx = ox - co[0], pyy = oy - co[1], pzz = oz - co[2];
  const float den = dx * co[3] + dy * co[4] + dz * co[5];
  const float num_t = -(pxx * co[3] + pyy * co[4] + pzz * co[5]);
  const bool den_ok = fabsf(den) >= eps;
  const float f = 1.0f / (den_ok ? den : 1.0f);
  const float t = num_t * f;
  float u, v;
  if constexpr (kHitpoint) {
    const float hx = pxx + t * dx, hy = pyy + t * dy, hz = pzz + t * dz;
    u = hx * co[6] + hy * co[7] + hz * co[8];
    v = hx * co[9] + hy * co[10] + hz * co[11];
  } else {
    u = (pxx * co[6] + pyy * co[7] + pzz * co[8]) +
        t * (dx * co[6] + dy * co[7] + dz * co[8]);
    v = (pxx * co[9] + pyy * co[10] + pzz * co[11]) +
        t * (dx * co[9] + dy * co[10] + dz * co[11]);
  }
  nx = co[12] + co[15] * u + co[18] * v;
  ny = co[13] + co[16] * u + co[19] * v;
  nz = co[14] + co[17] * u + co[20] * v;
  const bool ok = den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                  t > eps && (!kChain || t < bt);
  return ok ? t : kBig;
}

template <int kVar>
__global__ void __launch_bounds__(kThreads)
    leaf_bench(Params p, Rays r, int visits, int n_leaves) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int si = min(i, r.n - 1);  // a warp's lanes stay to its end (mma)
  const float ox = r.ox[si], oy = r.oy[si], oz = r.oz[si];
  const float dx = r.dx[si], dy = r.dy[si], dz = r.dz[si];
  const int warp = i >> 5, K = p.leaf_size;
  float bt = kBig, wu = 0.0f, wv = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int slot = -1;
  RayFrags q;
  if constexpr (kVar == BENCH_MMA) q = ray_frags(ox, oy, oz, dx, dy, dz);
  for (int v = 0; v < visits; ++v) {
    const int s0 = ((v + warp) % n_leaves) * K;
    if constexpr (kVar == BENCH_PROD) {
      bt = leaf_simt(p, s0, ox, oy, oz, dx, dy, dz, bt, slot, wu, wv);
    } else if constexpr (kVar == BENCH_MMA) {
      bt = leaf_mma(p, s0, q, true, bt, slot, wu, wv);
    } else if constexpr (kVar == BENCH_TREE) {
      for (int k0 = 0; k0 < K; k0 += 8) {
        float ct[8], cx[8], cy[8], cz[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float co[24];
          slot_coeffs(p, s0 + k0 + k, co);
          ct[k] = bench_slot<true, false>(co, ox, oy, oz, dx, dy, dz, p.eps,
                                          bt, cx[k], cy[k], cz[k]);
        }
#pragma unroll
        for (int w = 1; w < 8; w <<= 1) {
#pragma unroll
          for (int k = 0; k < 8; k += 2 * w) {
            const bool take = ct[k + w] < ct[k];
            ct[k] = fminf(ct[k], ct[k + w]);
            cx[k] = take ? cx[k + w] : cx[k];
            cy[k] = take ? cy[k + w] : cy[k];
            cz[k] = take ? cz[k + w] : cz[k];
          }
        }
        if (ct[0] < bt) {
          bt = ct[0];
          nx = cx[0];
          ny = cy[0];
          nz = cz[0];
        }
      }
    } else {
      const float fi = (float)(v % 7 + 1) * 0.1f;
      for (int k = 0; k < K; ++k) {
        float co[24];
        if constexpr (kVar == BENCH_SYNTH) {
#pragma unroll
          for (int j = 0; j < 24; ++j)
            co[j] = fi * (float)(((k & 3) * 24 + j + (k >> 2)) % 7 + 1);
        } else {
          slot_coeffs(p, s0 + k, co);
        }
        float cx, cy, cz;
        const float t = bench_slot<kVar == BENCH_HITPOINT, true>(
            co, ox, oy, oz, dx, dy, dz, p.eps, bt, cx, cy, cz);
        if (t < bt) {
          bt = t;
          nx = cx;
          ny = cy;
          nz = cz;
        }
      }
    }
  }
  if (i >= r.n) return;
  r.out[i] = bt;
  r.idx[i] = (kVar == BENCH_PROD || kVar == BENCH_MMA)
                 ? slot : __float_as_int(nx + ny + nz);
}

// The pairs of the tensor-core leaf test: each warp's 32 rays against leaf
// warp % n_leaves; out [n, K] gets every pair's t (kBig where the pair
// does not hit), as leaf_mma computes it.
__global__ void __launch_bounds__(kThreads)
    mma_pairs(Params p, Rays r, int n_leaves) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int si = min(i, r.n - 1);
  const RayFrags q = ray_frags(r.ox[si], r.oy[si], r.oz[si], r.dx[si],
                               r.dy[si], r.dz[si]);
  const int lane = threadIdx.x & 31, warp = i >> 5, K = p.leaf_size;
  const float* a =
      p.mxu + (size_t)(warp % n_leaves) * leaf_tiles(K) * 32 + lane;
  for (int ct = 0; ct < 4; ++ct) {
    const int ray = warp * 32 + ct * 8 + (lane >> 2);
    tile_pairs(a, K, frag_o(q, ct), frag_d(q, ct), p.eps,
               [&](float t, int k, float, float) {
                 if (ray < r.n && k < K) r.out[(size_t)ray * K + k] = t;
               });
  }
}

// The texel-fetch probe: one thread per (u, v) calls the kernels' own
// fetch, sample_pool, on one texture of the pool; with kFast false, the
// fetch with the JAX kernel's wrap alone (the kernels' before R3).
template <bool kFast>
__global__ void __launch_bounds__(kThreads)
    tex_fetch(float* out_r, float* out_g, float* out_b,
              const int* __restrict__ pool, const float* u, const float* v,
              int n, float base, float w, float h, float iw, float ih) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tex[3] = {base, w, h};
  sample_pool<kFast>(pool, tex, iw, ih, u[i], v[i], out_r[i], out_g[i],
                     out_b[i]);
}

// The fetches' wrap held to wrap_tex: one thread per integer a0 + i (as a
// float, rounded to nearest) of n, by m (the side of a texture) with its
// reciprocal; counts[0] gains the integers the fetches wrap by wrap_fast
// (|a| < kWrapFast, m <= kSideFast) and counts[1] those where wrap_fast's
// (c0, c0 + 1 or 0) differs from wrap_tex's pair (the cold branch is
// wrap_tex itself). One atomic add a block and count.
__global__ void __launch_bounds__(kThreads)
    wrap_check(long long a0, int n, float m, float im,
               unsigned long long* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float a = (float)(a0 + i);
  const bool fast = i < n && fabsf(a) < kWrapFast && m <= kSideFast;
  bool bad = false;
  if (fast) {
    const int c0 = (int)wrap_fast(a, m, im);
    const int c1 = c0 + 1 == (int)m ? 0 : c0 + 1;
    bad = c0 != (int)wrap_tex(a, m) || c1 != (int)wrap_tex(a + 1.0f, m);
  }
  const int n_fast = __syncthreads_count(fast);
  const int n_bad = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    if (n_fast) atomicAdd(counts, (unsigned long long)n_fast);
    if (n_bad) atomicAdd(counts + 1, (unsigned long long)n_bad);
  }
}

// The object loop's filter held to the exact tests: one thread a case of
// object type `type` (PLANE, SPHERE or CYLINDER), an object-space ray (ray
// [6, n]: o xyz, d xyz) and a threshold T (thr [n]); counts[0] gains the
// cases the filter skips and counts[1] those of them whose exact t is below
// T (a winner the loop would have missed). One atomic add a block and
// count.
__global__ void __launch_bounds__(kThreads)
    filter_check(int type, const float* ray, const float* thr, int n,
                 float eps, float min_y, float max_y,
                 unsigned long long* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool skip = false, bad = false;
  if (i < n) {
    const size_t m = (size_t)n;
    const float ox = ray[i], oy = ray[m + i], oz = ray[2 * m + i];
    const float dx = ray[3 * m + i], dy = ray[4 * m + i], dz = ray[5 * m + i];
    const float T = thr[i];
    float t;
    if (type == PLANE) {
      skip = plane_skip(oy, dy, T);
      t = plane_t(oy, dy, eps);
    } else if (type == SPHERE) {
      skip = sphere_skip(ox, oy, oz, dx, dy, dz, T);
      t = sphere_t(ox, oy, oz, dx, dy, dz, eps);
    } else {
      skip = cylinder_skip(ox, oz, dx, dz, T);
      t = cylinder_t(ox, oy, oz, dx, dy, dz, min_y, max_y, eps);
    }
    bad = skip && t < T;
  }
  const int n_skip = __syncthreads_count(skip);
  const int n_bad = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    if (n_skip) atomicAdd(counts, (unsigned long long)n_skip);
    if (n_bad) atomicAdd(counts + 1, (unsigned long long)n_bad);
  }
}

// light_sincos of n angles x, one thread each (the check of the light
// point's sin/cos).
__global__ void __launch_bounds__(kThreads)
    sincos_check(const float* x, float* s, float* c, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  light_sincos(x[i], s[i], c[i]);
}

// The frame's finish: acc [3, n_slots] f32 slot sums (planar, as the
// megakernel writes them), base_pid [n_base] the pixel of each base slot
// (-1 for padding), img [n_pixels, 3] f32. Base slot i is slot
// (i / g) * g * pack + i % g, and its replica r lies r * g slots after it.
__global__ void __launch_bounds__(kThreads)
    finish_frame(const float* __restrict__ acc,
                 const int* __restrict__ base_pid, float* __restrict__ img,
                 int n_base, int n_slots, int g, int pack,
                 double total_spp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_base) return;
  const int p = base_pid[i];
  if (p < 0) return;
  const size_t slot = (size_t)(i / g) * g * pack + i % g;
  for (int c = 0; c < 3; ++c) {
    const float* a = acc + (size_t)c * n_slots + slot;
    double s = 0.0;
    for (int r = 0; r < pack; ++r)
      s = __dadd_rn(s, (double)a[(size_t)r * g]);
    img[(size_t)p * 3 + c] = __double2float_rn(__ddiv_rn(s, total_spp));
  }
}

}  // namespace

// Launch the megakernel over n_slots = T*S*L slots on `stream`. obj_types,
// group_root and group_end are HOST arrays of n_obj <= kMaxObjects entries,
// copied into the launch parameters (no device copy, so no synchronisation).
// nodes [*, 8], tris [*, 12] and shade [*, 12] are the mesh tables
// (render/megakernel.py build_mesh_tables: node, triangle test and
// triangle shading records, 16-byte aligned; one zero row each for a scene
// without groups); oct_nodes is the node count of one octant copy,
// or 0 when the table has no copies. Scenes with a GROUP run the kMesh
// instantiation. Returns the cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments out of range.
extern "C" int pt_megakernel_launch(
    float* out_r, float* out_g, float* out_b, const int* px, const int* py,
    const float* obj, const int* obj_types, const float* cam,
    const float* nodes, const float* tris, const float* shade,
    const int* group_root, const int* group_end, int n_obj, int n_slots,
    int S, int L, int spp,
    int spp_pack, int chunk_axis, uint32_t seed, int sample_base,
    int max_bounces, int max_eff, int leaf_size, int oct_nodes, float eps,
    float t_max, float sun_cut, float sun_den, float golden2, int coherent,
    void* stream) {
  if (n_obj < 1 || n_obj > kMaxObjects || spp_pack < 1 || leaf_size < 1 ||
      spp % spp_pack != 0 || (chunk_axis ? L % spp_pack : S % spp_pack) != 0)
    return (int)cudaErrorInvalidValue;
  Params p{out_r, out_g, out_b, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp / spp_pack, spp_pack, chunk_axis, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  return launch<false, false>(p, obj_types, group_root, group_end, stream);
}

// Launch the textured instantiations: pt_megakernel_launch's arguments,
// then the rgb8 texel pool (int32 [T], each texel r | g << 8 | b << 16)
// and the texture table [n_obj, 12] (f32), both on the device.
extern "C" int pt_megakernel_tex_launch(
    float* out_r, float* out_g, float* out_b, const int* px, const int* py,
    const float* obj, const int* obj_types, const float* cam,
    const float* nodes, const float* tris, const float* shade,
    const int* group_root, const int* group_end, int n_obj, int n_slots,
    int S, int L, int spp,
    int spp_pack, int chunk_axis, uint32_t seed, int sample_base,
    int max_bounces, int max_eff, int leaf_size, int oct_nodes, float eps,
    float t_max, float sun_cut, float sun_den, float golden2, int coherent,
    void* stream, const int* tex_pool, const float* tex_table) {
  if (n_obj < 1 || n_obj > kMaxObjects || spp_pack < 1 || leaf_size < 1 ||
      spp % spp_pack != 0 || (chunk_axis ? L % spp_pack : S % spp_pack) != 0 ||
      tex_pool == nullptr || tex_table == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{out_r, out_g, out_b, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp / spp_pack, spp_pack, chunk_axis, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           nullptr, nullptr, nullptr, nullptr, nullptr, tex_pool, tex_table};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  return launch<false, true>(p, obj_types, group_root, group_end, stream);
}

// Launch the f32-texel instantiations: pt_megakernel_tex_launch with the
// n_texels f32 texels [n_texels, 4] (rgb and a pad float, 16-byte aligned)
// in place of the rgb8 pool, then the mesh walk's codes (launch_walk's,
// LEAF_MMA refused, or the per-thread walk with SIMT leaves, the only one
// of a scene without a GROUP).
// With texels q * f32(1/255) of the pool's bytes the result is
// pt_megakernel_tex_launch's (or, on a walk, the packet launch's) bit for
// bit.
extern "C" int pt_megakernel_texels_launch(
    float* out_r, float* out_g, float* out_b, const int* px, const int* py,
    const float* obj, const int* obj_types, const float* cam,
    const float* nodes, const float* tris, const float* shade,
    const int* group_root, const int* group_end, int n_obj, int n_slots,
    int S, int L, int spp,
    int spp_pack, int chunk_axis, uint32_t seed, int sample_base,
    int max_bounces, int max_eff, int leaf_size, int oct_nodes, float eps,
    float t_max, float sun_cut, float sun_den, float golden2, int coherent,
    void* stream, const float* texels, int n_texels,
    const float* tex_table, int walk, int leaf) {
  if (n_obj < 1 || n_obj > kMaxObjects || spp_pack < 1 || leaf_size < 1 ||
      spp % spp_pack != 0 || (chunk_axis ? L % spp_pack : S % spp_pack) != 0 ||
      texels == nullptr || n_texels < 1 || tex_table == nullptr ||
      reinterpret_cast<uintptr_t>(texels) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{out_r, out_g, out_b, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp / spp_pack, spp_pack, chunk_axis, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, tex_table,
           reinterpret_cast<const float4*>(texels), nullptr, 0ull,
           n_texels};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  return launch<false, true, true>(p, obj_types, group_root, group_end,
                                   stream, walk, leaf);
}

// Launch the next-event-estimation instantiations (kNee):
// pt_megakernel_launch's arguments, then the rgb8 texel pool and texture
// table of a textured scene (both null for a scene without textures) and
// the n_lights light indices light_idx (a HOST array, copied into the
// launch parameters). n_lights = 0 runs the NEE code with no light: the
// render of pt_megakernel_launch (or _tex_launch), which measures what a
// runtime branch would cost the renders without NEE.
extern "C" int pt_megakernel_nee_launch(
    float* out_r, float* out_g, float* out_b, const int* px, const int* py,
    const float* obj, const int* obj_types, const float* cam,
    const float* nodes, const float* tris, const float* shade,
    const int* group_root, const int* group_end, int n_obj, int n_slots,
    int S, int L, int spp,
    int spp_pack, int chunk_axis, uint32_t seed, int sample_base,
    int max_bounces, int max_eff, int leaf_size, int oct_nodes, float eps,
    float t_max, float sun_cut, float sun_den, float golden2, int coherent,
    void* stream, const int* tex_pool, const float* tex_table, int n_lights,
    const int* light_idx) {
  if (n_obj < 1 || n_obj > kMaxObjects || spp_pack < 1 || leaf_size < 1 ||
      spp % spp_pack != 0 || (chunk_axis ? L % spp_pack : S % spp_pack) != 0 ||
      (tex_pool == nullptr) != (tex_table == nullptr) || n_lights < 0 ||
      n_lights > kMaxObjects || (n_lights > 0 && light_idx == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_lights; ++i)
    if (light_idx[i] < 0 || light_idx[i] >= n_obj)
      return (int)cudaErrorInvalidValue;
  Params p{out_r, out_g, out_b, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp / spp_pack, spp_pack, chunk_axis, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           nullptr, nullptr, nullptr, nullptr, nullptr, tex_pool, tex_table};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  p.n_lights = n_lights;
  for (int i = 0; i < n_lights; ++i) p.light_idx[i] = light_idx[i];
  if (tex_pool != nullptr)
    return launch<false, true, false, true>(p, obj_types, group_root,
                                            group_end, stream);
  return launch<false, false, false, true>(p, obj_types, group_root,
                                           group_end, stream);
}

// What a launch of the intersect-only kernel needs of the scene alone,
// built once by its launcher (render/megakernel.py IntersectTables, whose
// ctypes Structure mirrors this one): the object table and the mesh tables
// (16-byte aligned), the object count, the BVH leaf size, the octant
// copies' node count, and the type codes and group ranges of
// pt_megakernel_launch.
struct IsectScene {
  const float* obj;
  const float* nodes;
  const float* tris;
  const float* shade;
  int n_obj;
  int leaf_size;
  int oct_nodes;
  int obj_types[kMaxObjects];
  int group_root[kMaxObjects];
  int group_end[kMaxObjects];
};

// The launch parameters and the outputs of the intersect-only kernel over
// n rays into the wrapper's two buffers (intersect_outputs): `out`, the
// f32 rows of struct Rays ([13, n], or [7, n] on a scene without groups),
// and `ints`, i32 [3, n] holding the winners, the triangle slots and the
// triangle flags, u8 [n] (the first n bytes of the third row), or the
// winners alone, [1, n], on a scene without groups. Sets `mesh`; false
// for arguments it does not take.
bool intersect_params(Params& p, Rays& r, TriOut& tri, bool& mesh,
                      const IsectScene* sc, const float* ox,
                      const float* oy, const float* oz, const float* dx,
                      const float* dy, const float* dz, float* out, int* ints,
                      int n, float eps, float t_max) {
  if (sc == nullptr || n < 0 || sc->n_obj < 1 || sc->n_obj > kMaxObjects ||
      sc->leaf_size < 1 || out == nullptr || ints == nullptr)
    return false;
  p.obj = sc->obj;
  if (!set_tables(p, sc->nodes, sc->tris, sc->shade)) return false;
  p.n_obj = sc->n_obj;
  p.leaf_size = sc->leaf_size;
  p.oct_nodes = sc->oct_nodes;
  p.eps = eps;
  p.t_max = t_max;
  mesh = copy_objects(p, sc->obj_types, sc->group_root, sc->group_end);
  r = Rays{ox, oy, oz, dx, dy, dz, out, ints, n};
  tri = mesh ? TriOut{ints + n, reinterpret_cast<uint8_t*>(ints + 2 * n)}
             : TriOut{nullptr, nullptr};
  return true;
}

// Launch the intersect-only kernel over n rays (ox..dz, f32 [n] each, on
// the device) of the scene `sc` into `out` and `ints` (intersect_params'
// layout), on `stream`. Returns as pt_megakernel_launch does.
extern "C" int pt_intersect_launch(
    const IsectScene* sc, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, float* out, int* ints,
    int n, float eps, float t_max, void* stream) {
  Params p{};
  Rays r{};
  TriOut tri{};
  bool mesh = false;
  if (!intersect_params(p, r, tri, mesh, sc, ox, oy, oz, dx, dy, dz, out,
                        ints, n, eps, t_max))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(p.n_obj * kObjCols);
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (mesh)
      intersect<true><<<blocks, kThreads, smem, s>>>(p, r, tri);
    else
      intersect<false><<<blocks, kThreads, smem, s>>>(p, r, tri);
  }
  return (int)cudaGetLastError();
}

// Launch the texel-fetch probe over n (u, v) pairs of one texture at (base,
// w, h) of the pool: fast = 1 the kernels' fetch, 0 the fetch with the JAX
// kernel's wrap alone; out_* [n]. Returns as pt_megakernel_launch does.
extern "C" int pt_tex_fetch_launch(float* out_r, float* out_g, float* out_b,
                                   const int* pool, const float* u,
                                   const float* v, int n, int base, int w,
                                   int h, int fast, void* stream) {
  if (n < 0 || base < 0 || w < 1 || h < 1 || pool == nullptr ||
      (fast != 0 && fast != 1))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  const float fw = (float)w, fh = (float)h;
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0 && fast)
    tex_fetch<true><<<blocks, kThreads, 0, s>>>(
        out_r, out_g, out_b, pool, u, v, n, (float)base, fw, fh, 1.0f / fw,
        1.0f / fh);
  else if (blocks > 0)
    tex_fetch<false><<<blocks, kThreads, 0, s>>>(
        out_r, out_g, out_b, pool, u, v, n, (float)base, fw, fh, 1.0f / fw,
        1.0f / fh);
  return (int)cudaGetLastError();
}

// Launch wrap_check over the n integers from a0 by the side m; counts
// (uint64 [2], on the device, zeroed by the caller) gains the fast-wrapped
// integers and the differing ones. Returns as pt_megakernel_launch does.
extern "C" int pt_wrap_check_launch(long long a0, int n, int m,
                                    unsigned long long* counts,
                                    void* stream) {
  if (n < 0 || m < 1 || counts == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  const float fm = (float)m;
  if (blocks > 0)
    wrap_check<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a0, n, fm,
                                                             1.0f / fm,
                                                             counts);
  return (int)cudaGetLastError();
}

// Launch sincos_check over n angles: s [n], c [n]. Returns as
// pt_megakernel_launch does.
extern "C" int pt_sincos_launch(const float* x, float* s, float* c, int n,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0)
    sincos_check<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, s, c, n);
  return (int)cudaGetLastError();
}

// Launch finish_frame over the n_slots / pack base slots of a layout whose
// sample replicas lie g slots apart (render/megakernel.py replica_stride
// works g out of the tile and the packing); acc [3, n_slots], base_pid
// [n_slots / pack] and img [n_pixels, 3] on the device. Returns as
// pt_megakernel_launch does.
extern "C" int pt_finish_frame_launch(const float* acc, const int* base_pid,
                                      float* img, int n_slots, int g,
                                      int pack, double total_spp,
                                      void* stream) {
  if (n_slots < 0 || g < 1 || pack < 1 || !(total_spp > 0.0) ||
      n_slots % ((long long)g * pack))
    return (int)cudaErrorInvalidValue;
  const int n_base = n_slots / pack;
  const int blocks = (n_base + kThreads - 1) / kThreads;
  if (blocks > 0)
    finish_frame<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        acc, base_pid, img, n_base, n_slots, g, pack, total_spp);
  return (int)cudaGetLastError();
}

// Launch filter_check over n cases of object type `type` (PLANE, SPHERE
// or CYLINDER; min_y, max_y the cylinder's): ray [6, n] and thr [n] on the
// device, counts (uint64 [2], zeroed by the caller) gains the skipped cases
// and the skipped ones whose exact t is below their threshold. Returns as
// pt_megakernel_launch does.
extern "C" int pt_filter_check_launch(int type, const float* ray,
                                      const float* thr, int n, float eps,
                                      float min_y, float max_y,
                                      unsigned long long* counts,
                                      void* stream) {
  if (n < 0 || counts == nullptr ||
      (type != PLANE && type != SPHERE && type != CYLINDER))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0)
    filter_check<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        type, ray, thr, n, eps, min_y, max_y, counts);
  return (int)cudaGetLastError();
}

// Launch the gradient kernel: the replay of pt_megakernel_launch's paths
// with spp samples per slot and no sample packing (the layout of the
// differentiable render's primal), and the backward pass against the
// per-slot cotangents cot_* [n_slots]. gobj [n_obj, 6] (color rgb,
// emission rgb) and gtri [n_tri_slots, 4] (rgb and a pad column; 16-byte
// aligned; null for object gradients only) must be zeroed by the caller;
// the kernel adds into them. n_slots must be a multiple of the block size
// (kGradThreads, 128) and max_bounces at most kMaxTape (16). walk, leaf:
// the mesh walk (launch_walk's codes; WalkLaunch's walks, or the
// per-thread walk with SIMT leaves, the only one of a scene without a
// GROUP). Returns as pt_megakernel_launch does.
extern "C" int pt_grad_launch(
    const float* cot_r, const float* cot_g, const float* cot_b, float* gobj,
    float* gtri, const int* px, const int* py, const float* obj,
    const int* obj_types, const float* cam, const float* nodes,
    const float* tris, const float* shade, const int* group_root,
    const int* group_end, int n_obj, int n_slots, int S, int L, int spp,
    uint32_t seed,
    int sample_base, int max_bounces, int max_eff, int leaf_size,
    int oct_nodes, float eps, float t_max, float sun_cut, float sun_den,
    float golden2, int coherent, void* stream, int walk, int leaf) {
  if (n_obj < 1 || n_obj > kMaxObjects || leaf_size < 1 ||
      n_slots % kGradThreads != 0 || max_bounces > kMaxTape ||
      reinterpret_cast<uintptr_t>(gtri) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{nullptr, nullptr, nullptr, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp, 1, 0, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           cot_r, cot_g, cot_b, gobj, gtri, nullptr, nullptr};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  return launch<true, false>(p, obj_types, group_root, group_end, stream,
                             walk, leaf);
}

// Launch the texel-gradient instantiation (K6-tex): pt_grad_launch's
// arguments, then the n_texels f32 texels [n_texels, 4] the replay fetches
// from, the texture table [n_obj, 12], the texel gradient sums gtex
// [n_texels, 4] (rgb and a pad column; 16-byte aligned; zeroed by the
// caller; the kernel adds into them) and
// tex_train, whose bit j says that object j's texture takes texel
// gradients, and the walk and leaf codes (pt_grad_launch's). Returns as
// pt_megakernel_launch does.
extern "C" int pt_grad_tex_launch(
    const float* cot_r, const float* cot_g, const float* cot_b, float* gobj,
    const int* px, const int* py, const float* obj, const int* obj_types,
    const float* cam, const float* nodes, const float* tris,
    const float* shade, const int* group_root, const int* group_end,
    int n_obj, int n_slots,
    int S, int L, int spp, uint32_t seed, int sample_base, int max_bounces,
    int max_eff, int leaf_size, int oct_nodes, float eps, float t_max,
    float sun_cut, float sun_den, float golden2, int coherent, void* stream,
    const float* texels, int n_texels, const float* tex_table, float* gtex,
    unsigned long long tex_train, int walk, int leaf) {
  if (n_obj < 1 || n_obj > kMaxObjects || leaf_size < 1 ||
      n_slots % kGradThreads != 0 || max_bounces > kMaxTape ||
      texels == nullptr || n_texels < 1 || tex_table == nullptr ||
      gtex == nullptr || reinterpret_cast<uintptr_t>(texels) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gtex) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{nullptr, nullptr, nullptr, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp, 1, 0, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           cot_r, cot_g, cot_b, gobj, nullptr, nullptr, tex_table,
           reinterpret_cast<const float4*>(texels), gtex, tex_train,
           n_texels};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  return launch<true, true, true>(p, obj_types, group_root, group_end,
                                  stream, walk, leaf);
}

// Launch the megakernel of a mesh scene on a packet walk, or on the
// per-thread walk without leaf tests (walk, leaf: launch_walk's codes):
// pt_megakernel_launch's arguments, then the rgb8 texel pool and texture
// table of a textured scene (both null for a scene without textures), nee
// (1: the kNee instantiation, with n_lights light indices light_idx, a
// HOST array) and the MXU fragments (mxu_fragments' layout, on the device;
// null unless leaf is LEAF_MMA). Returns as pt_megakernel_launch does.
extern "C" int pt_megakernel_packet_launch(
    float* out_r, float* out_g, float* out_b, const int* px, const int* py,
    const float* obj, const int* obj_types, const float* cam,
    const float* nodes, const float* tris, const float* shade,
    const int* group_root, const int* group_end, int n_obj, int n_slots,
    int S, int L, int spp,
    int spp_pack, int chunk_axis, uint32_t seed, int sample_base,
    int max_bounces, int max_eff, int leaf_size, int oct_nodes, float eps,
    float t_max, float sun_cut, float sun_den, float golden2, int coherent,
    void* stream, const int* tex_pool, const float* tex_table, int nee,
    int n_lights, const int* light_idx, const float* mxu, int walk,
    int leaf) {
  if (n_obj < 1 || n_obj > kMaxObjects || spp_pack < 1 || leaf_size < 1 ||
      spp % spp_pack != 0 || (chunk_axis ? L % spp_pack : S % spp_pack) != 0 ||
      (tex_pool == nullptr) != (tex_table == nullptr) || n_lights < 0 ||
      n_lights > kMaxObjects || (n_lights > 0 && light_idx == nullptr) ||
      (nee != 0 && nee != 1) || (nee == 0 && n_lights != 0) ||
      (leaf == LEAF_MMA) != (mxu != nullptr) ||
      (walk == WALK_THREAD && leaf == LEAF_SIMT))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_lights; ++i)
    if (light_idx[i] < 0 || light_idx[i] >= n_obj)
      return (int)cudaErrorInvalidValue;
  Params p{out_r, out_g, out_b, px, py, obj, cam, nullptr, nullptr,
           n_obj, n_slots, S, L, spp / spp_pack, spp_pack, chunk_axis, seed,
           sample_base, max_bounces, max_eff, leaf_size, oct_nodes,
           eps, t_max, sun_cut, sun_den, golden2, coherent, {}, {}, {},
           nullptr, nullptr, nullptr, nullptr, nullptr, tex_pool, tex_table};
  if (!set_tables(p, nodes, tris, shade))
    return (int)cudaErrorInvalidValue;
  p.n_lights = n_lights;
  for (int i = 0; i < n_lights; ++i) p.light_idx[i] = light_idx[i];
  p.mxu = mxu;
  if (tex_pool != nullptr && nee)
    return launch<false, true, false, true>(p, obj_types, group_root,
                                            group_end, stream, walk, leaf);
  if (tex_pool != nullptr)
    return launch<false, true>(p, obj_types, group_root, group_end, stream,
                               walk, leaf);
  if (nee)
    return launch<false, false, false, true>(p, obj_types, group_root,
                                             group_end, stream, walk, leaf);
  return launch<false, false>(p, obj_types, group_root, group_end, stream,
                              walk, leaf);
}

// Launch the intersect-only kernel of a mesh scene on a walk of
// launch_walk: pt_intersect_launch's arguments, then the MXU fragments
// (null unless leaf is LEAF_MMA) and the walk and leaf codes.
extern "C" int pt_intersect_packet_launch(
    const IsectScene* sc, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, float* out, int* ints,
    int n, float eps, float t_max, void* stream, const float* mxu, int walk,
    int leaf) {
  Params p{};
  Rays r{};
  TriOut tri{};
  bool mesh = false;
  if ((leaf == LEAF_MMA) != (mxu != nullptr) ||
      !intersect_params(p, r, tri, mesh, sc, ox, oy, oz, dx, dy, dz, out,
                        ints, n, eps, t_max) ||
      !mesh)  // the walks are for meshes
    return (int)cudaErrorInvalidValue;
  p.mxu = mxu;
  return launch_walk(walk, leaf,
                     IntersectLaunch{p, r, tri,
                                     sizeof(float) * (size_t)(p.n_obj *
                                                              kObjCols),
                                     (cudaStream_t)stream});
}

// Launch the leaf microbenchmark (variant < 6: leaf_bench's BENCH_*) or
// the tensor-core pairs (variant 6: mma_pairs, out [n, leaf_size]) on n
// rays (ox..dz, f32 [n]), over the n_leaves leaves of leaf_size slots of
// the triangle table tris (and their MXU fragments mxu, for the
// tensor-core variants): out f32 [n] the closest t over the visits, idx
// i32 [n] the winning slot (-1 for none; the payload's bits for the
// normal-tracking variants). Returns as pt_megakernel_launch does.
extern "C" int pt_leaf_bench_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, float* out, int* idx, int n,
    int visits, const float* tris, const float* shade, const float* mxu,
    int leaf_size,
    int n_leaves, float eps, float t_max, int variant, void* stream) {
  if (n < 1 || visits < 1 || leaf_size < 1 || n_leaves < 1 ||
      tris == nullptr || shade == nullptr || variant < 0 || variant > 6 ||
      ((variant == BENCH_MMA || variant == 6) && mxu == nullptr) ||
      (variant == BENCH_TREE && leaf_size % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Params p{};
  if (!set_tables(p, nullptr, tris, shade))
    return (int)cudaErrorInvalidValue;
  p.mxu = mxu;
  p.leaf_size = leaf_size;
  p.eps = eps;
  p.t_max = t_max;
  const Rays r{ox, oy, oz, dx, dy, dz, out, idx, n};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case BENCH_PROD:
      leaf_bench<BENCH_PROD><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                          n_leaves);
      break;
    case BENCH_MMA:
      leaf_bench<BENCH_MMA><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                         n_leaves);
      break;
    case BENCH_BASE:
      leaf_bench<BENCH_BASE><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                          n_leaves);
      break;
    case BENCH_HITPOINT:
      leaf_bench<BENCH_HITPOINT><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                              n_leaves);
      break;
    case BENCH_TREE:
      leaf_bench<BENCH_TREE><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                          n_leaves);
      break;
    case BENCH_SYNTH:
      leaf_bench<BENCH_SYNTH><<<blocks, kThreads, 0, s>>>(p, r, visits,
                                                           n_leaves);
      break;
    default:
      mma_pairs<<<blocks, kThreads, 0, s>>>(p, r, n_leaves);
  }
  return (int)cudaGetLastError();
}
