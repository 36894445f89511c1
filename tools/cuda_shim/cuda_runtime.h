// A CPU stand-in for the CUDA runtime, so that csrc/megakernel.cu can be
// compiled by g++ and run here (tools/cuda_shim/build.py): one std::thread
// per CUDA thread, the blocks of a launch in turn. A warp's collectives
// (__shfl_sync, __ballot_sync, __any_sync, __match_any_sync,
// __reduce_max_sync, __syncwarp) exchange through per-lane slots between
// two waits on the warp's std::barrier, so a lane missing from one
// deadlocks (on the card it would be undefined); the block's barriers
// (__syncthreads and its _count/_or forms) wait on the block's. The FP64
// tensor-core products are emulated: m8n8k4 (shim_dmma: a0 = A[lane/4]
// [lane%4], b0 = B[lane%4][lane/4], d_i = D[lane/4][2 (lane%4) + i]) and
// sm_90's m16n8k4 (shim_dmma16: a1 = A[lane/4 + 8][lane%4], d[2 + i] =
// D[lane/4 + 8][2 (lane%4) + i]), each dot summed in k order in f64 (the
// products of f32 are exact), as the plain version sums it. sinf, cosf,
// sincosf and sqrtf are correctly rounded (through double), so that with
// the plain version's torch.sin, cos and sqrt made so too (run.py) the
// outputs are bit for bit comparable.
#pragma once
#include <barrier>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <functional>
#include <thread>
#include <vector>
#include <atomic>
#include <mutex>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __restrict__
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
template <class T> T __ldg(const T* p) { return *p; }
using std::min; using std::max;
inline float cr_sinf(float x) { return (float)std::sin((double)x); }
inline float cr_cosf(float x) { return (float)std::cos((double)x); }
inline float cr_sqrtf(float x) { return (float)std::sqrt((double)x); }
inline void cr_sincosf(float x, float* s, float* c) { *s = cr_sinf(x); *c = cr_cosf(x); }
#define sinf cr_sinf
#define cosf cr_cosf
#define sqrtf cr_sqrtf
#define sincosf cr_sincosf
inline unsigned long long min(unsigned long long a, unsigned long long b) { return a < b ? a : b; }
struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
  double a[32], a1[32], b[32];
};
struct Block {
  std::barrier<> bar;
  std::vector<Warp*> warps;
  std::atomic<int> cnt{0};
  int result = 0;
  explicit Block(int n) : bar(n) {
    for (int i = 0; i < (n + 31) / 32; ++i) warps.push_back(new Warp());
  }
  ~Block() { for (auto* w : warps) delete w; }
};
inline thread_local Block* tl_block = nullptr;
inline int lane_id() { return threadIdx.x & 31; }
inline Warp& my_warp() { return *tl_block->warps[threadIdx.x >> 5]; }
template <class T> uint64_t to_bits(T v) { uint64_t u = 0; std::memcpy(&u, &v, sizeof(T)); return u; }
template <class T> T from_bits(uint64_t u) { T v; std::memcpy(&v, &u, sizeof(T)); return v; }
template <class T> T __shfl_sync(unsigned, T v, int src) {
  Warp& w = my_warp(); w.slot[lane_id()] = to_bits(v); w.bar.arrive_and_wait();
  T r = from_bits<T>(w.slot[src & 31]); w.bar.arrive_and_wait(); return r;
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int off) { return __shfl_sync(m, v, lane_id() ^ off); }
inline unsigned __ballot_sync(unsigned, int p) {
  Warp& w = my_warp(); w.slot[lane_id()] = p ? 1 : 0; w.bar.arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (w.slot[i]) r |= 1u << i;
  w.bar.arrive_and_wait(); return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline void __syncwarp(unsigned = 0xffffffffu) { my_warp().bar.arrive_and_wait(); }
inline void __syncthreads() { tl_block->bar.arrive_and_wait(); }
inline int __syncthreads_count(int p) {
  Block& b = *tl_block;
  b.bar.arrive_and_wait();
  if (p) b.cnt.fetch_add(1);
  b.bar.arrive_and_wait();
  int r = b.cnt.load();
  b.bar.arrive_and_wait();
  if (threadIdx.x == 0) b.cnt.store(0);
  b.bar.arrive_and_wait();
  return r;
}
inline int __syncthreads_or(int p) { return __syncthreads_count(p) != 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __int_as_float(int i) { return from_bits<float>((uint32_t)i); }
inline int __float_as_int(float f) { return (int)(uint32_t)to_bits(f); }
// the explicitly rounded double ops (round to nearest, as IEEE's own)
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double a) { return (float)a; }
inline float __uint_as_float(unsigned i) { return from_bits<float>(i); }
inline unsigned __float_as_uint(float f) { return (uint32_t)to_bits(f); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned sel) {
  uint64_t v = (uint64_t)y << 32 | x; unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
template <class T> unsigned __match_any_sync(unsigned, T key) {
  Warp& w = my_warp(); w.slot[lane_id()] = to_bits(key); w.bar.arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (w.slot[i] == w.slot[lane_id()]) r |= 1u << i;
  w.bar.arrive_and_wait(); return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  Warp& w = my_warp(); w.slot[lane_id()] = v; w.bar.arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) r = std::max(r, (unsigned)w.slot[i]);
  w.bar.arrive_and_wait(); return r;
}
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  if (offset > 0) { for (unsigned i = base; i < 32; ++i) if ((mask >> i) & 1) { if (--offset == 0) return i; } }
  else if (offset < 0) { for (int i = base; i >= 0; --i) if ((mask >> i) & 1) { if (++offset == 0) return i; } }
  else return ((mask >> base) & 1) ? base : 0xffffffffu;
  return 0xffffffffu;
}
inline unsigned __activemask() { return 0xffffffffu; }
inline float4 operator+(float4 a, float4 b) { return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w}; }
template <class T> T atomicAdd(T* p, T v) { static std::mutex m; std::lock_guard<std::mutex> g(m); T o = *p; *p = o + v; return o; }
// the DMMAs: A row-major fragments, B column-major, sums in k order
inline void shim_dmma(double& d0, double& d1, double a, double b) {
  Warp& w = my_warp(); int l = lane_id();
  w.a[l] = a; w.b[l] = b; w.bar.arrive_and_wait();
  int r = l / 4, c0 = 2 * (l % 4);
  double d[2];
  for (int i = 0; i < 2; ++i) {
    int c = c0 + i; double s = 0.0;
    for (int k = 0; k < 4; ++k) s = s + w.a[4 * r + k] * w.b[4 * c + k];
    d[i] = s;
  }
  w.bar.arrive_and_wait(); d0 = d[0]; d1 = d[1];
}
inline void shim_dmma16(double (&d)[4], double a0, double a1, double b) {
  Warp& w = my_warp(); int l = lane_id();
  w.a[l] = a0; w.a1[l] = a1; w.b[l] = b; w.bar.arrive_and_wait();
  int r = l / 4, c0 = 2 * (l % 4);
  double o[4];
  for (int h = 0; h < 2; ++h) for (int i = 0; i < 2; ++i) {
    int c = c0 + i; double s = 0.0;
    for (int k = 0; k < 4; ++k) s = s + (h ? w.a1 : w.a)[4 * r + k] * w.b[4 * c + k];
    o[2 * h + i] = s;
  }
  w.bar.arrive_and_wait(); for (int i = 0; i < 4; ++i) d[i] = o[i];
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a card of 2 SMs that each hold 2 blocks, so that a grid sized to the
// resident blocks loops over many blocks' rays
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2; return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 2; return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return cudaSuccess;
}
inline void shim_launch(int g, int b, std::function<void()> f) {
  for (int bx = 0; bx < g; ++bx) {
    Block blk(b);
    std::vector<std::thread> ts;
    for (int t = 0; t < b; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = bx; blockDim.x = b; gridDim.x = g; tl_block = &blk; f(); });
    for (auto& th : ts) th.join();
  }
}
#include <mutex>
