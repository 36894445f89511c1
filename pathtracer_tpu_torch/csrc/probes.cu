// The op-rate probe (P2) for Hopper (sm_90a): the rate at which a kernel
// issues f32 operations of one kind, the counterpart of the JAX package's
// tools/vpu_peak_probe.py. Each thread runs `iters` iterations of kUnroll
// operations of one variant on registers seeded from x, and writes one
// float so that nothing is optimised away. Built with the megakernel's
// flags (-fmad=false, IEEE division and square root), so a multiply and an
// add stay two instructions unless __fmaf_rn asks for one.
//
//   FMA_DEP   one serial __fmaf_rn chain (latency)
//   FMA_PAR8  8 independent __fmaf_rn chains (FMA issue rate)
//   MUL_PAR8  8 independent multiply chains (the non-FMA rate)
//   ADD_PAR8  8 independent add chains
//   CMP_SEL   compare, multiply, add and select per pair (the leaf's mask
//             ops): 4 instructions a pair
//   LEAFMIX   the leaf test's arithmetic with constant coefficients: 35
//             operations a triangle as chip_smoke.py counts a bound's
//             (IEEE division one), and 7 an iteration that feed the
//             running sum back into the ray (so nothing is hoisted out of
//             the iteration)
//   DIV_PAR8  8 chains of IEEE division (__fdiv_rn), c = m / c with the
//             numerator m, 2m, 4m, 2m in turn (a division and the next
//             do not cancel)
//   SQRT_PAR8 8 chains of IEEE square root (__fsqrt_rn)
//   SINCOS    8 chains of sinf and cosf (4 each)
//
// The constants are chosen so that every operation of every variant but
// LEAFMIX and SINCOS moves its chain by more than one ulp of the output sum
// over the first iterations (SQRT_PAR8's chains reach 1.0 after about 30
// square roots): probes/op_rate.py holds those variants bit for bit against
// their plain versions, so a kernel that skips operations is caught.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 32;
enum {
  FMA_DEP = 0, FMA_PAR8, MUL_PAR8, ADD_PAR8, CMP_SEL, LEAFMIX, DIV_PAR8,
  SQRT_PAR8, SINCOS
};

template <int kVar>
__global__ void __launch_bounds__(kThreads)
    op_rate(const float* __restrict__ x, float* __restrict__ out, int n,
            int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = x0 + 0.01f * (float)j;
  if constexpr (kVar == LEAFMIX) {
    const float ox0 = x0, oy0 = x0 + 0.1f, oz0 = x0 - 1.5f;
    const float dx0 = x0 * 0.01f, dy0 = x0 * 0.02f, dz0 = x0 + 1.0f;
    float bt = 0.0f, gnx = 0.0f;
    for (int it = 0; it < iters; ++it) {
      const float e = gnx * 1e-30f;
      const float ox = ox0 + e, oy = oy0 + e, oz = oz0 + e;
      const float dx = dx0 + e, dy = dy0 + e, dz = dz0 + e;
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        // 32 distinct triangles an iteration (no two unrolled bodies alike)
        float co[12];
#pragma unroll
        for (int k = 0; k < 12; ++k)
          co[k] = 0.1f * (float)((s + k) % 7 + 1) + 0.001f * (float)s;
        const float pxx = ox - co[0], pyy = oy - co[1], pzz = oz - co[2];
        const float den = dx * co[3] + dy * co[4] + dz * co[5];
        const float num_t = -(pxx * co[3] + pyy * co[4] + pzz * co[5]);
        const bool den_ok = fabsf(den) >= 1e-4f;
        const float f = 1.0f / (den_ok ? den : 1.0f);
        const float t = num_t * f;
        const float hx = pxx + t * dx, hy = pyy + t * dy, hz = pzz + t * dz;
        const float u = hx * co[6] + hy * co[7] + hz * co[8];
        const float v = hx * co[9] + hy * co[10] + hz * co[11];
        bt = bt + t * u;
        gnx = gnx + v;
      }
    }
    out[i] = bt + gnx;
    return;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = k & 7;
      if constexpr (kVar == FMA_DEP) {
        c[0] = __fmaf_rn(c[0], 1.000001f, 0.5f);
      } else if constexpr (kVar == FMA_PAR8) {
        c[j] = __fmaf_rn(c[j], 1.000001f, 0.5f);
      } else if constexpr (kVar == MUL_PAR8) {
        c[j] = c[j] * 1.000001f;
      } else if constexpr (kVar == ADD_PAR8) {
        c[j] = c[j] + 0.0009765625f;  // 2^-10
      } else if constexpr (kVar == CMP_SEL) {
        if (k % 2 == 0) {
          const bool m = c[j] > c[(j + 1) & 7];
          c[j] = m ? c[j] * 0.9999f : c[j] + 0.0001f;
        }
      } else if constexpr (kVar == DIV_PAR8) {
        const float m = (k >> 3) == 0 ? 1.000001f
                        : (k >> 3) == 2 ? 4.000004f : 2.000002f;
        c[j] = __fdiv_rn(m, c[j]);
      } else if constexpr (kVar == SQRT_PAR8) {
        c[j] = __fsqrt_rn(c[j]);
      } else if constexpr (kVar == SINCOS) {
        c[j] = (j & 1) ? cosf(c[j]) : sinf(c[j]);
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s = s + c[j];
  out[i] = s;
}

template <int kVar>
int launch(const float* x, float* out, int n, int iters, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) op_rate<kVar><<<blocks, kThreads, 0, s>>>(x, out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch variant `variant` (the enum above, in the order of
// probes/op_rate.py VARIANTS) on n threads, x and out f32 [n] on the
// device. Returns the cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int pt_op_rate_launch(const float* x, float* out, int n,
                                 int iters, int variant, void* stream) {
  if (n < 0 || iters < 1 || x == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FMA_DEP: return launch<FMA_DEP>(x, out, n, iters, s);
    case FMA_PAR8: return launch<FMA_PAR8>(x, out, n, iters, s);
    case MUL_PAR8: return launch<MUL_PAR8>(x, out, n, iters, s);
    case ADD_PAR8: return launch<ADD_PAR8>(x, out, n, iters, s);
    case CMP_SEL: return launch<CMP_SEL>(x, out, n, iters, s);
    case LEAFMIX: return launch<LEAFMIX>(x, out, n, iters, s);
    case DIV_PAR8: return launch<DIV_PAR8>(x, out, n, iters, s);
    case SQRT_PAR8: return launch<SQRT_PAR8>(x, out, n, iters, s);
    case SINCOS: return launch<SINCOS>(x, out, n, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
