// Pieces shared by cholesky.cu and gp.cu (each .cu compiles on its own into
// its own library and includes this header):
//  * the blocked Cholesky's tile edge and threads per block;
//  * the GP covariance arithmetic of gp.cu, in the order of the plain
//    versions (repro_torch/kernels/ref.py: gp_sqdist_ref, gp_kernel_fn):
//    one rounded multiply and one rounded add per feature, IEEE division,
//    sqrtf and expf, no FMA contraction, so that every kernel that assembles
//    a covariance through it equals the plain version bitwise on the card.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

constexpr int kSqdist = 0;
constexpr int kMatern52 = 1;
constexpr int kRbf = 2;

// sum_k a[k * sa] * b[k * sb] over d >= 1 features, from the product of
// feature 0 upwards, each product and sum rounded on its own
__device__ __forceinline__ float dot_rn(const float* a, int sa,
                                        const float* b, int sb, int d) {
  float s = __fmul_rn(a[0], b[0]);
  for (int k = 1; k < d; ++k) s = __fadd_rn(s, __fmul_rn(a[k * sa], b[k * sb]));
  return s;
}

// maximum((|a|^2 + |b|^2) - 2 a.b, 0), NaN kept
__device__ __forceinline__ float gp_d2(float n1, float n2, float cross) {
  const float d2 = __fsub_rn(__fadd_rn(n1, n2), __fmul_rn(2.0f, cross));
  return d2 > 0.0f ? d2 : (d2 != d2 ? d2 : 0.0f);
}

// The covariance of squared distance d2: kMatern52, kRbf, or d2 itself
// (kSqdist). ls2 = lengthscale * lengthscale, rounded.
__device__ __forceinline__ float gp_cov(float d2, int kind, float lengthscale,
                                        float ls2, float variance) {
  if (kind == kMatern52) {
    const float s5 = sqrtf(5.0f);
    const float c53 = 5.0f / 3.0f;
    const float rr = __fdiv_rn(d2 > 0.0f ? sqrtf(d2) : 0.0f, lengthscale);
    const float poly = __fadd_rn(__fadd_rn(1.0f, __fmul_rn(s5, rr)),
                                 __fmul_rn(c53, __fmul_rn(rr, rr)));
    return __fmul_rn(__fmul_rn(variance, poly), expf(__fmul_rn(-s5, rr)));
  }
  if (kind == kRbf) {
    return __fmul_rn(variance, expf(__fdiv_rn(__fmul_rn(-0.5f, d2), ls2)));
  }
  return d2;
}

}  // namespace
