// Pieces shared by the port's CUDA sources (each .cu compiles on its own
// into its own library and includes this header):
//  * the tile edge and block size of the blocked Cholesky and the
//    triangular solve, and the triangular solve's 64 x 64 tile machinery:
//    shared-memory tile loads, the 64 x 64 x 64 tile product into a 4 x 4
//    register tile per thread, and the inverse of a lower-triangular tile
//    by forward substitution;
//  * the GP covariance arithmetic of gp.cu, in the order of the plain
//    versions (repro_torch/kernels/ref.py: gp_sqdist_ref, gp_kernel_fn):
//    one rounded multiply and one rounded add per feature, IEEE division,
//    sqrtf and expf, no FMA contraction, so that every kernel that assembles
//    a covariance through it equals the plain version bitwise on the card.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kPad = kTile + 1;   // shared-memory row stride: no bank conflicts
constexpr int kThreads = 256;     // 16 x 16 threads, each a 4 x 4 register tile

constexpr int kSqdist = 0;
constexpr int kMatern52 = 1;
constexpr int kRbf = 2;

// Inverse of the lower-triangular 64 x 64 tile s_l (stride kPad) into s_inv
// (stride kPad) by forward substitution on the identity. Thread j < 64 owns
// column j and reads only the column it writes, so no barrier is needed
// inside; the caller synchronises before and after.
__device__ void tri_inv_tile(const float* s_l, float* s_inv) {
  const int j = threadIdx.x;
  if (j >= kTile) return;
  for (int i = 0; i < kTile; ++i) {
    float v = 0.0f;
    if (i >= j) {
      float s = i == j ? 1.0f : 0.0f;
      for (int k = j; k < i; ++k) {
        s = fmaf(-s_l[i * kPad + k], s_inv[k * kPad + j], s);
      }
      v = s / s_l[i * kPad + i];
    }
    s_inv[i * kPad + j] = v;
  }
}

// s_a[k][i] = A[i][k] of a 64 x 64 tile of row-major `src` (leading
// dimension ld): A = src, or A = src^T when `transpose`.
__device__ void load_left(float* s_a, const float* src, size_t ld,
                          bool transpose) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int row = e / kTile, col = e % kTile;
    const float v = src[static_cast<size_t>(row) * ld + col];
    if (transpose) {
      s_a[row * kPad + col] = v;   // A[col][row] = src[row][col]
    } else {
      s_a[col * kPad + row] = v;   // A[row][col] = src[row][col]
    }
  }
}

// s_b[k][c] = the 64 x 64 tile of row-major `src` (leading dimension ld)
__device__ void load_right(float* s_b, const float* src, size_t ld) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int row = e / kTile, col = e % kTile;
    s_b[row * kPad + col] = src[static_cast<size_t>(row) * ld + col];
  }
}

// acc[a][b] += sign * sum_k A[ty + 16a][k] * B[k][tx + 16b], with
// s_a[k][i] = A[i][k] and s_b[k][c] = B[k][c]
__device__ void tile_product(float (&acc)[4][4], const float* s_a,
                             const float* s_b, int tx, int ty, float sign) {
#pragma unroll 8
  for (int k = 0; k < kTile; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = sign * s_a[k * kPad + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = s_b[k * kPad + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

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
