// Blocked triangular solve L X = B (forward) or L^T X = B (backward) through
// explicit inverses of the diagonal tiles, for sm_90a.
//
// Replaces: src/repro/kernels/cholesky.py::tri_solve_blocked, the Pallas TPU
// kernels _diag_inv_kernel, _solve_fwd_kernel and _solve_bwd_kernel. The
// archive-scale inducing fit (explore/bigfit.py::fit_inducing) solves
// L_m A = K_mn with it: L (512, 512), B (512, 50,000).
//
// Bound on the H100: operations. The solve does about n^2 m / 2
// multiply-adds (n^2 m flops, plus n * 64 * m for the products with the tile
// inverses) on (n^2 + 2 n m) * 4 bytes: at n = 512, m = 50,000 that is
// ~1.4e10 flops, ~0.2 ms at the 67 TFLOP/s of f32 outside the tensor cores,
// against ~0.06 ms of bytes. No TF32 and no tensor cores here: the kernel is
// held to its plain f32 version within a stated tolerance.
//
// Design. The TPU kernel runs the row-block axis in sequence on one core and
// keeps the solved X panel in VMEM. Here:
//  * trisolve_diag_inv_kernel: one block per 64 x 64 diagonal tile inverts
//    it by forward substitution in shared memory (thread j owns column j;
//    tile.cuh's tri_inv_tile, shared with the blocked Cholesky).
//    A (256, 256) f32 tile would be 256 KB, more than a block's 227 KB of
//    shared memory, so the kernel tiles at 64 whatever `block` the caller
//    pads to (the Python wrapper keeps block/rhs_block for the reference's
//    padding contract).
//  * trisolve_kernel: one block owns a strip of 64 RHS columns and walks the
//    row blocks in order itself: acc = B_r - sum_j L_rj X_j (or L_jr^T X_j),
//    then X_r = Linv_r acc (or Linv_r^T acc), written to X. The X blocks it
//    solved earlier are read back from X (L2-resident: the block wrote them
//    moments before, after a __syncthreads), never through the read-only
//    path. Every 64 x 64 x 64 product runs from two shared-memory tiles into
//    a 4 x 4 register tile per thread (256 threads; tile.cuh's
//    tile_product), columns strided by 16
//    so that shared-memory reads and global writes stay conflict-free and
//    coalesced. The strips are independent, so m / 64 blocks fill the card.
#include "tile.cuh"

namespace {

__global__ void trisolve_diag_inv_kernel(const float* __restrict__ l, int n,
                                         float* __restrict__ linv) {
  __shared__ float s_l[kTile * kPad];
  __shared__ float s_inv[kTile * kPad];
  const int t = blockIdx.x;
  const size_t base = static_cast<size_t>(t) * kTile * n + t * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
    const int i = e / kTile, k = e % kTile;
    s_l[i * kPad + k] = l[base + static_cast<size_t>(i) * n + k];
  }
  __syncthreads();
  tri_inv_tile(s_l, s_inv);
  __syncthreads();
  float* out = linv + static_cast<size_t>(t) * kTile * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
    out[e] = s_inv[(e / kTile) * kPad + (e % kTile)];
  }
}

__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const float* __restrict__ l, const float* __restrict__ linv,
                const float* __restrict__ b, int n, int m, int trans,
                float* x) {
  __shared__ float s_a[kTile * kPad];
  __shared__ float s_b[kTile * kPad];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * kTile;
  const int nb = n / kTile;
  for (int step = 0; step < nb; ++step) {
    const int r = trans ? nb - 1 - step : step;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = b[static_cast<size_t>(r * kTile + ty + 16 * a) * m + c0 +
                      tx + 16 * c];
      }
    }
    // subtract the products with the row blocks solved before this one
    for (int s = 0; s < step; ++s) {
      const int j = trans ? nb - 1 - s : s;
      const float* lt = trans
          ? l + static_cast<size_t>(j) * kTile * n + r * kTile    // L_jr
          : l + static_cast<size_t>(r) * kTile * n + j * kTile;   // L_rj
      load_left(s_a, lt, n, trans != 0);
      load_right(s_b, x + static_cast<size_t>(j) * kTile * m + c0, m);
      __syncthreads();
      tile_product(acc, s_a, s_b, tx, ty, -1.0f);
      __syncthreads();
    }
    // X_r = Linv_r acc (forward) or Linv_r^T acc (backward)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_b[(ty + 16 * a) * kPad + tx + 16 * c] = acc[a][c];
        acc[a][c] = 0.0f;
      }
    }
    load_left(s_a, linv + static_cast<size_t>(r) * kTile * kTile, kTile,
              trans != 0);
    __syncthreads();
    tile_product(acc, s_a, s_b, tx, ty, 1.0f);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[static_cast<size_t>(r * kTile + ty + 16 * a) * m + c0 + tx +
          16 * c] = acc[a][c];
      }
    }
    __syncthreads();   // X_r visible to the whole block before it is read
  }
}

}  // namespace

extern "C" int tri_solve_launch(const float* l, const float* b, int n, int m,
                                int trans, float* linv, float* x,
                                cudaStream_t stream) {
  if (n == 0 || m == 0) return 0;
  if (n % kTile != 0 || m % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trisolve_diag_inv_kernel<<<n / kTile, kTile, 0, stream>>>(l, n, linv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  trisolve_kernel<<<m / kTile, kThreads, 0, stream>>>(l, linv, b, n, m, trans,
                                                      x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
