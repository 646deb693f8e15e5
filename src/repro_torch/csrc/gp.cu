// GP covariance assembly: squared distances, optionally mapped through the
// Matern-5/2 or RBF covariance, for sm_90a.
//
// Replaces: src/repro/kernels/gp.py::gp_sqdist and ::gp_matrix, the Pallas
// TPU kernel (_sqdist_kernel / _matrix_kernel through _tiled_call) that the
// surrogate's GP fit (explore/surrogate.py::gp_fit) and the archive-scale
// inducing fit (explore/bigfit.py: select_lengthscale, _cross_cov) call.
//
// Bound on the H100: memory. The output is (N1, N2) f32 and the inputs are
// (N1 + N2) x D floats with D tiny (2 here, at most 32): about 3D + 4
// operations per output element against 4 bytes written, while the card does
// 20 f32 operations per byte its HBM moves. At the archive-scale shape
// (512 x 50,000) the output is 102 MB, a bound of ~0.031 ms at 3.35 TB/s.
//
// Design: a 2-D grid of output tiles, kRows rows by kCols columns, one thread
// per column. The block stages its kCols x2 rows in shared memory (column
// major, so each thread reads its own column conflict-free) and its kRows x1
// rows (read by every thread as broadcasts), computes the kRows row norms
// once, keeps its column's norm in a register, and writes one output row at a
// time, coalesced along N2. No (N1, N2, D) intermediate exists anywhere.
// Every sum over D runs in the order of the plain version
// (repro_torch/kernels/ref.py::gp_sqdist_ref): the product of column 0, then
// one rounded multiply and one rounded add per further column; the
// __f*_rn intrinsics keep nvcc from forming FMAs, so the distances equal the
// plain version bitwise on the card. The epilogues use IEEE division, sqrtf
// and expf (no --use_fast_math) in the plain gp_kernel_fn's order. That
// arithmetic (dot_rn, gp_d2, gp_cov) lives in tile.cuh, which the blocked
// Cholesky's fused assembly (cholesky.cu) shares.
#include "tile.cuh"

namespace {

constexpr int kCols = 256;   // threads per block = output columns per tile
constexpr int kRows = 16;    // output rows per tile
constexpr int kMaxDim = 32;

__global__ void gp_kernel(const float* __restrict__ x1,
                          const float* __restrict__ x2, int n1, int n2, int d,
                          int kind, float lengthscale, float variance,
                          float* __restrict__ out) {
  __shared__ float s_x2[kMaxDim * kCols];   // [k][column]
  __shared__ float s_x1[kRows * kMaxDim];   // [row][k]
  __shared__ float s_n1[kRows];

  const int t = threadIdx.x;
  const int j = blockIdx.x * kCols + t;
  const int i0 = blockIdx.y * kRows;
  const int rows = min(kRows, n1 - i0);

  // stage the tile's inputs (rows past the edge stay unread)
  for (int k = 0; k < d; ++k) {
    s_x2[k * kCols + t] = j < n2 ? x2[static_cast<size_t>(j) * d + k] : 0.0f;
  }
  for (int e = t; e < rows * d; e += kCols) {
    s_x1[(e / d) * kMaxDim + (e % d)] = x1[static_cast<size_t>(i0) * d + e];
  }
  __syncthreads();
  if (t < rows) {
    const float* a = s_x1 + t * kMaxDim;
    s_n1[t] = dot_rn(a, 1, a, 1, d);
  }
  __syncthreads();
  if (j >= n2) return;

  const float n2j = dot_rn(s_x2 + t, kCols, s_x2 + t, kCols, d);
  const float ls2 = __fmul_rn(lengthscale, lengthscale);
  for (int r = 0; r < rows; ++r) {
    const float cross = dot_rn(s_x1 + r * kMaxDim, 1, s_x2 + t, kCols, d);
    const float v = gp_cov(gp_d2(s_n1[r], n2j, cross), kind, lengthscale, ls2,
                           variance);
    out[static_cast<size_t>(i0 + r) * n2 + j] = v;
  }
}

}  // namespace

extern "C" int gp_launch(const float* x1, const float* x2, int n1, int n2,
                         int d, int kind, float lengthscale, float variance,
                         float* out, cudaStream_t stream) {
  if (n1 == 0 || n2 == 0) return 0;
  if (d < 1 || d > kMaxDim || kind < kSqdist || kind > kRbf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n2 + kCols - 1) / kCols, (n1 + kRows - 1) / kRows);
  gp_kernel<<<grid, kCols, 0, stream>>>(x1, x2, n1, n2, d, kind, lengthscale,
                                        variance, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
