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
// The Matern epilogue's IEEE sqrtf, division and expf cost ~50 more
// instructions an element, which puts its issue floor above the byte bound
// (chip_smoke.py prints the row loop's SASS count and that issue floor).
//
// Design: a 2-D grid of output tiles, kCols = 512 columns by up to kMaxRows
// rows, 128 threads a block, each thread 4 adjacent columns. A thread keeps
// its 4 columns of x2 and their norms in registers (D 2 and 8, the shapes
// the paths use; any other D reads x2 through L1), the block stages its x1
// rows with their norms in shared memory once, and each trip of the row
// loop computes 4 independent outputs and writes them as one 16-byte
// evict-first store (__stcs: the 102 MB output is twice the L2), or as 4
// scalar stores where N2 % 4 != 0 leaves rows off a 16-byte boundary. The
// rows a block takes are chosen in Python (kernels/gp.py::launch_config)
// from the shape, the SM count and the kernel's occupancy, so that the grid
// fills the card in whole waves (a (3, 3) call takes a block a row).
// Epilogue, feature count and store width are template parameters, so a
// kernel's row loop carries no branch on them. No (N1, N2, D) intermediate
// exists.
//
// Every sum over D runs in the order of the plain version
// (repro_torch/kernels/ref.py::gp_sqdist_ref): the product of column 0, then
// one rounded multiply and one rounded add per further column; the
// __f*_rn intrinsics keep nvcc from forming FMAs, so the distances equal the
// plain version bitwise on the card. The epilogues use IEEE division, sqrtf
// and expf (no --use_fast_math) in the plain gp_kernel_fn's order. That
// arithmetic (gp_d2, gp_cov) lives in tile.cuh, which the blocked
// Cholesky's fused assembly (cholesky.cu) shares.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit with
// tools/compare_trees.py --gp (medians of 20 queued samples, the kernel
// before this design and after in turns): at (512, 50,000, d 2)
// gp_sqdist 0.0538 -> 0.0359 ms (85 % of its 0.0307 ms byte bound),
// Matern 0.0881 -> 0.0549 ms, RBF 0.0715 -> 0.0380 ms; at (4096, 4096,
// d 8) 0.0734 -> 0.0399, 0.0975 -> 0.0636 and 0.0869 -> 0.0489 ms; the
// (3, 3) call 3.19 -> 2.30 us. The Matern row loop issues ~62 SASS
// instructions an output (its IEEE sqrtf and division), an issue floor of
// ~0.048 ms at (512, 50,000), which the kernel runs at 87 % of.
#include "tile.cuh"

namespace {

constexpr int kGpThreads = 128;
constexpr int kVec = 4;                        // adjacent columns a thread
constexpr int kCols = kGpThreads * kVec;       // output columns a block
constexpr int kMaxRows = 64;                   // output rows a block
constexpr int kMaxDim = 32;

// Floats a staged x1 row takes: its D features, its norm, padding to 16
// bytes (D > 0); the generic kernel (D == 0) strides kMaxDim + 1.
template <int D>
constexpr int kRowStride = D > 0 ? (D + 4) / 4 * 4 : kMaxDim + 1;

// sum_k a[k] b[k] over D features in dot_rn's order, from registers
template <int D>
__device__ __forceinline__ float dot_regs(const float (&a)[D],
                                          const float (&b)[D]) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = __fadd_rn(s, __fmul_rn(a[k], b[k]));
  return s;
}

// Block (column tile, row group): rows [i0, i0 + rows) and columns
// [512 bx, 512 bx + 512) of the output; thread t owns columns j0 .. j0 + 3.
// D > 0: d == D, x2 in registers; D == 0: any d, x2 read through L1 every
// row. VEC: N2 % 4 == 0, so each row's 4 columns take one 16-byte store.
template <int D, int KIND, bool VEC>
__global__ void __launch_bounds__(kGpThreads)
gp_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
          int n1, int n2, int d, int rows_per_block, float lengthscale,
          float variance, float* __restrict__ out) {
  constexpr int S = kRowStride<D>;
  __shared__ __align__(16) float s_rows[kMaxRows * S];   // [row][k], norm

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kCols + kVec * t;
  const int i0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n1 - i0);

  // stage the block's rows and their norms (one thread a row)
  if (t < rows) {
    const float* a = x1 + static_cast<size_t>(i0 + t) * d;
    float* dst = s_rows + t * S;
    if constexpr (D > 0) {
      float av[D];
#pragma unroll
      for (int k = 0; k < D; ++k) av[k] = a[k];
#pragma unroll
      for (int k = 0; k < D; ++k) dst[k] = av[k];
      dst[D] = dot_regs<D>(av, av);
    } else {
      for (int k = 0; k < d; ++k) dst[k] = a[k];
      dst[d] = dot_rn(a, 1, a, 1, d);
    }
  }
  __syncthreads();
  if (j0 >= n2) return;

  // this thread's columns (the last in range repeated past N2: never stored)
  const float* b[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    b[c] = x2 + static_cast<size_t>(min(j0 + c, n2 - 1)) * d;
  }
  const float ls2 = __fmul_rn(lengthscale, lengthscale);
  float* o = out + static_cast<size_t>(i0) * n2 + j0;

  if constexpr (D > 0) {
    float bv[kVec][D], bn[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
#pragma unroll
      for (int k = 0; k < D; ++k) bv[c][k] = __ldg(b[c] + k);
      bn[c] = dot_regs<D>(bv[c], bv[c]);
    }
#pragma unroll 1
    for (int r = 0; r < rows; ++r, o += n2) {
      float a[S];
#pragma unroll
      for (int k = 0; k < S; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(s_rows + r * S + k);
        a[k] = v.x, a[k + 1] = v.y, a[k + 2] = v.z, a[k + 3] = v.w;
      }
      float av[D];
#pragma unroll
      for (int k = 0; k < D; ++k) av[k] = a[k];
      float v[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        v[c] = gp_cov(gp_d2(a[D], bn[c], dot_regs<D>(av, bv[c])), KIND,
                      lengthscale, ls2, variance);
      }
      if constexpr (VEC) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2],
                                                         v[3]));
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          if (j0 + c < n2) __stcs(o + c, v[c]);
        }
      }
    }
  } else {
    float bn[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) bn[c] = dot_rn(b[c], 1, b[c], 1, d);
#pragma unroll 1
    for (int r = 0; r < rows; ++r, o += n2) {
      const float* a = s_rows + r * S;
      float v[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        v[c] = gp_cov(gp_d2(a[d], bn[c], dot_rn(a, 1, b[c], 1, d)), KIND,
                      lengthscale, ls2, variance);
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        if (j0 + c < n2) __stcs(o + c, v[c]);
      }
    }
  }
}

// The kernel for feature count d (2 and 8 have their own; any other d the
// generic one), epilogue `kind` and store width.
using GpKernel = void (*)(const float*, const float*, int, int, int, int,
                          float, float, float*);

template <int D, bool VEC>
GpKernel pick_kind(int kind) {
  return kind == kMatern52 ? gp_kernel<D, kMatern52, VEC>
         : kind == kRbf    ? gp_kernel<D, kRbf, VEC>
                           : gp_kernel<D, kSqdist, VEC>;
}

GpKernel pick(int d, int kind, bool vec) {
  if (d == 2) {
    return vec ? pick_kind<2, true>(kind) : pick_kind<2, false>(kind);
  }
  if (d == 8) {
    return vec ? pick_kind<8, true>(kind) : pick_kind<8, false>(kind);
  }
  return pick_kind<0, false>(kind);   // column by column whatever N2 is
}

bool bad_args(int d, int kind) {
  return d < 1 || d > kMaxDim || kind < kSqdist || kind > kRbf;
}

}  // namespace

// out (n1, n2) from x1 (n1, d) and x2 (n2, d): a grid of ceil(n2 / 512)
// column tiles by ceil(n1 / rows_per_block) row groups.
extern "C" int gp_launch(const float* x1, const float* x2, int n1, int n2,
                         int d, int kind, int rows_per_block,
                         float lengthscale, float variance, float* out,
                         cudaStream_t stream) {
  if (n1 == 0 || n2 == 0) return 0;
  if (bad_args(d, kind) || rows_per_block < 1 ||
      rows_per_block > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n2 + kCols - 1) / kCols,
                  (n1 + rows_per_block - 1) / rows_per_block);
  pick(d, kind, n2 % kVec == 0)<<<grid, kGpThreads, 0, stream>>>(
      x1, x2, n1, n2, d, rows_per_block, lengthscale, variance, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel that gp_launch picks for (d, kind, n2 % 4 == 0)
// resident on one SM of the current device, into *blocks.
extern "C" int gp_blocks_per_sm(int d, int kind, int vec, int* blocks) {
  if (bad_args(d, kind)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pick(d, kind, vec != 0), kGpThreads, 0));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
