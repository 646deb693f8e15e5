// Pairwise Pareto-dominance sweeps for NSGA-II ranking, for sm_90a.
//
// Replaces: src/repro/kernels/dominance.py::dominance_pass (Pallas body
// _fused_kernel) and ::dominated_counts (Pallas body _count_kernel).
//   dominance_pass:   counts[i] = #{j : cols[j] dominates rows[i], same
//                     group}, plus the packed bitmap — bit (j % 32) of word
//                     bitmap[i][j / 32] set iff cols[j] dominates rows[i].
//   dominated_counts: the counts of the square sweep alone, no groups.
// "j dominates i" means all(F_j <= F_i) and any(F_j < F_i) (minimize).
//
// Bound on the H100: operations. The sweep makes Ni*Nj*2M float compares on
// (Ni + Nj)*M*4 B of input and writes Ni*4 B of counts plus Ni*Nj/8 B of
// bitmap; at M = 3 that is 48 compares per bitmap byte against the card's
// 20 f32 operations per HBM byte, so the compare rate (67 TFLOP/s) is the
// limit once the sweep is large enough to fill the card.
//
// Design: one warp owns one row i and walks the column words. Lane l tests
// column j0 + l; __ballot_sync turns the 32 answers into the bitmap word in
// the reference's bit order directly, and the count is the sum of __popc over
// the words, so no atomics and no shared memory are needed. The kernel masks
// the ragged edge itself (bits past Nj are 0) instead of padding with +BIG
// rows. A null group pointer means group 0 for every row of that side.
// Outputs are integers, so they equal the plain PyTorch version exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ bool dominates(const float* __restrict__ col,
                                          const float* __restrict__ row, int m) {
  bool le = true;
  bool lt = false;
  for (int k = 0; k < m; ++k) {
    const float a = col[k];
    const float b = row[k];
    le = le && (a <= b);
    lt = lt || (a < b);
  }
  return le && lt;
}

__global__ void dominance_pass_kernel(const float* __restrict__ rows,
                                      const float* __restrict__ cols,
                                      const int* __restrict__ g_rows,
                                      const int* __restrict__ g_cols, int ni,
                                      int nj, int m, int n_words,
                                      int* __restrict__ counts,
                                      unsigned* __restrict__ bitmap) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= ni) return;  // uniform across the warp
  const float* row = rows + static_cast<size_t>(i) * m;
  const int g = g_rows ? g_rows[i] : 0;
  int count = 0;
  for (int w = 0; w < n_words; ++w) {
    const int j = w * 32 + lane;
    bool dom = false;
    if (j < nj && (g_cols ? g_cols[j] : 0) == g)
      dom = dominates(cols + static_cast<size_t>(j) * m, row, m);
    const unsigned word = __ballot_sync(0xffffffffu, dom);
    if (lane == 0) bitmap[static_cast<size_t>(i) * n_words + w] = word;
    count += __popc(word);
  }
  if (lane == 0) counts[i] = count;
}

__global__ void dominated_counts_kernel(const float* __restrict__ obj, int n,
                                        int m, int* __restrict__ counts) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float* row = obj + static_cast<size_t>(i) * m;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool dom = j < n && dominates(obj + static_cast<size_t>(j) * m, row, m);
    count += __popc(__ballot_sync(0xffffffffu, dom));
  }
  if (lane == 0) counts[i] = count;
}

}  // namespace

extern "C" int dominance_pass_launch(const float* rows, const float* cols,
                                     const int* g_rows, const int* g_cols,
                                     int ni, int nj, int m, int* counts,
                                     unsigned* bitmap, cudaStream_t stream) {
  if (ni == 0) return 0;
  const int n_words = (nj + 31) / 32;
  const int blocks = (ni + kWarps - 1) / kWarps;
  dominance_pass_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      rows, cols, g_rows, g_cols, ni, nj, m, n_words, counts, bitmap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dominated_counts_launch(const float* obj, int n, int m,
                                       int* counts, cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  dominated_counts_kernel<<<blocks, kWarps * 32, 0, stream>>>(obj, n, m, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
