// Pairwise Pareto-dominance sweeps for NSGA-II ranking, for sm_90a.
//
// Replaces: src/repro/kernels/dominance.py::dominance_pass (Pallas body
// _fused_kernel) and ::dominated_counts (Pallas body _count_kernel).
//   dominance_pass:   counts[i] = #{j : cols[j] dominates rows[i], same
//                     group}, plus the packed bitmap — bit (j % 32) of word
//                     bitmap[i][j / 32] set iff cols[j] dominates rows[i].
//   dominated_counts: the counts of the square sweep alone, no groups.
// "j dominates i" means all(F_j <= F_i) and any(F_j < F_i) (minimize), as
// IEEE compares say: -0 equals +0, and a NaN neither dominates nor is
// dominated.
//
// Bound on the H100: instruction issue. The sweep reads (Ni + Nj)*M*4 B and
// writes Ni*4 B of counts and Ni*Nj/8 B of bitmap, but does Ni*Nj pair tests;
// at M = 3 that is 8 pairs per bitmap byte against the card's ~20 issued
// instructions per HBM byte, so the pair test's instruction count sets the
// pace. Written as float compares it costs 2M FSETPs a pair on the
// half-rate ALU pipe (16 lanes a scheduler): dominance_probe_kernel measured
// 7.0 pairs a cycle of an SM that way on an H100, and 16.9 with the
// subtractions below.
//
// Design:
// - The pair test as subtractions. For finite floats (-0 made +0), d_q =
//   row_q - col_q is exact in sign and +0 iff the two are equal (gradual
//   underflow: a difference of two floats never rounds to 0; an overflow
//   keeps its sign). So "col dominates row" iff no d_q is negative and one
//   is positive, iff s = OR of the d_q's bits is > 0 as an int: M FADDs on
//   the full-rate FMA pipe and one LOP3 for three objectives; 0 - s carries
//   the answer in bit 31 into the row's word by one funnel shift. Infinities
//   (inf - inf is NaN) and NaNs break it, so each pass checks its rows and
//   columns (__syncthreads_or at the barrier it has anyway) and a pass that
//   holds one takes the IEEE compares instead. Bits past Nj are masked off
//   each word.
// - Tiles. A block of 8 warps owns 128 rows, 4 a thread (row 32r + lane of
//   the tile), their values in registers, and a range of column words (its
//   split; kernels/dominance.py::launch_config chooses the splits from the
//   shapes and the SM count). It walks the range in passes of 8 words: the
//   pass's 256 columns (and group ids) are staged in shared memory, double
//   buffered, the next pass's loaded from global memory while this one is
//   computed; warp w computes word w of the pass for the 128 rows, every
//   lane reading the same column (a broadcast, no bank conflict), so each
//   column load serves 4 rows. M is a template parameter (1..8, the tests
//   unrolled); M = 0 is the generic path for any M, which compares values
//   read from global memory.
// - Bits in registers: columns are taken from 31 down to 0, each pair's bit
//   shifted into its row's word; no ballot. The pass's 128 x 8 word tile goes
//   through shared memory and leaves as two 16-byte stores a row.
// - Counts are __popc of the words, summed over the block's warps in shared
//   memory. Where the columns of a row are split over several blocks, each
//   block adds its sum with one integer atomicAdd a row (exact, in any
//   order) onto counts zeroed by a memset on the same stream: a second pass
//   would cost a launch more.
// - Groups: a 32-row slice and a 32-column word whose group ranges [min,
//   max] do not meet skip the slice's pair tests (zero bits); otherwise
//   each pair compares the group ids. Sorted islands (8 groups of 32 rows)
//   skip 7/8 of the pairs; unsorted groups take the per-pair test.
// Outputs are integers, so they equal the plain PyTorch version exactly.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                    // rows a thread
constexpr int kTileRows = 32 * kRows;       // 128 rows a block
constexpr int kPassWords = kWarps;          // one word a warp a pass
constexpr int kPassCols = 32 * kPassWords;  // 256 columns a pass
constexpr int kTilePad = 4;                 // word tile: conflict-free reads
static_assert(kThreads == 2 * kTileRows, "two 16-byte stores a row");

struct Args {
  const float* rows;
  const float* cols;
  const int* g_rows;  // null: group 0 for every row
  const int* g_cols;  // null: group 0 for every column
  int ni, nj, m, n_words, split_words;
  int* counts;
  unsigned* bitmap;   // null for the counts-only sweep
  bool accumulate;    // the columns are split over blocks: atomicAdd
  long long* phases;  // null, or block (0, 0)'s phase clocks (kPhases)
};

// Phases of block (0, 0) that dominance_pass_phases_launch records, each as
// 8 SM clocks (lane 0 of each warp): entry, rows loaded, pass 0 staged, pass
// 0 computed, pass 0 stored, every pass done, counts summed, exit.
constexpr int kPhases = 8;

// Floats a staged column takes in shared memory (16-byte loads from 3 up).
template <int M>
__host__ __device__ constexpr int col_stride() {
  return M <= 2 ? M : (M <= 4 ? 4 : 8);
}

// Bit 31 set iff the column (values c) dominates the row (r), both finite
// with -0 made +0: s = OR of the bits of the differences is > 0 as an int.
template <int M>
__device__ __forceinline__ unsigned sub_bit(const float (&r)[M],
                                            const float (&c)[M]) {
  unsigned s = 0;
#pragma unroll
  for (int q = 0; q < M; ++q) s |= __float_as_uint(__fsub_rn(r[q], c[q]));
  return 0u - s;
}

// The same bit from IEEE compares, for any values.
template <int M>
__device__ __forceinline__ unsigned cmp_bit(const float (&r)[M],
                                            const float (&c)[M]) {
  bool le = true, lt = false;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    le &= c[q] <= r[q];
    lt |= c[q] < r[q];
  }
  return le && lt ? 0x80000000u : 0u;
}

__device__ __forceinline__ unsigned cmp_bit_generic(const float* row,
                                                    const float* col, int m) {
  bool le = true, lt = false;
  for (int q = 0; q < m; ++q) {
    le &= col[q] <= row[q];
    lt |= col[q] < row[q];
  }
  return le && lt ? 0x80000000u : 0u;
}

template <int M>
__device__ __forceinline__ void load_col(const float* p, float (&c)[M]) {
  if constexpr (M <= 2) {
#pragma unroll
    for (int q = 0; q < M; ++q) c[q] = p[q];
  } else {
#pragma unroll
    for (int q = 0; q < M; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      c[q] = v.x;
      if (q + 1 < M) c[q + 1] = v.y;
      if (q + 2 < M) c[q + 2] = v.z;
      if (q + 3 < M) c[q + 3] = v.w;
    }
  }
}

// Bits of a word's columns that exist: all but those past Nj.
__device__ __forceinline__ unsigned col_mask(int word, int nj) {
  const int n = nj - 32 * word;
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// One word of pair bits: the 32 columns staged at base (group ids at gbase,
// their range [c_lo, c_hi]) against this thread's rows, by subtractions
// (kSub) or IEEE compares. Ungrouped, each column load serves the 4 rows,
// whose 4 words are independent chains. Grouped, a 32-row slice whose
// group range does not meet the columns' is skipped (warp-uniform) and the
// slices go one at a time. One slice alone is the whole work of a warp in
// sorted islands, so its word is built as 4 bytes, 4 columns a step, and
// each step's loads are issued before the previous step's tests (the
// __syncwarp keeps the compiler from sinking them into the tests): the
// loads' latency, not the tests, set the pace of a lone slice.
template <int M, bool kGroups, bool kSub>
__device__ __forceinline__ void word_bits(
    const float* base, const int* gbase, int c_lo, int c_hi,
    const float (&rv)[kRows][M], const int (&rg)[kRows],
    const int (&g_lo)[kRows], const int (&g_hi)[kRows],
    unsigned (&bits)[kRows]) {
  constexpr int kStride = col_stride<M>();
  auto pair = [&](int r, const float (&c)[M]) {
    return kSub ? sub_bit<M>(rv[r], c) : cmp_bit<M>(rv[r], c);
  };
  if constexpr (kGroups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (g_lo[r] > c_hi || c_lo > g_hi[r]) continue;
      float c[2][4][M];
      int g[2][4];
      auto load = [&](int i, int buf) {  // column 8(3 - b) + i of byte b
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          load_col<M>(base + (8 * (3 - b) + i) * kStride, c[buf][b]);
          g[buf][b] = gbase[8 * (3 - b) + i];
        }
      };
      unsigned part[4] = {};
      load(7, 0);
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        const int buf = (7 - i) & 1;  // load(7) went to buffer 0
        if (i > 0) load(i - 1, buf ^ 1);
        __syncwarp();
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned x = g[buf][b] == rg[r] ? pair(r, c[buf][b]) : 0u;
          part[b] = __funnelshift_l(x, part[b], 1);
        }
      }
      bits[r] = part[0] << 24 | part[1] << 16 | part[2] << 8 | part[3];
    }
  } else {
#pragma unroll
    for (int k = 31; k >= 0; --k) {
      float c[M];
      load_col<M>(base + k * kStride, c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        bits[r] = __funnelshift_l(pair(r, c), bits[r], 1);
    }
  }
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// With a.phases: block (0, 0)'s SM clock at `phase`, a value a warp; and
// at entry and exit, each block's SM and global time, after the phases:
// {sm, entry ns, exit ns} a block.
__device__ __forceinline__ void mark(const Args& a, int phase) {
  if (!a.phases) return;
  if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0)
    a.phases[phase * kWarps + (threadIdx.x >> 5)] = clock64();
  if (threadIdx.x == 0 && (phase == 0 || phase == kPhases - 1)) {
    long long* row = a.phases + kPhases * kWarps +
                     3 * (static_cast<size_t>(blockIdx.y) * gridDim.x +
                          blockIdx.x);
    row[0] = sm_id();
    row[phase == 0 ? 1 : 2] = global_ns();
  }
}

template <int M, bool kGroups, bool kBitmap>
__global__ void __launch_bounds__(kThreads) dominance_kernel(const Args a) {
  constexpr int kM = M > 0 ? M : 1;
  constexpr int kStride = M > 0 ? col_stride<M>() : 1;
  __shared__ __align__(16) float col_vals[2][M > 0 ? kPassCols * kStride : 1];
  __shared__ int col_groups[2][kGroups && M > 0 ? kPassCols : 1];
  __shared__ unsigned tile[2][kBitmap ? kPassWords : 1][kTileRows + kTilePad];
  __shared__ int partial[kWarps][kTileRows];

  mark(a, 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTileRows;
  const int w_begin = blockIdx.y * a.split_words;
  const int w_end = min(a.n_words, w_begin + a.split_words);
  const int n_pass = w_end > w_begin
                         ? (w_end - w_begin + kPassWords - 1) / kPassWords
                         : 0;

  // Staging: thread t holds column t of a pass between its load and store
  float cv[kM] = {};
  int cg = 0;
  bool col_odd = false;  // the held column has an infinity or a NaN
  auto fetch = [&](int p) {
    if constexpr (M > 0) {
      const int j = (w_begin + p * kPassWords) * 32 + threadIdx.x;
      const bool ok = j < a.nj;
      col_odd = false;
#pragma unroll
      for (int q = 0; q < M; ++q) {
        cv[q] = ok ? a.cols[static_cast<size_t>(j) * M + q] + 0.0f : 0.0f;
        col_odd |= !isfinite(cv[q]);
      }
      if constexpr (kGroups) cg = ok && a.g_cols ? a.g_cols[j] : 0;
    }
  };
  auto stage = [&](int b) {
    if constexpr (M > 0) {
      float* dst = &col_vals[b][threadIdx.x * kStride];
#pragma unroll
      for (int q = 0; q < M; ++q) dst[q] = cv[q];
      if constexpr (kGroups) col_groups[b][threadIdx.x] = cg;
    }
  };
  if (n_pass > 0) fetch(0);

  // This thread's rows (-0 made +0), group ids, each 32-row slice's group
  // range, and whether any of its rows holds an infinity or a NaN
  float rv[kRows][kM];
  int rg[kRows], g_lo[kRows] = {}, g_hi[kRows] = {};
  bool r_ok[kRows];
  bool row_odd = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + 32 * r + lane;
    r_ok[r] = row < a.ni;
    if constexpr (M > 0) {
#pragma unroll
      for (int q = 0; q < M; ++q) {
        rv[r][q] = r_ok[r] ? a.rows[static_cast<size_t>(row) * M + q] + 0.0f
                           : 0.0f;
        row_odd |= !isfinite(rv[r][q]);
      }
    }
    rg[r] = r_ok[r] && a.g_rows ? a.g_rows[row] : 0;
  }
  if constexpr (kGroups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      g_lo[r] = __reduce_min_sync(0xffffffffu, r_ok[r] ? rg[r] : INT_MAX);
      g_hi[r] = __reduce_max_sync(0xffffffffu, r_ok[r] ? rg[r] : INT_MIN);
    }
  }
  mark(a, 1);

  if (n_pass > 0) stage(0);
  // a pass takes the subtractions when its rows and columns are all finite
  bool finite = !__syncthreads_or(row_odd || col_odd);
  mark(a, 2);
  int count[kRows] = {};
  for (int p = 0; p < n_pass; ++p) {
    const int b = p & 1;
    if (p + 1 < n_pass) fetch(p + 1);
    const int word = w_begin + p * kPassWords + warp;
    unsigned bits[kRows] = {};
    if (word < w_end) {
      if constexpr (M == 0) {
        // generic M: compares of values read from global memory
        for (int k = 31; k >= 0; --k) {
          const int j = word * 32 + k;
          const bool ok = j < a.nj;
          const int gj = ok && a.g_cols ? a.g_cols[j] : 0;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int row = row0 + 32 * r + lane;
            const unsigned x =
                ok && r_ok[r] && (!kGroups || gj == rg[r])
                    ? cmp_bit_generic(a.rows + static_cast<size_t>(row) * a.m,
                                      a.cols + static_cast<size_t>(j) * a.m,
                                      a.m)
                    : 0u;
            bits[r] = __funnelshift_l(x, bits[r], 1);
          }
        }
      } else {
        const float* base = &col_vals[b][warp * 32 * kStride];
        const int* gbase = nullptr;
        int c_lo = 0, c_hi = 0;
        if constexpr (kGroups) {
          gbase = &col_groups[b][warp * 32];
          const bool ok = word * 32 + lane < a.nj;
          c_lo = __reduce_min_sync(0xffffffffu, ok ? gbase[lane] : INT_MAX);
          c_hi = __reduce_max_sync(0xffffffffu, ok ? gbase[lane] : INT_MIN);
        }
        if (finite)
          word_bits<M, kGroups, true>(base, gbase, c_lo, c_hi, rv, rg, g_lo,
                                      g_hi, bits);
        else
          word_bits<M, kGroups, false>(base, gbase, c_lo, c_hi, rv, rg, g_lo,
                                       g_hi, bits);
      }
      const unsigned valid = col_mask(word, a.nj);
#pragma unroll
      for (int r = 0; r < kRows; ++r) bits[r] &= valid;
    }
    if (p == 0) mark(a, 3);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      count[r] += __popc(bits[r]);
      if constexpr (kBitmap) tile[b][warp][32 * r + lane] = bits[r];
    }
    if (p + 1 < n_pass) stage(b ^ 1);
    finite = !__syncthreads_or(row_odd || (p + 1 < n_pass && col_odd));
    if constexpr (kBitmap) {
      // thread t stores words 4h..4h+3 of the pass for tile row t / 2
      const int lr = threadIdx.x >> 1;
      const int h = threadIdx.x & 1;
      const int row = row0 + lr;
      const int w0 = w_begin + p * kPassWords + 4 * h;
      if (row < a.ni && w0 < w_end) {
        unsigned v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = tile[b][4 * h + q][lr];
        unsigned* dst = a.bitmap + static_cast<size_t>(row) * a.n_words + w0;
        if (w0 + 4 <= w_end && (a.n_words & 3) == 0) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (w0 + q < w_end) dst[q] = v[q];
        }
      }
    }
    if (p == 0) mark(a, 4);
  }
  mark(a, 5);

#pragma unroll
  for (int r = 0; r < kRows; ++r) partial[warp][32 * r + lane] = count[r];
  __syncthreads();
  mark(a, 6);
  if (threadIdx.x < kTileRows) {
    const int row = row0 + threadIdx.x;
    if (row < a.ni) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += partial[w][threadIdx.x];
      if (a.accumulate)
        atomicAdd(a.counts + row, sum);
      else
        a.counts[row] = sum;
    }
  }
  mark(a, 7);
}

// The issue probe: the B2 inner loop at M = 3 (kSubtract) or the same pairs
// as float compares (2M FSETPs a pair), on 256 staged columns in shared
// memory and 4 rows a thread in registers, `passes` times over with nothing
// read from or written to global memory in the loop. Thread 0 of each block
// records its SM, and the SM's cycle counter and the global nanosecond
// timer around the loop: trace[5 * block ...] = {sm, c0, c1, ns0, ns1}.
template <bool kSubtract>
__global__ void __launch_bounds__(kThreads)
    dominance_probe_kernel(const float* obj, int passes, long long* trace,
                           int* sink) {
  constexpr int kS = 4;
  __shared__ __align__(16) float vals[kPassCols * kS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < 3; ++q) vals[threadIdx.x * kS + q] = obj[threadIdx.x * 3 + q];
  float rv[kRows][3];
  for (int r = 0; r < kRows; ++r)
    for (int q = 0; q < 3; ++q)
      rv[r][q] = obj[((32 * r + lane + blockIdx.x) % kPassCols) * 3 + q];
  __syncthreads();
  const long long ns0 = global_ns();
  const long long t0 = clock64();
  int count = 0;
  for (int p = 0; p < passes; ++p) {
    const int wcol = ((warp + p) & (kPassWords - 1)) * 32;
    unsigned bits[kRows] = {};
#pragma unroll
    for (int k = 31; k >= 0; --k) {
      float c[3];
      load_col<3>(&vals[(wcol + k) * kS], c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        bits[r] = __funnelshift_l(
            kSubtract ? sub_bit<3>(rv[r], c) : cmp_bit<3>(rv[r], c), bits[r],
            1);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) count += __popc(bits[r]);
    asm volatile("" ::: "memory");
  }
  const long long t1 = clock64();
  const long long ns1 = global_ns();
  sink[blockIdx.x * kThreads + threadIdx.x] = count;
  if (threadIdx.x == 0) {
    long long* row = trace + 5 * static_cast<size_t>(blockIdx.x);
    row[0] = sm_id();
    row[1] = t0;
    row[2] = t1;
    row[3] = ns0;
    row[4] = ns1;
  }
}

template <int M, bool kGroups, bool kBitmap>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  dominance_kernel<M, kGroups, kBitmap><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool kGroups, bool kBitmap>
cudaError_t dispatch(const Args& a, dim3 grid, cudaStream_t stream) {
  switch (a.m) {
    case 1: return launch<1, kGroups, kBitmap>(a, grid, stream);
    case 2: return launch<2, kGroups, kBitmap>(a, grid, stream);
    case 3: return launch<3, kGroups, kBitmap>(a, grid, stream);
    case 4: return launch<4, kGroups, kBitmap>(a, grid, stream);
    case 5: return launch<5, kGroups, kBitmap>(a, grid, stream);
    case 6: return launch<6, kGroups, kBitmap>(a, grid, stream);
    case 7: return launch<7, kGroups, kBitmap>(a, grid, stream);
    case 8: return launch<8, kGroups, kBitmap>(a, grid, stream);
    default: return launch<0, kGroups, kBitmap>(a, grid, stream);
  }
}

cudaError_t sweep(Args a, int splits, cudaStream_t stream) {
  if (a.ni == 0) return cudaSuccess;
  a.accumulate = splits > 1;
  if (a.accumulate) {
    const cudaError_t err = cudaMemsetAsync(
        a.counts, 0, static_cast<size_t>(a.ni) * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.ni + kTileRows - 1) / kTileRows, splits);
  if (a.bitmap == nullptr) return dispatch<false, false>(a, grid, stream);
  if (a.g_rows || a.g_cols) return dispatch<true, true>(a, grid, stream);
  return dispatch<false, true>(a, grid, stream);
}

}  // namespace

// splits x split_words: the column words each block of a row tile takes
// (kernels/dominance.py::launch_config).
extern "C" int dominance_pass_launch(const float* rows, const float* cols,
                                     const int* g_rows, const int* g_cols,
                                     int ni, int nj, int m, int splits,
                                     int split_words, int* counts,
                                     unsigned* bitmap, cudaStream_t stream) {
  const Args a{rows, cols, g_rows, g_cols, ni, nj, m, (nj + 31) / 32,
               split_words, counts, bitmap, false, nullptr};
  return static_cast<int>(sweep(a, splits, stream));
}

// dominance_pass_launch that also records block (0, 0)'s phase clocks:
// phases[kPhases * 8 + 3 * blocks] (kernels/dominance.py::pass_phase_cycles).
extern "C" int dominance_pass_phases_launch(
    const float* rows, const float* cols, const int* g_rows,
    const int* g_cols, int ni, int nj, int m, int splits, int split_words,
    int* counts, unsigned* bitmap, long long* phases, cudaStream_t stream) {
  const Args a{rows, cols, g_rows, g_cols, ni, nj, m, (nj + 31) / 32,
               split_words, counts, bitmap, false, phases};
  return static_cast<int>(sweep(a, splits, stream));
}

extern "C" int dominated_counts_launch(const float* obj, int n, int m,
                                       int splits, int split_words,
                                       int* counts, cudaStream_t stream) {
  const Args a{obj, obj, nullptr, nullptr, n, n, m, (n + 31) / 32,
               split_words, counts, nullptr, false, nullptr};
  return static_cast<int>(sweep(a, splits, stream));
}

// One launch of the issue probe: as many blocks as the card holds at once
// (written to *grid), obj 256 x 3 floats, trace grid x 5, sink grid x 256.
extern "C" int dominance_probe_launch(int subtract, const float* obj,
                                      int passes, int sms, long long* trace,
                                      int* sink, int* grid,
                                      cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      subtract ? dominance_probe_kernel<true> : dominance_probe_kernel<false>,
      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = per_sm * sms;
  if (sink == nullptr) return 0;  // the caller asked for the grid alone
  if (subtract)
    dominance_probe_kernel<true><<<*grid, kThreads, 0, stream>>>(
        obj, passes, trace, sink);
  else
    dominance_probe_kernel<false><<<*grid, kThreads, 0, stream>>>(
        obj, passes, trace, sink);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
