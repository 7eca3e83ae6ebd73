// Tag-distance kernels for Hopper (sm_90a): the device work of collapse's
// tag correction.
//
// Replaces, in clique_tpu/collapse/distance.py:
// - _match_count_kernel: per (tag, allowlist entry) the number of columns
//   whose bytes are equal (KnownTag Hamming). The XLA version one-hot
//   encodes byte classes and contracts them on the matrix unit; here the
//   bytes are compared directly, four at a time (__vcmpeq4), so '-' == '-'
//   and 'N' == 'N' count as matches exactly as the byte classes did.
// - _edit_distance_kernel: Levenshtein distance per row pair. The XLA
//   version sweeps anti-diagonals over [P, L+1] lanes with a scan; here one
//   thread owns one pair and keeps a rolling DP row in registers.
//
// What bounds them on an H100:
// - match count: at the chunk shape (U=2048 tags x K=16384 entries, L=16)
//   it writes U*K output bytes (33.5 MB) and does U*K*ceil(L/4) word
//   compares; the inputs (32 KB + 256 KB) stay in L2. The output write and
//   the integer pipe bound it. Design: a CTA keeps 128 allowlist rows,
//   transposed to words in shared memory (thread t reads word w of its own
//   row at [w][t]: no bank conflicts), and walks tiles of 16 tags whose
//   words every thread reads at the same address (a broadcast); 16 counts
//   stay in registers, and each tag's 128 output bytes are stored by
//   neighbouring threads at neighbouring addresses.
// - edit distance: la*L cells of a few integer ops per pair, no reuse
//   between pairs; at 2M pairs of 16 bp in 32-byte rows it reads 134 MB
//   once. The integer pipe bounds it. Design: one thread per pair, the
//   row of L+1 cells and the b row (packed four bytes a word) in registers
//   for L <= 32, the rows of collapse's 16 bp cell barcodes (fully
//   unrolled inner loop: 0.26 ms at 2M pairs against 0.80 ms for the
//   local-memory row on an H100 80GB HBM3 at 700 W), a local-memory row
//   up to kMaxEditLen beyond that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace clique_tag {

constexpr int kMatchThreads = 128;   // allowlist rows per CTA
constexpr int kMatchTile = 16;       // tags per tile (counts in registers)
constexpr int kMaxMatchLen = 256;    // L: 64 words a row, 36,864 B smem
                                     // (MATCH_MAX_LEN in distance.py)
constexpr int kEditThreads = 128;
constexpr int kRegEditLen = 32;      // widest row the register kernel takes
constexpr int kMaxEditLen = 256;     // row width L (EDIT_MAX_LEN)

namespace {

__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int w,
                                              int L, bool live) {
  uint32_t word = 0;
  if (!live) return word;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * w + k;
    if (c < L) word |= static_cast<uint32_t>(row[c]) << (8 * k);
  }
  return word;
}

// matches [U, K] u8 = min(255, #columns c with tags[u, c] == allow[k, c]).
// Columns past L are zero on both sides of every word, so they always
// compare equal: the count subtracts them (pad = 4 * Lw - L).
__global__ void __launch_bounds__(kMatchThreads)
match_count_kernel(const uint8_t* __restrict__ tags,
                   const uint8_t* __restrict__ allow,
                   uint8_t* __restrict__ out, int U, int K, int L) {
  extern __shared__ uint32_t smem[];
  const int Lw = (L + 3) / 4;
  uint32_t* allow_t = smem;                        // [Lw][kMatchThreads]
  uint32_t* tag_w = smem + Lw * kMatchThreads;     // [kMatchTile][Lw]
  const int t = threadIdx.x;
  const int k = blockIdx.x * kMatchThreads + t;
  const bool k_live = k < K;
  const uint8_t* arow = allow + static_cast<size_t>(k_live ? k : 0) * L;
  for (int w = 0; w < Lw; ++w)
    allow_t[w * kMatchThreads + t] = load_word(arow, w, L, k_live);
  const int pad = 4 * Lw - L;
  const int tiles = (U + kMatchTile - 1) / kMatchTile;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int u0 = tile * kMatchTile;
    __syncthreads();   // allow_t written / the previous tile's tag_w read
    for (int i = t; i < kMatchTile * Lw; i += kMatchThreads) {
      const int r = i / Lw, w = i - r * Lw;
      const bool live = u0 + r < U;
      tag_w[i] = load_word(tags + static_cast<size_t>(live ? u0 + r : 0) * L,
                           w, L, live);
    }
    __syncthreads();
    uint32_t acc[kMatchTile];
#pragma unroll
    for (int r = 0; r < kMatchTile; ++r) acc[r] = 0;
    for (int w = 0; w < Lw; ++w) {
      const uint32_t aw = allow_t[w * kMatchThreads + t];
#pragma unroll
      for (int r = 0; r < kMatchTile; ++r)
        acc[r] += __popc(__vcmpeq4(aw, tag_w[r * Lw + w]));
    }
    if (k_live) {
#pragma unroll
      for (int r = 0; r < kMatchTile; ++r) {
        if (u0 + r < U) {
          const uint32_t m = (acc[r] >> 3) - pad;   // 8 bits per equal byte
          out[static_cast<size_t>(u0 + r) * K + k] =
              static_cast<uint8_t>(m < 255u ? m : 255u);
        }
      }
    }
  }
}

// Levenshtein distance of a[p, :la[p]] and b[p, :lb[p]], min(d, 255).
// Row j of the rolling DP is D(i, j) for the first i bytes of a and the
// first j bytes of b; columns past lb never feed columns at or below it,
// so the unrolled loop computes all kRegEditLen columns and reads column
// lb. For L <= kRegEditLen.
__global__ void __launch_bounds__(kEditThreads)
edit_distance_reg_kernel(const uint8_t* __restrict__ a,
                         const uint8_t* __restrict__ b,
                         const int* __restrict__ la,
                         const int* __restrict__ lb,
                         uint8_t* __restrict__ out, int P, int L) {
  const int p = blockIdx.x * kEditThreads + threadIdx.x;
  if (p >= P) return;
  const uint8_t* arow = a + static_cast<size_t>(p) * L;
  const uint8_t* brow = b + static_cast<size_t>(p) * L;
  const int n = min(max(la[p], 0), L);
  const int m = min(max(lb[p], 0), L);
  uint32_t bw[kRegEditLen / 4];
#pragma unroll
  for (int w = 0; w < kRegEditLen / 4; ++w)
    bw[w] = load_word(brow, w, L, true);
  int row[kRegEditLen + 1];
#pragma unroll
  for (int j = 0; j <= kRegEditLen; ++j) row[j] = j;
  for (int i = 1; i <= n; ++i) {
    const uint32_t ai = arow[i - 1];
    int diag = row[0];
    row[0] = i;
#pragma unroll
    for (int j = 1; j <= kRegEditLen; ++j) {
      const uint32_t bj = (bw[(j - 1) >> 2] >> (8 * ((j - 1) & 3))) & 0xffu;
      const int up = row[j];
      const int v = min(min(up, row[j - 1]) + 1, diag + (ai != bj ? 1 : 0));
      diag = up;
      row[j] = v;
    }
  }
  int d = 0;
#pragma unroll
  for (int j = 0; j <= kRegEditLen; ++j)
    if (j == m) d = row[j];
  out[p] = static_cast<uint8_t>(d < 255 ? d : 255);
}

// The same DP for kRegEditLen < L <= kMaxEditLen, with the row in local
// memory.
__global__ void __launch_bounds__(kEditThreads)
edit_distance_local_kernel(const uint8_t* __restrict__ a,
                           const uint8_t* __restrict__ b,
                           const int* __restrict__ la,
                           const int* __restrict__ lb,
                           uint8_t* __restrict__ out, int P, int L) {
  const int p = blockIdx.x * kEditThreads + threadIdx.x;
  if (p >= P) return;
  const uint8_t* arow = a + static_cast<size_t>(p) * L;
  const uint8_t* brow = b + static_cast<size_t>(p) * L;
  const int n = min(max(la[p], 0), L);
  const int m = min(max(lb[p], 0), L);
  uint16_t row[kMaxEditLen + 1];
  for (int j = 0; j <= m; ++j) row[j] = static_cast<uint16_t>(j);
  for (int i = 1; i <= n; ++i) {
    const uint8_t ai = arow[i - 1];
    int diag = row[0];
    row[0] = static_cast<uint16_t>(i);
    for (int j = 1; j <= m; ++j) {
      const int up = row[j];
      const int v = min(min(up, static_cast<int>(row[j - 1])) + 1,
                        diag + (ai != brow[j - 1] ? 1 : 0));
      diag = up;
      row[j] = static_cast<uint16_t>(v);
    }
  }
  const int d = row[m];
  out[p] = static_cast<uint8_t>(d < 255 ? d : 255);
}

}  // namespace
}  // namespace clique_tag

// Launch the match count on `stream`: tags [U, L] u8, allow [K, L] u8,
// out [U, K] u8, all contiguous. Returns the CUDA error of the launch.
extern "C" int clique_match_count(const void* tags, const void* allow,
                                  void* out, int U, int K, int L,
                                  void* stream) {
  using namespace clique_tag;
  if (U <= 0 || K <= 0 || L <= 0 || L > kMaxMatchLen)
    return cudaErrorInvalidValue;
  const int Lw = (L + 3) / 4;
  const size_t smem = sizeof(uint32_t) * Lw * (kMatchThreads + kMatchTile);
  const int tiles = (U + kMatchTile - 1) / kMatchTile;
  const dim3 grid((K + kMatchThreads - 1) / kMatchThreads,
                  tiles < 65535 ? tiles : 65535);
  match_count_kernel<<<grid, kMatchThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tags), static_cast<const uint8_t*>(allow),
      static_cast<uint8_t*>(out), U, K, L);
  return cudaGetLastError();
}

// Launch the edit distance on `stream`: a, b [P, L] u8, la, lb [P] i32
// (0 <= la, lb <= L, checked by the caller), out [P] u8. Returns the CUDA
// error of the launch.
extern "C" int clique_edit_distance(const void* a, const void* b,
                                    const void* la, const void* lb,
                                    void* out, int P, int L, void* stream) {
  using namespace clique_tag;
  if (P <= 0 || L <= 0 || L > kMaxEditLen) return cudaErrorInvalidValue;
  const int blocks = (P + kEditThreads - 1) / kEditThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int* pla = static_cast<const int*>(la);
  const int* plb = static_cast<const int*>(lb);
  uint8_t* po = static_cast<uint8_t*>(out);
  if (L <= kRegEditLen)
    edit_distance_reg_kernel<<<blocks, kEditThreads, 0, s>>>(
        pa, pb, pla, plb, po, P, L);
  else
    edit_distance_local_kernel<<<blocks, kEditThreads, 0, s>>>(
        pa, pb, pla, plb, po, P, L);
  return cudaGetLastError();
}
