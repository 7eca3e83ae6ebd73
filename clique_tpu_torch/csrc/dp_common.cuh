// Constants and helpers shared by the DP kernels (dp_align.cu,
// dp_align_local.cu). The constants mirror clique_tpu/align/batch.py
// (direction and op codes, _TB_FRESH) and clique_tpu/align/scoring.py
// (MAX_NEG_SCORE).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace clique_dp {

// direction codes (== source plane), as in align/cpu.py and batch.py
constexpr uint8_t kDiag = 0;
constexpr uint8_t kUp = 1;
constexpr uint8_t kLeft = 2;
// traceback byte with all three planes set to UP: the fresh-matrix value
// every non-interior cell keeps
constexpr uint8_t kTbFresh = kUp | (kUp << 2) | (kUp << 4);

// op codes emitted by the traceback walk
constexpr uint8_t kOpMatch = 0;
constexpr uint8_t kOpDel = 1;
constexpr uint8_t kOpIns = 2;
constexpr uint8_t kOpDone = 3;

constexpr float kMaxNegScore = -100000.0f;

constexpr int kStripRows = 12;                   // DP rows a lane owns
constexpr int kBandRows = 32 * kStripRows;       // rows a warp covers at once
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int strips(int n1) {
  return (n1 - 1 + kStripRows - 1) / kStripRows;
}

// The wavefront layout of one alignment's traceback: row band j holds
// lanes(j) strips; its step t is one row of row_bytes(j) bytes starting at
// band_base(j) + t * row_bytes(j), lane k's 12 bytes at k * 12 of it; the
// band has n2 - 2 + lanes(j) steps. Only the last band can be partial.
__host__ __device__ inline int band_lanes(int n1, int j) {
  const int rest = strips(n1) - 32 * j;
  return rest < 32 ? rest : 32;
}
__host__ __device__ inline int row_bytes(int nl) {
  return (nl * kStripRows + 15) / 16 * 16;
}
__host__ __device__ inline long long band_base(int n2, int j) {
  return static_cast<long long>(j) * (n2 + 30) * row_bytes(32);
}
__host__ __device__ inline long long tb_bytes(int n1, int n2) {
  const int nb = (strips(n1) + 31) / 32;
  const int nl = band_lanes(n1, nb - 1);
  return band_base(n2, nb - 1) +
         static_cast<long long>(n2 - 2 + nl) * row_bytes(nl);
}

// three_way_max_and_direction: up on strict >, then left on strict >,
// else diag (diag wins ties) -- pallas_kernel.py:46-52
__device__ __forceinline__ float three_way(float up, float left, float diag,
                                           uint32_t* dir) {
  const bool up_gt_left = up > left;
  const bool up_wins = up_gt_left && (up > diag);
  const bool left_wins = !up_gt_left && (left > diag);
  *dir = up_wins ? kUp : (left_wins ? kLeft : kDiag);
  return up_wins ? up : (left_wins ? left : diag);
}

}  // namespace clique_dp
