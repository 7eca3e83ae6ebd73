// Constants shared by the DP fill and walk kernels. They mirror
// clique_tpu/align/batch.py (direction and op codes, _TB_FRESH) and
// clique_tpu/align/scoring.py (MAX_NEG_SCORE).
#pragma once

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

// fill CTA size and the most DP rows one fill thread owns (rows x = tid,
// tid + blockDim, ...): n1 <= 6144. 512 threads keep the launch within the
// SM's 65,536 registers at up to 128 registers a thread.
constexpr int kMaxFillThreads = 512;
constexpr int kMaxRowsPerThread = 12;

}  // namespace clique_dp
