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
// zero-flag byte of a cell whose three planes hold 0.0
constexpr uint8_t kZeroAll = 7;

// op codes emitted by the traceback walk
constexpr uint8_t kOpMatch = 0;
constexpr uint8_t kOpDel = 1;
constexpr uint8_t kOpIns = 2;
constexpr uint8_t kOpDone = 3;

constexpr float kMaxNegScore = -100000.0f;

// fill CTA size and the most DP rows one fill thread keeps in registers
// (rows x = tid, tid + blockDim, ...): n1 <= 6144 on that path. 512
// threads keep the launch within the SM's 65,536 registers at up to 128
// registers a thread. Larger n1 loop over their rows with the reference
// byte read from global memory.
constexpr int kMaxFillThreads = 512;
constexpr int kMaxRowsPerThread = 12;

// shared memory a fill CTA may ask for dynamically: an H100 block's
// 232,448 bytes less room for the local fill's static reduction arrays
constexpr int kFillSmemLimit = 232448 - 1024;

}  // namespace clique_dp
