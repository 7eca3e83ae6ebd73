// Local (Waterman-Eggert) traceback walk + op epilogue + result fusion for
// Hopper (sm_90a).
//
// Replaces: clique_tpu/align/batch.py::_finish_local (:450-492, XLA): the
// start plane at the argmax cell (_corner_to_z0_score over the cell's
// M/D/I values, later plane wins ties), the walk from the argmax cell that
// stops where it leaves the core (x = 0 or y = 0) or meets a cell whose
// current plane holds 0.0 (its zero flag), with no trailing D/I runs, then
// _ops_epilogue (left-compaction, 2-bit packing padded with OP_DONE) and
// the fused row of dp_walk.cu with the four coordinates added: n_ops i32,
// score f32, ref_start, read_start, ref_end, read_end i32 (all LE), then
// the packed ops.
//
// What bounds it on an H100: as dp_walk.cu, a chain of dependent loads
// (traceback and zero-flag byte of the cell decide the next step), bound
// by memory latency. What the design does about it: one thread per
// alignment, so all B walks keep their loads in flight, visiting only the
// cells on the path; the ops go through a [T, B] scratch so the fused row
// is written once in forward order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

__global__ void dp_walk_local_kernel(const uint8_t* __restrict__ tb,
                                     const uint8_t* __restrict__ zflags,
                                     const float* __restrict__ best,
                                     const int* __restrict__ best_xd,
                                     uint8_t* __restrict__ scratch,
                                     uint8_t* __restrict__ fused,
                                     int B, int n1, int n2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = n1 + n2 - 1;
  const int T = n1 + n2;
  const int P = (T + 3) / 4;
  uint8_t* out = fused + static_cast<size_t>(b) * (24 + P);

  const float c0 = best[4 * b + 1];
  const float c1 = best[4 * b + 2];
  const float c2 = best[4 * b + 3];
  int z = (c2 >= fmaxf(c0, c1)) ? 2 : ((c1 >= c0) ? 1 : 0);
  float score = (z == 2) ? c2 : ((z == 1) ? c1 : c0);
  const int end_x = best_xd[2 * b];
  const int end_y = best_xd[2 * b + 1] - end_x;

  // a NaN best value marks lengths outside the bucket (dp_fill_local)
  const bool marked = isnan(best[4 * b]);
  int x = end_x, y = end_y, n = 0;
  if (marked) {
    score = nanf("");
  } else {
    const size_t base = static_cast<size_t>(b) * D * n1;
    while (x > 0 && y > 0) {
      const size_t at = base + static_cast<size_t>(x + y) * n1 + x;
      if ((zflags[at] >> z) & 1) break;
      const int dir = (tb[at] >> (2 * z)) & 3;
      scratch[static_cast<size_t>(n) * B + b] = static_cast<uint8_t>(z);
      ++n;
      x -= (z == 2) ? 0 : 1;
      y -= (z == 1) ? 0 : 1;
      z = dir;
    }
  }

  const uint32_t head[6] = {
      marked ? 0xFFFFFFFFu : static_cast<uint32_t>(n), __float_as_uint(score),
      static_cast<uint32_t>(x), static_cast<uint32_t>(y),
      static_cast<uint32_t>(end_x), static_cast<uint32_t>(end_y)};
#pragma unroll
  for (int w = 0; w < 6; ++w) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[4 * w + i] = static_cast<uint8_t>(head[w] >> (8 * i));
  }
  // forward op j is the walk's op n - 1 - j; OP_DONE past n_ops
  for (int q = 0; q < P; ++q) {
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      const uint32_t op = (j < n)
          ? scratch[static_cast<size_t>(n - 1 - j) * B + b] : kOpDone;
      byte |= op << (2 * k);
    }
    out[24 + q] = static_cast<uint8_t>(byte);
  }
}

}  // namespace
}  // namespace clique_dp

// Launch the local walk on `stream`. tb and zflags [B, n1 + n2 - 1, n1] u8,
// best [B, 4] f32 and best_xd [B, 2] i32 from clique_dp_fill_local;
// scratch [n1 + n2, B] u8; fused [B, 24 + ceil((n1 + n2) / 4)] u8 out.
// Returns the CUDA error of the launch (0 on success).
extern "C" int clique_dp_walk_local(const void* tb, const void* zflags,
                                    const void* best, const void* best_xd,
                                    void* scratch, void* fused, int B, int n1,
                                    int n2, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 1 || n2 < 1) return cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  dp_walk_local_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(zflags),
      static_cast<const float*>(best), static_cast<const int*>(best_xd),
      static_cast<uint8_t*>(scratch), static_cast<uint8_t*>(fused), B, n1,
      n2);
  return cudaGetLastError();
}
