// Traceback walk + op epilogue + result fusion for Hopper (sm_90a).
//
// Replaces: the XLA device code that follows the Pallas fill in
// clique_tpu/align/batch.py -- _corner_to_z0_score (start plane, last max
// wins), _finish_from_packed_traceback (the walk from the (l1, l2) corner),
// _ops_epilogue (stable left-compaction of the ops, 2-bit packing padded
// with OP_DONE) and fuse_result (n_ops i32 LE, score f32 LE, packed ops in
// one uint8 row per alignment).
//
// What bounds it on an H100: each step of a walk loads the traceback byte
// that decides the next step, so one walk is a chain of dependent loads
// from a ~302 MB traceback (bench shape) that mostly misses the 50 MB L2:
// it is bound by memory latency, not bandwidth (~1.4 KB per walk touched).
//
// What the design does about it: one thread per alignment, so all B walks
// keep their loads in flight at once, and the walk visits only the cells on
// the path (no per-diagonal scan over n1 lanes as the JAX walk does). The
// ops come out in reverse; they go to a [T, B] scratch (neighbouring
// threads on neighbouring bytes) and are read back in forward order while
// being packed, so the fused row is written once and nothing else outlives
// the dispatch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

__global__ void dp_walk_kernel(const uint8_t* __restrict__ tb,
                               const float* __restrict__ corner,
                               const int* __restrict__ ref_lens,
                               const int* __restrict__ read_lens,
                               uint8_t* __restrict__ scratch,
                               uint8_t* __restrict__ fused,
                               int B, int n1, int n2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = n1 + n2 - 1;
  const int T = n1 + n2;
  const int P = (T + 3) / 4;
  const int l1 = ref_lens[b];
  const int l2 = read_lens[b];
  uint8_t* out = fused + static_cast<size_t>(b) * (8 + P);

  // starting plane: argmax over the corner, later plane wins ties
  const float c0 = corner[3 * b + 0];
  const float c1 = corner[3 * b + 1];
  const float c2 = corner[3 * b + 2];
  int z = (c2 >= fmaxf(c0, c1)) ? 2 : ((c1 >= c0) ? 1 : 0);
  float score = (z == 2) ? c2 : ((z == 1) ? c1 : c0);

  int n = 0;
  const bool marked = l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1;
  if (marked) {
    // lengths outside the bucket (the fill left a NaN corner): no ops, a
    // NaN score and n_ops -1, which the host raises on when it reads the
    // row back (batch.py::check_marked_rows)
    score = nanf("");
  } else {
    const uint8_t* tbb = tb + static_cast<size_t>(b) * D * n1;
    int x = l1, y = l2;
    while (x > 0 || y > 0) {
      uint8_t op;
      if (x > 0 && y > 0) {
        op = static_cast<uint8_t>(z);
        const int dir =
            (tbb[static_cast<size_t>(x + y) * n1 + x] >> (2 * z)) & 3;
        x -= (z == 2) ? 0 : 1;
        y -= (z == 1) ? 0 : 1;
        z = dir;
      } else if (x > 0) {
        op = kOpDel;
        x -= 1;
      } else {
        op = kOpIns;
        y -= 1;
      }
      scratch[static_cast<size_t>(n) * B + b] = op;
      ++n;
    }
  }

  const uint32_t nb = marked ? 0xFFFFFFFFu : static_cast<uint32_t>(n);
  const uint32_t sb = __float_as_uint(score);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<uint8_t>(nb >> (8 * i));
    out[4 + i] = static_cast<uint8_t>(sb >> (8 * i));
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
    out[8 + q] = static_cast<uint8_t>(byte);
  }
}

}  // namespace
}  // namespace clique_dp

// Launch the walk on `stream`. tb [B, n1 + n2 - 1, n1] u8 and corner
// [B, 3] f32 from clique_dp_fill; lens [B] i32; scratch [n1 + n2, B] u8;
// fused [B, 8 + ceil((n1 + n2) / 4)] u8 out. Returns the CUDA error of the
// launch (0 on success).
extern "C" int clique_dp_walk(const void* tb, const void* corner,
                              const void* ref_lens, const void* read_lens,
                              void* scratch, void* fused,
                              int B, int n1, int n2, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 1 || n2 < 1) return cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  dp_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const float*>(corner),
      static_cast<const int*>(ref_lens), static_cast<const int*>(read_lens),
      static_cast<uint8_t*>(scratch), static_cast<uint8_t*>(fused),
      B, n1, n2);
  return cudaGetLastError();
}
