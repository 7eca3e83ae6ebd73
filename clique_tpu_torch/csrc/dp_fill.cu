// Global, full-band 3-plane affine DP fill for Hopper (sm_90a).
//
// Replaces: clique_tpu/align/pallas_kernel.py::_fill_kernel (launched by
// pallas_fill, the only pl.pallas_call in the JAX package) and the global
// branch of clique_tpu/align/batch.py::align_batch_device that it
// reproduces bit for bit.
//
// What bounds it on an H100: the fill is a recurrence that is sequential in
// the anti-diagonal d. Every diagonal needs the two before it, so each
// alignment pays one __syncthreads() and one shared-memory round trip per
// diagonal: it is bound by latency, not by arithmetic. The traceback it
// stores is B * D * n1 bytes, ~302 MB per dispatch at the bench shape
// (B=1024, n1=n2=384): at the H100 SXM's 3.35 TB/s datasheet peak that is
// a floor of ~0.09 ms (a bound, not a measurement), far below the
// diagonal-serial latency.
//
// What the design does about it: one CTA per alignment, threads over the
// DP row x (thread tid owns rows tid, tid + blockDim, ...), so hundreds of
// alignments run their diagonals concurrently across the 132 SMs and hide
// each other's sync latency. The three planes of diagonals d-1 and d-2 live
// in a 3-deep shared-memory ring (36 * n1 bytes): writing diagonal d into
// the slot of d-3 needs only the one barrier per diagonal. The reference
// byte of each owned row stays in a register; the read is staged once in
// shared memory. Traceback bytes are stored one per cell, neighbouring
// threads on neighbouring bytes (the batch-major [B, D, n1] layout that
// align_batch_device(return_traceback=True) returns), so stores coalesce.
// Diagonals past l1 + l2 hold no interior cell and are written as the
// fresh byte without being computed.
//
// Exactness: all scores are dyadic f32 sums (batch.py:18-21); the build
// passes --fmad=false so every add and multiply rounds as the reference's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

// three_way_max_and_direction: up on strict >, then left on strict >,
// else diag (diag wins ties) -- pallas_kernel.py:46-52
__device__ __forceinline__ float three_way(float up, float left, float diag,
                                           uint8_t* dir) {
  const bool up_gt_left = up > left;
  const bool up_wins = up_gt_left && (up > diag);
  const bool left_wins = !up_gt_left && (left > diag);
  *dir = up_wins ? kUp : (left_wins ? kLeft : kDiag);
  return up_wins ? up : (left_wins ? left : diag);
}

__global__ void __launch_bounds__(kMaxFillThreads)
dp_fill_kernel(const uint8_t* __restrict__ refs, int ref_stride,
               const uint8_t* __restrict__ reads, int read_stride,
               const int* __restrict__ ref_lens,
               const int* __restrict__ read_lens,
               const float* __restrict__ params, uint8_t* __restrict__ tb,
               float* __restrict__ corner, int n1, int n2, int both_mode) {
  extern __shared__ float smem[];
  // ring[slot][plane][x], slot = d % 3, plane 0 = M, 1 = D (up), 2 = I
  float* ring = smem;
  uint8_t* sread = reinterpret_cast<uint8_t*>(smem + 9 * n1);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int D = n1 + n2 - 1;
  const int l1 = ref_lens[b];
  const int l2 = read_lens[b];
  uint8_t* tbb = tb + static_cast<size_t>(b) * D * n1;

  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) {
    // lengths outside the bucket: mark the row (NaN corner) and store no
    // computed cell; the walk kernel marks its fused row with n_ops -1
    for (size_t i = tid; i < static_cast<size_t>(D) * n1; i += nt)
      tbb[i] = kTbFresh;
    if (tid < 3) corner[3 * b + tid] = nanf("");
    return;
  }

  const float m_s = params[0], mm_s = params[1], sp_s = params[2];
  const float go = params[3], ge = params[4], fgm = params[5];

  const uint8_t* ref = refs + static_cast<size_t>(b) * ref_stride;
  const uint8_t* read = reads + static_cast<size_t>(b) * read_stride;
  for (int i = tid; i < l2; i += nt) sread[i] = read[i];

  // reference byte per owned row, pre-shifted: row x scores ref[x - 1]
  int rx[kMaxRowsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxRowsPerThread; ++k) {
    const int x = tid + k * nt;
    rx[k] = (x >= 1 && x < n1) ? static_cast<int>(ref[x - 1]) : 0;
  }
  __syncthreads();

  const int dend = l1 + l2;
  for (int d = 0; d <= dend; ++d) {
    float* cur = ring + (d % 3) * 3 * n1;
    const float* p1 = ring + ((d + 2) % 3) * 3 * n1;   // diagonal d - 1
    const float* p2 = ring + ((d + 1) % 3) * 3 * n1;   // diagonal d - 2
#pragma unroll
    for (int k = 0; k < kMaxRowsPerThread; ++k) {
      const int x = tid + k * nt;
      if (x >= n1) break;
      const int y = d - x;
      float m_out, p1_out, p2_out;
      uint8_t byte = kTbFresh;
      if (x >= 1 && x <= l1 && y >= 1 && y <= l2) {
        const int ry = sread[y - 1];
        const int r = rx[k];
        const bool special = both_mode
            ? (r == 78 || ry == 78 || r < 58 || ry < 58)
            : (r == 78);
        const float ms = special ? sp_s : (r == ry ? m_s : mm_s);
        const float gm = (x == l1 || y == l2) ? fgm : 1.0f;
        const float lge = ge * gm;
        const float x1 = go + lge;
        uint8_t m_dir, d_dir, i_dir;
        m_out = three_way(p2[n1 + x - 1] + ms, p2[2 * n1 + x - 1] + ms,
                          p2[x - 1] + ms, &m_dir);
        p1_out = three_way(p1[n1 + x - 1] + lge, p1[2 * n1 + x - 1] + x1,
                           p1[x - 1] + x1, &d_dir);
        p2_out = three_way(p1[n1 + x] + x1, p1[2 * n1 + x] + lge,
                           p1[x] + x1, &i_dir);
        byte = static_cast<uint8_t>(m_dir | (d_dir << 2) | (i_dir << 4));
      } else if (x == 0 && y == 0) {
        m_out = 0.0f;
        p1_out = p2_out = kMaxNegScore;
      } else if (x == 0 && y >= 1 && y <= l2) {
        m_out = kMaxNegScore;
        p1_out = p2_out = (go + static_cast<float>(y) * ge) * fgm;
      } else if (y == 0 && x >= 1 && x <= l1) {
        m_out = kMaxNegScore;
        p1_out = p2_out = (go + static_cast<float>(x) * ge) * fgm;
      } else {
        m_out = p1_out = p2_out = 0.0f;
      }
      cur[x] = m_out;
      cur[n1 + x] = p1_out;
      cur[2 * n1 + x] = p2_out;
      tbb[static_cast<size_t>(d) * n1 + x] = byte;
      if (d == dend && x == l1) {
        corner[3 * b + 0] = m_out;
        corner[3 * b + 1] = p1_out;
        corner[3 * b + 2] = p2_out;
      }
    }
    __syncthreads();
  }

  // diagonals past the corner hold no interior cell
  const size_t tail0 = static_cast<size_t>(dend + 1) * n1;
  const size_t tail1 = static_cast<size_t>(D) * n1;
  for (size_t i = tail0 + tid; i < tail1; i += nt) tbb[i] = kTbFresh;
}

}  // namespace
}  // namespace clique_dp

// Shared memory one CTA needs: the 3 x 3 x n1 f32 ring plus the read bytes.
extern "C" int clique_dp_fill_smem_bytes(int n1, int n2) {
  return 36 * n1 + ((n2 + 3) / 4) * 4;
}

// Largest n1 (DP rows) the fill takes.
extern "C" int clique_dp_fill_max_n1() {
  return clique_dp::kMaxFillThreads * clique_dp::kMaxRowsPerThread;
}

// Launch the fill on `stream`. refs [R, ref_stride] u8 with R == 1
// (uniform reference, ref_stride passed as 0) or R == B; reads
// [B, read_stride] u8; lens [B] i32; params [6] f32 (match, mismatch,
// special, gap_open, gap_extend, final_gap_multiplier). Outputs tb
// [B, n1 + n2 - 1, n1] u8 and corner [B, 3] f32. Returns the CUDA error of
// the launch (0 on success).
extern "C" int clique_dp_fill(const void* refs, int ref_stride,
                              const void* reads, int read_stride,
                              const void* ref_lens, const void* read_lens,
                              const void* params, void* tb, void* corner,
                              int B, int n1, int n2, int both_mode,
                              void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 1 || n2 < 1) return cudaErrorInvalidValue;
  int threads = ((n1 + 31) / 32) * 32;
  if (threads > kMaxFillThreads) threads = kMaxFillThreads;
  if ((n1 + threads - 1) / threads > kMaxRowsPerThread)
    return cudaErrorInvalidValue;
  const int smem = clique_dp_fill_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dp_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dp_fill_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(refs), ref_stride,
      static_cast<const uint8_t*>(reads), read_stride,
      static_cast<const int*>(ref_lens), static_cast<const int*>(read_lens),
      static_cast<const float*>(params), static_cast<uint8_t*>(tb),
      static_cast<float*>(corner), n1, n2, both_mode);
  return cudaGetLastError();
}
