// The Waterman-Eggert (local) 3-plane affine DP fill, instantiated by
// dp_fill_local.cu and walked by dp_walk_local.cu.
//
// Replaces: the local branch of clique_tpu/align/batch.py::
// align_batch_device (:221-374, local=True) with the full band and tie
// order up > left > diag, as the inversion screen runs it: the m plane
// floored at 0 (max(0, diag + ms, ms)), the gap planes extended with the
// unscaled gap extension, the per-plane zero flags of every cell's output
// value and the running 3D argmax. It reproduces the XLA scan bit for bit.
//
// What bounds it on an H100: the fill is a recurrence that is sequential in
// the anti-diagonal d. Every diagonal needs the two before it, so each
// alignment pays one __syncthreads() and one round trip through its ring
// per diagonal: it is bound by latency, not by arithmetic. The traceback and
// the zero flags it stores are 2 * B * D * n1 bytes.
//
// What the design does about it: one CTA per alignment, threads over the
// DP row x, so hundreds of alignments run their diagonals concurrently
// across the 132 SMs and hide each other's sync latency. The three planes
// of diagonals d-1 and d-2 live in a 3-slot ring (36 * n1 bytes): writing
// diagonal d into the slot of d-3 needs only the one barrier per diagonal.
// Up to n1 = 6144 (and while 36 * n1 plus the read fits in a block's
// shared memory) the ring is in shared memory and a thread keeps the
// reference byte of each of its rows (tid, tid + blockDim, ...) in
// registers. Beyond that the ring lives in a per-CTA slice of a global
// scratch the wrapper allocates (it stays in L2 at the path's batch
// sizes: 36 * n1 bytes a CTA) and the reference byte is read from global
// memory, so any n1 aligns. The read is staged once in shared memory.
// Traceback and zero-flag bytes are stored one per cell, neighbouring
// threads on neighbouring bytes (the batch-major [B, D, n1] layout that
// align_batch_device(return_traceback=True) returns), so stores coalesce.
// Diagonals past l1 + l2 hold no interior cell and are written as the
// fresh byte and all-zero flags without being computed. The argmax is a
// running best per thread (strictly greater replaces, and a thread visits
// its cells in (d, x) order), reduced once at the end with the order
// highest value, then smallest diagonal, then smallest x, which is the
// XLA scan's winner, with no extra barrier per diagonal.
//
// Exactness: all scores are dyadic f32 sums (batch.py:18-21); the build
// passes --fmad=false so every add and multiply rounds as the reference's.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {

struct FillArgs {
  const uint8_t* refs;      // [R, ref_stride], R == 1 (stride 0) or B
  int ref_stride;
  const uint8_t* reads;     // [B, read_stride]
  int read_stride;
  const int* ref_lens;      // [B]
  const int* read_lens;     // [B]
  const float* params;      // [6]
  uint8_t* tb;              // [B, D, n1]
  uint8_t* zflags;          // [B, D, n1]
  float* best;              // [B, 4] the argmax value, then its M/D/I
  int* best_xd;             // [B, 2] argmax x and diagonal
  float* ring;              // [B, 9, n1] when the ring is in global memory
  int n1;
  int n2;
  int special;              // 0 none, 1 ref_n_only, 2 both
};

inline int round_up4(int n) { return ((n + 3) / 4) * 4; }

// Bytes of ring one CTA keeps in global memory: 0 when the ring and the
// registers rows fit (the shared-memory path).
inline int fill_ring_bytes(int n1, int n2) {
  const bool fits =
      n1 <= kMaxFillThreads * kMaxRowsPerThread &&
      36LL * n1 + round_up4(n2) <= static_cast<long long>(kFillSmemLimit);
  return fits ? 0 : 36 * n1;
}

// Dynamic shared memory of a fill CTA: the ring when it is there, and the
// read bytes.
inline int fill_smem_bytes(int n1, int n2) {
  return (fill_ring_bytes(n1, n2) ? 0 : 36 * n1) + round_up4(n2);
}

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

// (v1, d1, x1) beats (v2, d2, x2): higher value, then earlier diagonal,
// then smaller x (find_max_value_3d_array, alignment_matrix.rs:868-899)
__device__ __forceinline__ bool better(float v1, int d1, int x1, float v2,
                                       int d2, int x2) {
  return v1 > v2 || (v1 == v2 && (d1 < d2 || (d1 == d2 && x1 < x2)));
}

template <bool kRegRows>
__global__ void __launch_bounds__(kMaxFillThreads)
fill_kernel(const FillArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n1 = a.n1;
  const int D = n1 + a.n2 - 1;
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];
  const size_t plane = static_cast<size_t>(D) * n1;
  uint8_t* tbb = a.tb + static_cast<size_t>(b) * plane;
  uint8_t* zfb = a.zflags + static_cast<size_t>(b) * plane;
  // ring[slot][plane][x], slot = d % 3, plane 0 = M, 1 = D (up), 2 = I
  float* ring = kRegRows ? smem : a.ring + static_cast<size_t>(b) * 9 * n1;
  uint8_t* sread = reinterpret_cast<uint8_t*>(kRegRows ? smem + 9 * n1
                                                       : smem);

  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > a.n2 - 1) {
    // lengths outside the bucket: mark the row (NaN best) and store no
    // computed cell; the walk marks its fused row with n_ops -1
    for (size_t i = tid; i < plane; i += nt) {
      tbb[i] = kTbFresh;
      zfb[i] = kZeroAll;
    }
    if (tid < 4) a.best[4 * b + tid] = nanf("");
    if (tid < 2) a.best_xd[2 * b + tid] = 0;
    return;
  }

  const float m_s = a.params[0], mm_s = a.params[1], sp_s = a.params[2];
  const float go = a.params[3], ge = a.params[4], fgm = a.params[5];
  const int special = a.special;
  const uint8_t* ref = a.refs + static_cast<size_t>(b) * a.ref_stride;
  const uint8_t* read = a.reads + static_cast<size_t>(b) * a.read_stride;
  for (int i = tid; i < l2; i += nt) sread[i] = read[i];

  // reference byte per register row, pre-shifted: row x scores ref[x - 1]
  int rx[kRegRows ? kMaxRowsPerThread : 1];
  if (kRegRows) {
#pragma unroll
    for (int k = 0; k < kMaxRowsPerThread; ++k) {
      const int x = tid + k * nt;
      rx[k] = (x >= 1 && x < n1) ? static_cast<int>(ref[x - 1]) : 0;
    }
  }
  __syncthreads();

  // this thread's best valid cell so far
  float bv = -INFINITY, bc0 = 0.0f, bc1 = 0.0f, bc2 = 0.0f;
  int bd = INT_MAX, bx = INT_MAX;

  const int dend = l1 + l2;
  for (int d = 0; d <= dend; ++d) {
    float* cur = ring + (d % 3) * 3 * n1;
    const float* p1 = ring + ((d + 2) % 3) * 3 * n1;   // diagonal d - 1
    const float* p2 = ring + ((d + 1) % 3) * 3 * n1;   // diagonal d - 2

    auto cell = [&](int x, int r) {
      const int y = d - x;
      float m_out, p1_out, p2_out;
      uint8_t byte = kTbFresh;
      const bool interior = x >= 1 && x <= l1 && y >= 1 && y <= l2;
      if (interior) {
        const int ry = sread[y - 1];
        const bool is_special =
            special == 2 ? (r == 78 || ry == 78 || r < 58 || ry < 58)
                         : (special == 1 && r == 78);
        const float ms = is_special ? sp_s : (r == ry ? m_s : mm_s);
        const float gm = (x == l1 || y == l2) ? fgm : 1.0f;
        const float lge = ge * gm;
        const float x1 = go + lge;
        float mm = p2[x - 1] + ms;
        mm = fmaxf(fmaxf(0.0f, mm), ms);
        uint8_t m_dir, d_dir, i_dir;
        // the gap planes extend with the unscaled ge but open with x1,
        // which keeps the terminal-gap multiplier
        m_out = three_way(p2[n1 + x - 1] + ms, p2[2 * n1 + x - 1] + ms, mm,
                          &m_dir);
        p1_out = three_way(p1[n1 + x - 1] + ge, p1[2 * n1 + x - 1] + x1,
                           p1[x - 1] + x1, &d_dir);
        p2_out = three_way(p1[n1 + x] + x1, p1[2 * n1 + x] + ge,
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
      const size_t at = static_cast<size_t>(d) * n1 + x;
      tbb[at] = byte;
      zfb[at] = static_cast<uint8_t>((m_out == 0.0f) |
                                     ((p1_out == 0.0f) << 1) |
                                     ((p2_out == 0.0f) << 2));
      if (x <= l1 && y >= 0 && y <= l2) {
        const float v = fmaxf(m_out, fmaxf(p1_out, p2_out));
        if (v > bv) {
          bv = v;
          bd = d;
          bx = x;
          bc0 = m_out;
          bc1 = p1_out;
          bc2 = p2_out;
        }
      }
    };

    if (kRegRows) {
#pragma unroll
      for (int k = 0; k < kMaxRowsPerThread; ++k) {
        const int x = tid + k * nt;
        if (x >= n1) break;
        cell(x, rx[k]);
      }
    } else {
      for (int x = tid; x < n1; x += nt)
        cell(x, x >= 1 ? static_cast<int>(ref[x - 1]) : 0);
    }
    __syncthreads();
  }

  // diagonals past the corner hold no interior cell
  for (size_t i = static_cast<size_t>(dend + 1) * n1 + tid; i < plane;
       i += nt) {
    tbb[i] = kTbFresh;
    zfb[i] = kZeroAll;
  }

  {
    // the CTA's argmax: warp shuffles, then thread 0 over the warps
    __shared__ float s_v[32], s_c[32][3];
    __shared__ int s_d[32], s_x[32];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int od = __shfl_down_sync(0xffffffffu, bd, off);
      const int ox = __shfl_down_sync(0xffffffffu, bx, off);
      const float o0 = __shfl_down_sync(0xffffffffu, bc0, off);
      const float o1 = __shfl_down_sync(0xffffffffu, bc1, off);
      const float o2 = __shfl_down_sync(0xffffffffu, bc2, off);
      if (better(ov, od, ox, bv, bd, bx)) {
        bv = ov;
        bd = od;
        bx = ox;
        bc0 = o0;
        bc1 = o1;
        bc2 = o2;
      }
    }
    const int warp = tid / 32;
    if (tid % 32 == 0) {
      s_v[warp] = bv;
      s_d[warp] = bd;
      s_x[warp] = bx;
      s_c[warp][0] = bc0;
      s_c[warp][1] = bc1;
      s_c[warp][2] = bc2;
    }
    __syncthreads();
    if (tid == 0) {
      int w = 0;
      for (int i = 1; i < nt / 32; ++i)
        if (better(s_v[i], s_d[i], s_x[i], s_v[w], s_d[w], s_x[w])) w = i;
      a.best[4 * b + 0] = s_v[w];
      a.best[4 * b + 1] = s_c[w][0];
      a.best[4 * b + 2] = s_c[w][1];
      a.best[4 * b + 3] = s_c[w][2];
      a.best_xd[2 * b + 0] = s_x[w];
      a.best_xd[2 * b + 1] = s_d[w];
    }
  }
}

// Launch one fill CTA per alignment on `stream`; returns the CUDA error of
// the launch (0 on success). The caller passes a.ring when
// fill_ring_bytes(n1, n2) is not 0.
inline int launch_fill(const FillArgs& a, int B, void* stream) {
  if (B <= 0 || a.n1 < 1 || a.n2 < 1) return cudaErrorInvalidValue;
  const bool reg_rows = fill_ring_bytes(a.n1, a.n2) == 0;
  if (!reg_rows && a.ring == nullptr) return cudaErrorInvalidValue;
  const int smem = fill_smem_bytes(a.n1, a.n2);
  if (smem > kFillSmemLimit) return cudaErrorInvalidValue;
  int threads = ((a.n1 + 31) / 32) * 32;
  if (threads > kMaxFillThreads) threads = kMaxFillThreads;
  void (*kern)(FillArgs) = reg_rows ? fill_kernel<true> : fill_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clique_dp
