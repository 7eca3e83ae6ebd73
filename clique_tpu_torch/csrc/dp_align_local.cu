// Local (Waterman-Eggert) 3-plane affine DP fill, argmax, traceback walk,
// op epilogue and result fusion in one kernel for Hopper (sm_90a): the full
// band, tie order up > left > diag, the special-byte rules "both",
// "ref_n_only" and "none", any n1.
//
// Replaces: the local branch of clique_tpu/align/batch.py::
// align_batch_device (:184, :222, :261, :278, :363; local=True) -- the M
// plane floored at 0, the gap planes extended with the unscaled gap
// extension, the per-plane zero flags and the running 3D argmax -- and
// _finish_local (:450-492): the start plane at the argmax cell, the walk
// that stops where it leaves the core or meets a plane holding 0.0,
// _ops_epilogue and the fused row with its four coordinates. The plain
// versions are align/batch.py::fill_local_reference + walk_local_reference.
//
// What bounds it on an H100: about 36 lane operations per interior cell
// (dp_align.cu's 30, the zero fields and the running argmax), so at B=64,
// n1=n2=3328 with reads of 1..3327 bases (0.35 G interior cells) the
// lanes need ~0.38 ms at the FP32 rate; the traceback is one byte a cell
// (0.35 GB, ~0.11 ms at 3.35 TB/s). Most of those operations are compares
// and selects, which an SM runs at half the FP32 rate. Its work is
// compute-bound. What holds it back is the dependence: an alignment is a
// wavefront of l2 + l1 / 12 steps, so a batch of few long alignments
// leaves SMs idle (64 CTAs for 132 SMs at B=64), and the longest
// alignment sets the time.
//
// What the design does about it:
// - dp_align.cu's structure: lane k of a warp owns a strip of 12 rows and
//   keeps the strip's three planes in registers; the warp sweeps the read
//   columns in a wavefront (step t, lane k: column t - k + 1), the row
//   above a strip comes from lane k - 1 through __shfl_up_sync; the
//   borders are computed from their closed form.
// - The row bands of one alignment on the warps of one CTA: W = min(bands,
//   kMaxWarps) warps, warp w takes bands w, w + W, ... Band j's lane 31
//   hands each column's last row (three floats) to band j + 1's lane 0
//   through a per-alignment scratch, one row of 3 * n2 floats a band
//   boundary, written with __stcg (it stays in L2), and publishes its
//   progress every kPollCols columns in a shared-memory counter after a
//   __threadfence_block(); the consumer's lane 0 checks the counter once
//   per kPollCols columns, and then the consumer's lanes fetch the
//   chunk's kPollCols columns at once, one L2 round trip a chunk (an L2
//   load a step, used at once, stalled the warp every step). A band waits
//   only on the band above, which never waits back, and every warp of the
//   CTA is resident: no deadlock. A band starts ~31 + kPollCols steps
//   after the band above.
// - One byte per interior cell, in dp_align's wavefront layout (tb_bytes),
//   the zero flags inside it: 2 bits a plane z, the direction (0-2) where
//   plane z is not 0.0 and kFieldZero (3) where it is. The walk reads the
//   direction only where the plane is not 0.0, so it reads one byte a
//   step and stops on a field of 3.
// - The argmax: each lane keeps a running best, compared with better()
//   (highest value, then smallest diagonal, then smallest x), not by
//   visiting order; the borders enter from their closed form. Inside a
//   step the strip's best row is found without a branch (its rows share
//   the column, so the first of equal values wins), and only it is
//   folded into the running best, once a step. A warp
//   shuffle reduction, then one across the warps through shared memory.
//   The kernel has two __syncthreads(): that one, and the one that orders
//   the reset of the progress counters.
// - Then warp 0 walks from the argmax cell through shared-memory windows
//   of kLocalWalkSteps steps of a band (dp_align.cu's walk), puts the ops,
//   2 bits each and in reverse, into shared memory and writes the fused
//   row in forward order. Nothing but the traceback, the hand-off scratch
//   and the fused rows touches device memory.
//
// Rows whose lengths lie outside the bucket get a fused row with n_ops
// 0xFFFFFFFF, a NaN score, zero coordinates and OP_DONE ops, and no
// traceback.
//
// Exactness: all scores are dyadic f32 sums (batch.py:18-21); the build
// passes --fmad=false, and every cell evaluates its candidates in the plain
// version's order, so results equal the plain versions byte for byte.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

constexpr int kMaxWarps = 10;          // warps (row bands in flight) a CTA
constexpr int kPollCols = 16;          // columns between progress checks
constexpr int kLocalWalkSteps = 32;    // steps of a walk window
constexpr uint32_t kFieldZero = 3;     // the field of a plane holding 0.0

__host__ __device__ inline int bands(int n1) {
  return (strips(n1) + 31) / 32;
}

// bytes of the reversed 2-bit ops (n1 + n2 ops at most), 16-byte aligned
__host__ __device__ inline int rev_bytes(int n1, int n2) {
  return ((n1 + n2 + 3) / 4 + 15) / 16 * 16;
}

// Dynamic shared memory of one CTA: the walk window, the reversed ops and
// one progress counter a band.
__host__ __device__ inline int local_smem_bytes(int n1, int n2) {
  return kLocalWalkSteps * row_bytes(32) + rev_bytes(n1, n2) + 4 * bands(n1);
}

struct LocalArgs {
  const uint8_t* refs;      // [R, ref_stride], R == 1 (stride 0) or B
  int ref_stride;
  const uint8_t* reads;     // [B, read_stride]
  int read_stride;
  const int* ref_lens;      // [B]
  const int* read_lens;     // [B]
  const float* params;      // [6]
  uint8_t* tb;              // [B, tb_bytes] in the wavefront layout
  float* scratch;           // [B, bands - 1, n2, 3] when bands > 1
  uint8_t* fused;           // [B, 24 + ceil((n1 + n2) / 4)]
  int n1;
  int n2;
  int special;              // 0 none, 1 ref_n_only, 2 both
};

// A candidate of the argmax: its value, the value of its start plane
// (the score), its diagonal, x and start plane.
struct Best {
  float v;
  float s;
  int d;
  int x;
  int z;
};

// (v1, d1, x1) beats (v2, d2, x2): higher value, then earlier diagonal,
// then smaller x (find_max_value_3d_array, alignment_matrix.rs:868-899)
__device__ __forceinline__ bool better(float v1, int d1, int x1, float v2,
                                       int d2, int x2) {
  return v1 > v2 || (v1 == v2 && (d1 < d2 || (d1 == d2 && x1 < x2)));
}

// Fold the cell (x, d - x) with planes m, dv, iv into the running best.
// The start plane is the argmax over the planes, the later plane winning
// ties (corner_to_z0_score).
__device__ __forceinline__ void consider(Best& b, float m, float dv, float iv,
                                         int d, int x) {
  const float v = fmaxf(m, fmaxf(dv, iv));
  if (v >= b.v && better(v, d, x, b.v, b.d, b.x)) {
    b.v = v;
    b.d = d;
    b.x = x;
    b.z = (iv >= fmaxf(m, dv)) ? 2 : ((dv >= m) ? 1 : 0);
    b.s = b.z == 2 ? iv : (b.z == 1 ? dv : m);
  }
}

// The warp's best lands in lane 0.
__device__ __forceinline__ void reduce_warp(Best& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(kFull, b.v, off);
    o.s = __shfl_down_sync(kFull, b.s, off);
    o.d = __shfl_down_sync(kFull, b.d, off);
    o.x = __shfl_down_sync(kFull, b.x, off);
    o.z = __shfl_down_sync(kFull, b.z, off);
    if (better(o.v, o.d, o.x, b.v, b.d, b.x)) b = o;
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
align_local_kernel(const LocalArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Best s_best[kMaxWarps];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int n1 = a.n1;
  const int n2 = a.n2;
  const int P = (n1 + n2 + 3) / 4;
  uint8_t* out = a.fused + static_cast<size_t>(b) * (24 + P);
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];

  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) {
    // lengths outside the bucket (the whole CTA leaves before a barrier):
    // n_ops 0xFFFFFFFF, a NaN score, zero coordinates and no ops, which
    // the host raises on when it reads the row back
    // (batch.py::check_marked_rows)
    if (warp == 0) {
      const uint32_t nanb = __float_as_uint(nanf(""));
      for (int q = lane; q < 24 + P; q += 32)
        out[q] = q < 4 ? 0xFF
                       : (q < 8 ? static_cast<uint8_t>(nanb >> (8 * (q - 4)))
                                : (q < 24 ? 0 : 0xFF));
    }
    return;
  }

  uint4* s_win = reinterpret_cast<uint4*>(smem);
  uint8_t* s_rev = smem + kLocalWalkSteps * row_bytes(32);
  volatile int* s_prog =
      reinterpret_cast<volatile int*>(s_rev + rev_bytes(n1, n2));
  const int nb = bands(n1);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_prog[i] = 0;

  const float m_s = a.params[0], mm_s = a.params[1], sp_s = a.params[2];
  const float go = a.params[3], ge = a.params[4], fgm = a.params[5];
  const float x1_n = go + ge * 1.0f;                  // gm = 1
  const float x1_t = go + ge * fgm;                   // gm = fgm
  const int special = a.special;
  // the gap border of row or column k >= 1: (go + k * ge) * fgm
  auto border = [&](int k) {
    return (go + static_cast<float>(k) * ge) * fgm;
  };

  // the borders enter the argmax from their closed form: (0, 0), then
  // (0, y) for y = 1..l2 and (x, 0) for x = 1..l1
  Best best{-INFINITY, 0.0f, INT_MAX, INT_MAX, 0};
  for (int k = threadIdx.x; k <= l1 + l2; k += blockDim.x) {
    if (k == 0) {
      consider(best, 0.0f, kMaxNegScore, kMaxNegScore, 0, 0);
    } else {
      const int i = k <= l2 ? k : k - l2;
      const float g = border(i);
      consider(best, kMaxNegScore, g, g, i, k <= l2 ? 0 : i);
    }
  }
  __syncthreads();                     // the progress counters are reset

  uint8_t* tbb = a.tb + static_cast<size_t>(b) * tb_bytes(n1, n2);
  if (l1 > 0 && l2 > 0) {
    const uint8_t* ref = a.refs + static_cast<size_t>(b) * a.ref_stride;
    const uint8_t* read = a.reads + static_cast<size_t>(b) * a.read_stride;
    float* scr = a.scratch + static_cast<size_t>(b) * (nb - 1) * 3 * n2;
    const int nbands = (l1 + kBandRows - 1) / kBandRows;
    for (int band = warp; band < nbands; band += W) {
      const int x0 = band * kBandRows + lane * kStripRows + 1;
      const bool active = x0 <= l1;
      const int nreal = l1 - x0 + 1;   // rows of the strip inside the DP
      // lanes of this band that hold a row <= l1
      const int nact = min(32, (l1 - band * kBandRows + kStripRows - 1) /
                                   kStripRows);
      const int rs = row_bytes(band_lanes(n1, band));
      uint8_t* tbs = tbb + band_base(n2, band) + lane * kStripRows;
      float M[kStripRows], Dp[kStripRows], Ip[kStripRows];
      int rb[kStripRows];
      uint32_t rsp = 0;        // bit r: row r's reference byte is special
#pragma unroll
      for (int r = 0; r < kStripRows; ++r) {
        const int x = x0 + r;
        const bool real = x <= l1;
        rb[r] = real ? static_cast<int>(ref[x - 1]) : 0;
        const bool sp = special == 2 ? (rb[r] == 78 || rb[r] < 58)
                                     : (special == 1 && rb[r] == 78);
        rsp |= static_cast<uint32_t>(real && sp) << r;
        // column 0: the y = 0 border
        M[r] = real ? kMaxNegScore : 0.0f;
        Dp[r] = Ip[r] = real ? border(x) : 0.0f;
      }
      // the row above the strip at the previous column (diagonal inputs of
      // the strip's first row); column 0 to begin with
      float um = x0 == 1 ? 0.0f : kMaxNegScore;
      float ud = x0 == 1 ? kMaxNegScore : border(x0 - 1);
      float ui = ud;
      const float* scr_in =
          band > 0 ? scr + static_cast<size_t>(band - 1) * 3 * n2 : nullptr;
      float* scr_out = scr + static_cast<size_t>(band) * 3 * n2;
      const bool hand_on = lane == 31 && band + 1 < nbands;

      const int steps = l2 + nact - 1;
      int ry_next = (active && lane == 0) ? read[0] : 0;
      for (int t0 = 0; t0 < steps; t0 += kPollCols) {
        // lane 0 reads the band above's last row at columns t0 + 1 ..
        // t0 + kPollCols in this chunk: wait until it is handed on, then
        // lane q fetches column t0 + 1 + q, one L2 round trip a chunk
        float hm = 0.0f, hd = 0.0f, hi = 0.0f;
        if (band > 0) {
          if (lane == 0) {
            const int need = min(t0 + kPollCols, l2);
            while (s_prog[band - 1] < need) __nanosleep(32);
          }
          __syncwarp();
          __threadfence_block();
          const int yq = t0 + 1 + lane;
          if (lane < kPollCols && yq <= l2) {
            hm = __ldcg(scr_in + 3 * yq);
            hd = __ldcg(scr_in + 3 * yq + 1);
            hi = __ldcg(scr_in + 3 * yq + 2);
          }
        }
        const int t1 = min(t0 + kPollCols, steps);
        for (int t = t0; t < t1; ++t) {
          const int y = t - lane + 1;
          // the row above the strip at column y: lane k - 1's last row,
          // computed at the previous step; lane 0 takes the border row or
          // the band above's last row
          float vm = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
          float vd = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
          float vi = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
          if (band > 0) {                      // warp-uniform
            const float qm = __shfl_sync(kFull, hm, t - t0);
            const float qd = __shfl_sync(kFull, hd, t - t0);
            const float qi = __shfl_sync(kFull, hi, t - t0);
            if (lane == 0) {
              vm = qm;
              vd = qd;
              vi = qi;
            }
          } else if (lane == 0) {
            vm = kMaxNegScore;
            vd = vi = border(y);
          }
          const bool in = active && y >= 1 && y <= l2;
          const int ry = ry_next;
          if (active && y + 1 >= 1 && y + 1 <= l2) ry_next = read[y];
          if (!in) continue;
          const bool ysp = special == 2 && (ry == 78 || ry < 58);
          const float ms_eq = ysp ? sp_s : m_s;
          const float ms_ne = ysp ? sp_s : mm_s;
          const bool last_col = y == l2;
          // diagonal (x - 1, y - 1) and up (x - 1, y) inputs of row x0
          float dm = um, dd = ud, di = ui;
          float pm = vm, pd = vd, pi = vi;
          uint32_t w[3] = {0u, 0u, 0u};
          // the strip's best cell of this column: highest value, then the
          // smallest row (smallest diagonal and x), rows <= l1 only
          float sv = -INFINITY;
          int sr = 0;
#pragma unroll
          for (int r = 0; r < kStripRows; ++r) {
            const int x = x0 + r;
            const float lm = M[r], ld = Dp[r], li = Ip[r];   // (x, y - 1)
            const float ms = ((rsp >> r) & 1u)
                                 ? sp_s : (rb[r] == ry ? ms_eq : ms_ne);
            // the gap planes extend with the unscaled ge but open with
            // x1, which keeps the terminal-gap multiplier
            const float x1 = (last_col || x == l1) ? x1_t : x1_n;
            float mm = dm + ms;
            mm = fmaxf(fmaxf(0.0f, mm), ms);
            uint32_t m_dir, d_dir, i_dir;
            const float nm = three_way(dd + ms, di + ms, mm, &m_dir);
            const float nd = three_way(pd + ge, pi + x1, pm + x1, &d_dir);
            const float ni = three_way(ld + x1, li + ge, lm + x1, &i_dir);
            m_dir = nm == 0.0f ? kFieldZero : m_dir;
            d_dir = nd == 0.0f ? kFieldZero : d_dir;
            i_dir = ni == 0.0f ? kFieldZero : i_dir;
            const float v = r < nreal ? fmaxf(nm, fmaxf(nd, ni)) : -INFINITY;
            const bool gt = v > sv;
            sv = gt ? v : sv;
            sr = gt ? r : sr;
            M[r] = nm;
            Dp[r] = nd;
            Ip[r] = ni;
            dm = lm;
            dd = ld;
            di = li;
            pm = nm;
            pd = nd;
            pi = ni;
            w[r / 4] |= (m_dir | (d_dir << 2) | (i_dir << 4)) << (8 * (r % 4));
          }
          if (sv >= best.v && better(sv, x0 + sr + y, x0 + sr, best.v,
                                     best.d, best.x)) {
            float m = M[0], dv = Dp[0], iv = Ip[0];
#pragma unroll
            for (int r = 1; r < kStripRows; ++r) {
              if (r == sr) {
                m = M[r];
                dv = Dp[r];
                iv = Ip[r];
              }
            }
            consider(best, m, dv, iv, x0 + sr + y, x0 + sr);
          }
          uint32_t* dst =
              reinterpret_cast<uint32_t*>(tbs + static_cast<size_t>(t) * rs);
          dst[0] = w[0];
          dst[1] = w[1];
          dst[2] = w[2];
          if (hand_on) {
            __stcg(scr_out + 3 * y, M[kStripRows - 1]);
            __stcg(scr_out + 3 * y + 1, Dp[kStripRows - 1]);
            __stcg(scr_out + 3 * y + 2, Ip[kStripRows - 1]);
            if (y % kPollCols == 0 || last_col) {
              __threadfence_block();
              s_prog[band] = y;
            }
          }
          um = vm;
          ud = vd;
          ui = vi;
        }
      }
    }
  }

  // the CTA's argmax: warp shuffles, then warp 0 over the warps
  reduce_warp(best);
  if (lane == 0) s_best[warp] = best;
  __syncthreads();                     // and the traceback is complete
  if (warp != 0) return;
  if (lane < W) {
    best = s_best[lane];
  } else {
    best = Best{-INFINITY, 0.0f, INT_MAX, INT_MAX, 0};
  }
  reduce_warp(best);
  const int ex = __shfl_sync(kFull, best.x, 0);
  const int ey = __shfl_sync(kFull, best.d, 0) - ex;
  int z = __shfl_sync(kFull, best.z, 0);
  const float score = __shfl_sync(kFull, best.s, 0);

  // the walk, run by every lane of warp 0 alike (lane 0 stores the ops):
  // in the core the op is the current plane and the next plane is its
  // field, until a field of kFieldZero
  int x = ex, y = ey, nc = 0;
  int wj = -1, wt = 0, wrs = 0;  // window: band wj, steps [wt, wt + 32)
  uint32_t acc = 0;
  const uint8_t* win = reinterpret_cast<const uint8_t*>(s_win);
  while (x > 0 && y > 0) {
    const int j = (x - 1) / kBandRows;
    const int xr = x - 1 - j * kBandRows;
    const int k = xr / kStripRows;
    const int t = y + k - 1;
    if (j != wj || t < wt) {
      wj = j;
      wt = max(0, t - (kLocalWalkSteps - 1));
      const int nl = band_lanes(n1, j);
      wrs = row_bytes(nl);
      const int steps = min(kLocalWalkSteps, n2 - 2 + nl - wt);
      const int n16 = steps * wrs / 16;
      const uint4* src = reinterpret_cast<const uint4*>(
          tbb + band_base(n2, j) + static_cast<size_t>(wt) * wrs);
      __syncwarp();
      for (int i = lane; i < n16; i += 32) s_win[i] = __ldcg(src + i);
      __syncwarp();
    }
    const uint32_t field = (win[(t - wt) * wrs + xr] >> (2 * z)) & 3u;
    if (field == kFieldZero) break;
    acc |= static_cast<uint32_t>(z) << (2 * (nc & 3));
    if ((nc & 3) == 3) {
      if (lane == 0) s_rev[nc >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
    ++nc;
    x -= (z == 2) ? 0 : 1;
    y -= (z == 1) ? 0 : 1;
    z = static_cast<int>(field);
  }
  if ((nc & 3) != 0 && lane == 0) s_rev[nc >> 2] = static_cast<uint8_t>(acc);
  __syncwarp();

  // [n_ops, score, ref_start, read_start, ref_end, read_end], little-endian
  const uint32_t head =
      lane < 4 ? static_cast<uint32_t>(nc)
               : (lane < 8 ? __float_as_uint(score)
                           : static_cast<uint32_t>(
                                 lane < 12 ? x
                                           : (lane < 16 ? y
                                                        : (lane < 20 ? ex
                                                                     : ey))));
  if (lane < 24) out[lane] = static_cast<uint8_t>(head >> (8 * (lane & 3)));
  // forward op j is the walk's op nc - 1 - j; OP_DONE past n_ops
  for (int q = lane; q < P; q += 32) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      uint32_t op = kOpDone;
      if (j < nc) {
        const int r = nc - 1 - j;
        op = (s_rev[r >> 2] >> (2 * (r & 3))) & 3u;
      }
      packed |= op << (2 * i);
    }
    out[24 + q] = static_cast<uint8_t>(packed);
  }
}

}  // namespace
}  // namespace clique_dp

// Warps of one CTA: one a row band of 384 rows, at most 10.
extern "C" int clique_dp_align_local_warps(int n1) {
  using namespace clique_dp;
  return bands(n1) < kMaxWarps ? bands(n1) : kMaxWarps;
}

// Floats of hand-off scratch one alignment needs: a row of 3 * n2 a band
// boundary, so 0 for n1 - 1 <= 384.
extern "C" long long clique_dp_align_local_scratch_floats(int n1, int n2) {
  using namespace clique_dp;
  return (bands(n1) - 1) * 3LL * n2;
}

// Dynamic shared memory of one CTA.
extern "C" int clique_dp_align_local_smem_bytes(int n1, int n2) {
  using namespace clique_dp;
  return local_smem_bytes(n1, n2);
}

// Launch the fused local fill + walk on `stream`, one CTA an alignment:
// the full band, tie order up > left > diag. refs [R, ref_stride] u8 with
// R == 1 (uniform reference, ref_stride passed as 0) or R == B; reads
// [B, read_stride] u8; lens [B] i32; params [6] f32 (match, mismatch,
// special, gap_open, gap_extend, final_gap_multiplier); tb
// [B, clique_dp_align_tb_bytes] u8 out (interior cells only, one byte a
// cell: 2 bits a plane, the direction or 3 where the plane holds 0.0);
// scratch [B, clique_dp_align_local_scratch_floats] f32 when that is not
// 0, else null; fused [B, 24 + ceil((n1 + n2) / 4)] u8 out. special:
// 0 none, 1 ref_n_only, 2 both. Returns the CUDA error of the launch (0 on
// success).
extern "C" int clique_dp_align_local(const void* refs, int ref_stride,
                                     const void* reads, int read_stride,
                                     const void* ref_lens,
                                     const void* read_lens,
                                     const void* params, void* tb,
                                     void* scratch, void* fused, int B,
                                     int n1, int n2, int special,
                                     void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2) return cudaErrorInvalidValue;
  if ((clique_dp_align_local_scratch_floats(n1, n2) != 0) !=
      (scratch != nullptr))
    return cudaErrorInvalidValue;
  LocalArgs a{};
  a.refs = static_cast<const uint8_t*>(refs);
  a.ref_stride = ref_stride;
  a.reads = static_cast<const uint8_t*>(reads);
  a.read_stride = read_stride;
  a.ref_lens = static_cast<const int*>(ref_lens);
  a.read_lens = static_cast<const int*>(read_lens);
  a.params = static_cast<const float*>(params);
  a.tb = static_cast<uint8_t*>(tb);
  a.scratch = static_cast<float*>(scratch);
  a.fused = static_cast<uint8_t*>(fused);
  a.n1 = n1;
  a.n2 = n2;
  a.special = special;
  const int smem = local_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        align_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  align_local_kernel<<<B, clique_dp_align_local_warps(n1) * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
