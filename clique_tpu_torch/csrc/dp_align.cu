// Global 3-plane affine DP fill, traceback walk, op epilogue and result
// fusion in one kernel for Hopper (sm_90a): the full band or a partial band
// around f64 band centers, tie order up > left > diag or keep-last, the
// special-byte rules "both", "ref_n_only" and "none", any n1.
//
// Replaces: clique_tpu/align/pallas_kernel.py::_fill_kernel (the global,
// full-band fill; the only pl.pallas_call in the JAX package), the XLA
// branches of clique_tpu/align/batch.py::align_batch_device that the Pallas
// route does not take (the band :287-290, special_mode "none" :242-245,
// keep-last ties :265-277), and the XLA code that follows the fill:
// _corner_to_z0_score (:495-501), _finish_from_packed_traceback (:565-607),
// _ops_epilogue (:610-635) and fuse_result (:504-515). The plain versions
// are align/batch.py::fill_reference + walk_reference.
//
// What bounds it on an H100: about 30 lane instructions per interior cell
// (the three candidate sums of each plane, their compares and selects, the
// byte pack), so at the bench shape (B=1024, l1=l2=342: 1.2e8 cells) the
// FP32 lanes need ~0.11 ms; the traceback is one byte per interior cell
// (120 MB, ~0.036 ms at 3.35 TB/s). It is compute-bound.
//
// What the design does about it:
// - One warp per alignment, kWarpsPerCta warps per CTA, and no
//   __syncthreads(): lane k owns a strip of kStripRows = 12 consecutive DP
//   rows and keeps the strip's three planes for the current column, its
//   reference bytes and (banded) its rows' band limits in registers.
// - The warp sweeps the read columns y in a wavefront: at step t lane k
//   computes column y = t - k + 1, top to bottom. The row above its strip
//   comes from lane k - 1's last row through __shfl_up_sync, computed one
//   step earlier; there is no shared-memory ring and no barrier.
// - n1 - 1 > 32 * 12 rows: the warp processes row bands of 384 rows, one
//   after another; each band hands its last row (three floats a column)
//   to the next through a per-alignment global scratch that stays in L2.
// - Only what the alignment needs is visited: columns 1..l2 and the strips
//   that hold rows <= l1; the borders are computed from their closed form.
// - The traceback is stored only for interior cells, in wavefront order:
//   at each step the warp's lanes write their strips' 12 bytes side by
//   side, so one step of a row band is one contiguous row of 32 * 12 bytes
//   and the three 32-bit stores of a step coalesce (a strip-major layout
//   sends each lane to its own cache line, 32 lines a store). A band of nl
//   lanes holds n2 - 2 + nl steps of round_up(12 nl, 16) bytes; that is
//   ~(n1 - 1) * (n2 + 30) bytes an alignment instead of the old
//   (n1 + n2 - 1) * n1.
// - Then the same warp walks its alignment from the (l1, l2) corner. The
//   walk reads a window of 16 steps of its band (6 KB, every lane's strip)
//   into shared memory with one coalesced 16-byte load a lane and step,
//   and steps through it at shared-memory latency until the path leaves
//   the window (the path's step index only falls, by one or two a move).
//   The ops go, 2 bits each and in reverse, into a per-warp shared buffer;
//   the warp then writes the fused row [n_ops i32, score f32, ops] in
//   forward order. Nothing but the traceback and the fused row touches
//   device memory.
// - A band test is per cell; a banded fill visits the same columns (the
//   warp's lanes sit on different columns at each step, so skipping
//   columns outside one lane's band would not shorten the warp's loop).
//
// Cells outside the band keep value 0 and the fresh traceback byte, as the
// XLA scan leaves them. Rows whose lengths lie outside the bucket get a
// fused row with n_ops -1, a NaN score and no ops, and no traceback.
//
// Exactness: all scores are dyadic f32 sums (batch.py:18-21); the build
// passes --fmad=false, and every cell evaluates its candidates in the
// reference's order, so results equal the plain versions byte for byte.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

constexpr int kWarpsPerCta = 4;
constexpr int kWalkSteps = 16;                   // steps of a walk window

// Per-warp shared memory: the walk window and the reversed 2-bit ops
// (T = n1 + n2 ops at most), 16-byte aligned.
__host__ __device__ inline int warp_smem_bytes(int n1, int n2) {
  const int rev = ((n1 + n2 + 3) / 4 + 15) / 16 * 16;
  return kWalkSteps * row_bytes(32) + rev;
}

struct AlignArgs {
  const uint8_t* refs;      // [R, ref_stride], R == 1 (stride 0) or B
  int ref_stride;
  const uint8_t* reads;     // [B, read_stride]
  int read_stride;
  const int* ref_lens;      // [B]
  const int* read_lens;     // [B]
  const float* params;      // [6]
  const int* bandwidth;     // [B] band half-width; null for the full band
  const int* centers;       // [B, n1] band centers; null for the full band
  uint8_t* tb;              // [B, tb_bytes] in the wavefront layout
  float* scratch;           // [B, 2, n2, 3] when n1 - 1 > kBandRows
  uint8_t* fused;           // [B, 8 + ceil((n1 + n2) / 4)]
  int n1;
  int n2;
  int special;              // 0 none, 1 ref_n_only, 2 both
};

// Rust max_by keep-LAST over [a, b, c]: c wins ties against everything, b
// against a (batch.py:91-100); the value is the chosen candidate
__device__ __forceinline__ float max_last(float a, float b, float c,
                                          uint32_t da, uint32_t db,
                                          uint32_t dc, uint32_t* dir) {
  const float ab = fmaxf(a, b);
  if (c >= ab) {
    *dir = dc;
    return c;
  }
  *dir = (b >= a) ? db : da;
  return (b >= a) ? b : a;
}

template <bool kTieLast, bool kBanded>
__global__ void __launch_bounds__(kWarpsPerCta * 32, 3)
align_kernel(const AlignArgs a, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerCta + warp;
  if (b >= B) return;                  // whole warps only: no CTA barrier
  const int n1 = a.n1;
  const int n2 = a.n2;
  const int P = (n1 + n2 + 3) / 4;
  unsigned char* wsm = smem + warp * warp_smem_bytes(n1, n2);
  uint4* s_win = reinterpret_cast<uint4*>(wsm);
  uint8_t* s_rev = wsm + kWalkSteps * row_bytes(32);
  uint8_t* out = a.fused + static_cast<size_t>(b) * (8 + P);
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];

  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) {
    // lengths outside the bucket: n_ops -1, a NaN score and no ops, which
    // the host raises on when it reads the row back
    // (batch.py::check_marked_rows)
    const uint32_t nanb = __float_as_uint(nanf(""));
    for (int q = lane; q < 8 + P; q += 32)
      out[q] = q < 4 ? 0xFF
                     : (q < 8 ? static_cast<uint8_t>(nanb >> (8 * (q - 4)))
                              : 0xFF);
    return;
  }

  const float m_s = a.params[0], mm_s = a.params[1], sp_s = a.params[2];
  const float go = a.params[3], ge = a.params[4], fgm = a.params[5];
  const float ext_n = ge * 1.0f, x1_n = go + ext_n;   // gm = 1
  const float ext_t = ge * fgm, x1_t = go + ext_t;    // gm = fgm
  const int special = a.special;
  const uint8_t* ref = a.refs + static_cast<size_t>(b) * a.ref_stride;
  const uint8_t* read = a.reads + static_cast<size_t>(b) * a.read_stride;
  uint8_t* tbb = a.tb + static_cast<size_t>(b) * tb_bytes(n1, n2);
  float* scr = a.scratch != nullptr
                   ? a.scratch + static_cast<size_t>(b) * 6 * n2
                   : nullptr;
  // the gap border of row or column k >= 1: (go + k * ge) * fgm
  auto border = [&](int k) {
    return (go + static_cast<float>(k) * ge) * fgm;
  };

  // the (l1, l2) corner's three planes, held by the lane that computes it
  float c0, c1, c2;
  if (l1 == 0 && l2 == 0) {
    c0 = 0.0f;
    c1 = c2 = kMaxNegScore;
  } else if (l1 == 0 || l2 == 0) {
    c0 = kMaxNegScore;
    c1 = c2 = border(l1 + l2);
  } else {
    c0 = c1 = c2 = 0.0f;
    const int nbands = (l1 + kBandRows - 1) / kBandRows;
    for (int band = 0; band < nbands; ++band) {
      const int x0 = band * kBandRows + lane * kStripRows + 1;
      const bool active = x0 <= l1;
      // lanes of this band that hold a row <= l1
      const int nact = min(32, (l1 - band * kBandRows + kStripRows - 1) /
                                   kStripRows);
      // this lane's bytes of the band's step 0
      const int rs = row_bytes(band_lanes(n1, band));
      uint8_t* tbs = tbb + band_base(n2, band) + lane * kStripRows;
      float M[kStripRows], Dp[kStripRows], Ip[kStripRows];
      int rb[kStripRows];
      int lo[kStripRows], hi[kStripRows];     // band limits (banded only)
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
        if (kBanded) {
          const int c = real ? a.centers[static_cast<size_t>(b) * n1 + x] : 0;
          const int bw = a.bandwidth[b];
          lo[r] = real ? max(1, c - bw) : 0;
          hi[r] = real ? min(l2 + 1, c + bw) : 0;
        }
      }
      // the row above the strip at the previous column (diagonal inputs of
      // the strip's first row); column 0 to begin with
      float um = x0 == 1 ? 0.0f : kMaxNegScore;
      float ud = x0 == 1 ? kMaxNegScore : border(x0 - 1);
      float ui = ud;
      const float* scr_in =
          scr != nullptr ? scr + ((band + 1) & 1) * 3 * n2 : nullptr;
      float* scr_out = scr != nullptr ? scr + (band & 1) * 3 * n2 : nullptr;
      const bool hand_on = lane == 31 && band + 1 < nbands;

      const int steps = l2 + nact - 1;
      int ry_next = (active && lane == 0) ? read[0] : 0;
      for (int t = 0; t < steps; ++t) {
        const int y = t - lane + 1;
        // the row above the strip at column y: lane k - 1's last row,
        // computed at the previous step; lane 0 takes the border row or
        // the previous band's last row
        float vm = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
        float vd = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
        float vi = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
        const bool in = active && y >= 1 && y <= l2;
        const int ry = ry_next;
        if (active && y + 1 >= 1 && y + 1 <= l2) ry_next = read[y];
        if (!in) continue;
        if (lane == 0) {
          if (band == 0) {
            vm = kMaxNegScore;
            vd = vi = border(y);
          } else {
            vm = __ldcg(scr_in + 3 * y);
            vd = __ldcg(scr_in + 3 * y + 1);
            vi = __ldcg(scr_in + 3 * y + 2);
          }
        }
        const bool ysp = special == 2 && (ry == 78 || ry < 58);
        const float ms_eq = ysp ? sp_s : m_s;
        const float ms_ne = ysp ? sp_s : mm_s;
        const bool last_col = y == l2;
        // diagonal (x - 1, y - 1) and up (x - 1, y) inputs of row x0
        float dm = um, dd = ud, di = ui;
        float pm = vm, pd = vd, pi = vi;
        uint32_t w[3] = {0u, 0u, 0u};
#pragma unroll
        for (int r = 0; r < kStripRows; ++r) {
          const int x = x0 + r;
          const float lm = M[r], ld = Dp[r], li = Ip[r];   // (x, y - 1)
          float nm = 0.0f, nd = 0.0f, ni = 0.0f;
          uint32_t byte = kTbFresh;
          const bool interior =
              !kBanded || (y >= lo[r] && y < hi[r]);
          if (interior) {
            const float ms = ((rsp >> r) & 1u) ? sp_s
                                              : (rb[r] == ry ? ms_eq : ms_ne);
            const bool term = last_col || x == l1;
            const float ext = term ? ext_t : ext_n;
            const float x1 = term ? x1_t : x1_n;
            uint32_t m_dir, d_dir, i_dir;
            if (kTieLast) {
              // inversion-aware fill: keep-last ties, each plane with its
              // own candidate order; the m plane is floored at MAX_NEG
              const float mm = fmaxf(dm + ms, kMaxNegScore);
              nm = max_last(mm, dd + ms, di + ms, kDiag, kUp, kLeft, &m_dir);
              nd = max_last(pd + ext, pi + x1, pm + x1, kUp, kLeft, kDiag,
                            &d_dir);
              ni = max_last(ld + x1, li + ext, lm + x1, kUp, kLeft, kDiag,
                            &i_dir);
            } else {
              nm = three_way(dd + ms, di + ms, dm + ms, &m_dir);
              nd = three_way(pd + ext, pi + x1, pm + x1, &d_dir);
              ni = three_way(ld + x1, li + ext, lm + x1, &i_dir);
            }
            byte = m_dir | (d_dir << 2) | (i_dir << 4);
          }
          if (last_col && x == l1) {
            c0 = nm;
            c1 = nd;
            c2 = ni;
          }
          M[r] = nm;
          Dp[r] = nd;
          Ip[r] = ni;
          dm = lm;
          dd = ld;
          di = li;
          pm = nm;
          pd = nd;
          pi = ni;
          w[r / 4] |= byte << (8 * (r % 4));
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
        }
        um = vm;
        ud = vd;
        ui = vi;
      }
      __syncwarp();            // the hand-on row is visible to the next band
    }
    // the corner's lane broadcasts it
    const int owner = ((l1 - 1) / kStripRows) % 32;
    c0 = __shfl_sync(kFull, c0, owner);
    c1 = __shfl_sync(kFull, c1, owner);
    c2 = __shfl_sync(kFull, c2, owner);
  }

  // starting plane: argmax over the corner, later plane wins ties
  int z = (c2 >= fmaxf(c0, c1)) ? 2 : ((c1 >= c0) ? 1 : 0);
  const float score = (z == 2) ? c2 : ((z == 1) ? c1 : c0);

  // the walk, run by every lane alike (lane 0 stores the ops): in the core
  // the op is the current plane and the next plane is (byte >> 2z) & 3
  __syncwarp();                // the fill's traceback stores are visible
  int x = l1, y = l2, nc = 0;
  int wj = -1, wt = 0, wrs = 0;  // window: band wj, steps [wt, wt + 16)
  uint32_t acc = 0;
  const uint8_t* win = reinterpret_cast<const uint8_t*>(s_win);
  while (x > 0 && y > 0) {
    const int j = (x - 1) / kBandRows;
    const int xr = x - 1 - j * kBandRows;
    const int k = xr / kStripRows;
    const int t = y + k - 1;
    if (j != wj || t < wt) {
      wj = j;
      wt = max(0, t - (kWalkSteps - 1));
      const int nl = band_lanes(n1, j);
      wrs = row_bytes(nl);
      const int steps = min(kWalkSteps, n2 - 2 + nl - wt);
      const int n16 = steps * wrs / 16;
      const uint4* src = reinterpret_cast<const uint4*>(
          tbb + band_base(n2, j) + static_cast<size_t>(wt) * wrs);
      __syncwarp();
      for (int i = lane; i < n16; i += 32) s_win[i] = __ldcg(src + i);
      __syncwarp();
    }
    const int byte = win[(t - wt) * wrs + xr];
    acc |= static_cast<uint32_t>(z) << (2 * (nc & 3));
    if ((nc & 3) == 3) {
      if (lane == 0) s_rev[nc >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
    ++nc;
    x -= (z == 2) ? 0 : 1;
    y -= (z == 1) ? 0 : 1;
    z = (byte >> (2 * z)) & 3;
  }
  if ((nc & 3) != 0 && lane == 0) s_rev[nc >> 2] = static_cast<uint8_t>(acc);
  // the border run the walk ends with: x deletions or y insertions
  const int tail = x + y;
  const uint32_t tail_op = x > 0 ? kOpDel : kOpIns;
  const int n = nc + tail;
  __syncwarp();

  const uint32_t sb = __float_as_uint(score);
  if (lane < 8)
    out[lane] = static_cast<uint8_t>(
        (lane < 4 ? static_cast<uint32_t>(n) : sb) >> (8 * (lane & 3)));
  // forward op j: the tail run first, then the core ops in walk order
  // reversed; OP_DONE past n_ops
  for (int q = lane; q < P; q += 32) {
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      uint32_t op = kOpDone;
      if (j < tail) {
        op = tail_op;
      } else if (j < n) {
        const int i = nc - 1 - (j - tail);
        op = (s_rev[i >> 2] >> (2 * (i & 3))) & 3u;
      }
      packed |= op << (2 * k);
    }
    out[8 + q] = static_cast<uint8_t>(packed);
  }
}

}  // namespace
}  // namespace clique_dp

// Traceback bytes of one alignment in the wavefront layout (a multiple of
// 16).
extern "C" long long clique_dp_align_tb_bytes(int n1, int n2) {
  using namespace clique_dp;
  return tb_bytes(n1, n2);
}

// Floats of row-band scratch one alignment needs: 2 * 3 * n2 when the rows
// exceed one warp's band (n1 - 1 > 384), else 0.
extern "C" long long clique_dp_align_scratch_floats(int n1, int n2) {
  using namespace clique_dp;
  return n1 - 1 > kBandRows ? 6LL * n2 : 0;
}

// Dynamic shared memory of one CTA.
extern "C" int clique_dp_align_smem_bytes(int n1, int n2) {
  using namespace clique_dp;
  return kWarpsPerCta * warp_smem_bytes(n1, n2);
}

// Launch the fused global fill + walk on `stream`. refs [R, ref_stride] u8
// with R == 1 (uniform reference, ref_stride passed as 0) or R == B; reads
// [B, read_stride] u8; lens [B] i32; params [6] f32 (match, mismatch,
// special, gap_open, gap_extend, final_gap_multiplier); bandwidth [B] i32
// and centers [B, n1] i32 for a partial band, both null for the full band;
// tb [B, clique_dp_align_tb_bytes] u8 out (interior cells only); scratch
// [B, clique_dp_align_scratch_floats] f32 when that is not 0, else null;
// fused [B, 8 + ceil((n1 + n2) / 4)] u8 out. special: 0 none,
// 1 ref_n_only, 2 both; tie_last: 0 up > left > diag, 1 keep-last. Returns
// the CUDA error of the launch (0 on success).
extern "C" int clique_dp_align(const void* refs, int ref_stride,
                               const void* reads, int read_stride,
                               const void* ref_lens, const void* read_lens,
                               const void* params, const void* bandwidth,
                               const void* centers, void* tb, void* scratch,
                               void* fused, int B, int n1, int n2,
                               int special, int tie_last, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2) return cudaErrorInvalidValue;
  if ((centers == nullptr) != (bandwidth == nullptr))
    return cudaErrorInvalidValue;
  if ((clique_dp_align_scratch_floats(n1, n2) != 0) != (scratch != nullptr))
    return cudaErrorInvalidValue;
  AlignArgs a{};
  a.refs = static_cast<const uint8_t*>(refs);
  a.ref_stride = ref_stride;
  a.reads = static_cast<const uint8_t*>(reads);
  a.read_stride = read_stride;
  a.ref_lens = static_cast<const int*>(ref_lens);
  a.read_lens = static_cast<const int*>(read_lens);
  a.params = static_cast<const float*>(params);
  a.bandwidth = static_cast<const int*>(bandwidth);
  a.centers = static_cast<const int*>(centers);
  a.tb = static_cast<uint8_t*>(tb);
  a.scratch = static_cast<float*>(scratch);
  a.fused = static_cast<uint8_t*>(fused);
  a.n1 = n1;
  a.n2 = n2;
  a.special = special;
  const bool banded = centers != nullptr;
  void (*kern)(AlignArgs, int) =
      tie_last ? (banded ? align_kernel<true, true> : align_kernel<true, false>)
               : (banded ? align_kernel<false, true>
                         : align_kernel<false, false>);
  const int smem = clique_dp_align_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + kWarpsPerCta - 1) / kWarpsPerCta;
  kern<<<blocks, kWarpsPerCta * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(a, B);
  return cudaGetLastError();
}
