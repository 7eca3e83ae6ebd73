// One alignment's DP rows split into parts (a device each, or a stream
// each on one device) for Hopper (sm_90a): the fill of one column tile of
// one part, and the walk over one part, of the global 3-plane affine DP
// with the full band, tie order up > left > diag and the special-byte
// rule "both".
//
// Replaces: clique_tpu/parallel/mesh.py::length_sharded_align (:38-63),
// where XLA shards align_batch_device's scan over the reference lanes and
// exchanges a one-lane halo between neighbouring chips every diagonal.
// Here part i owns the rows [r_i, r_{i+1}) of every alignment; the host
// code (clique_tpu_torch/parallel/mesh.py) cuts the columns into tiles
// and, at step s, has part i fill tile s - i once part i - 1 has handed it
// the tile's halo (row r_i - 1 at columns y0 - 1 .. y1 - 1, three f32
// planes a column): one halo a tile, not one a diagonal. Then the walk
// climbs from the corner's part upward, one part after another. The
// plain versions are align/batch.py::fill_segment_reference and
// walk_segment_reference.
//
// What bounds it on an H100: the fill is dp_align's cell, about 30 lane
// instructions an interior cell (compute-bound at many alignments); this
// function's use is a few alignments too long for one device, where it
// is one warp an alignment a part and latency-bound: each step of a warp
// is a chain of 12 dependent cells.
//
// What the design does about it:
// - The fill is dp_align's warp and strip code (csrc/dp_align.cu): one
//   warp an alignment, lane k a strip of 12 rows of a 384-row band, the
//   band's rows swept over the tile's columns in a wavefront with the row
//   above a strip from __shfl_up_sync; the bands of a part one after
//   another. Two rows differ: the first band's top row is the halo (or
//   row 0's border for the first part), the last band's bottom row is
//   written out as the next part's halo. The part's column y0 - 1 comes
//   from its carry (column 0's border for the first tile), and the tile
//   writes its column y1 - 1 back.
// - Each warp stages its tile's read bytes and the row above its band in
//   shared memory, and a band hands its last row to the next band there:
//   dp_align reads that row from L2 every step, which a lone warp (a few
//   alignments) waits for.
// - Parts on their own streams run at once: with k parts, k warps an
//   alignment work on it, each on its own rows.
// - The traceback of a part is dp_align's wavefront layout of its rows as
//   rows 1..n of an alignment of n + 1 rows; with a part's first row at
//   1 + 384 j, its bytes are those of dp_align's bands from j on.
// - The walk is dp_align's: a window of 16 steps of a band in shared
//   memory, read with coalesced 16-byte loads, stepped through at
//   shared-memory latency. It writes the op of each step at the index of
//   the cell it leaves (x + y), so the parts' ops join by position, and
//   hands the cell, plane and score to the part above.
//
// Rows whose lengths lie outside the bucket do no work; the walk marks
// them with the state (-2, -2, 0, NaN), which the host raises on.
//
// Exactness: as dp_align, the build passes --fmad=false and each cell
// evaluates its candidates in the reference's order, so the parts' bytes
// equal the plain versions' and one dp_align call's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_dp {
namespace {

constexpr int kSplitWalkSteps = 16;              // steps of a walk window

// Shared memory of a fill warp for a tile of w columns: the read bytes of
// the tile (16-byte aligned), then two rows of (M, D, I) at its columns
// y0 - 1 .. y1 - 1: the row above the band and the band's last row.
__host__ __device__ inline int split_smem_bytes(int w) {
  return (w + 15) / 16 * 16 + 2 * 3 * 4 * (w + 1);
}

struct SplitFillArgs {
  const uint8_t* refs;      // [B, ref_stride]: row row0 + i scores refs[i]
  int ref_stride;
  const uint8_t* reads;     // [B, read_stride]
  int read_stride;
  const int* ref_lens;      // [B]
  const int* read_lens;     // [B]
  const float* params;      // [6]
  const float* halo_in;     // [B, y1 - y0 + 1, 3]; null for row0 == 1
  float* halo_out;          // [B, y1 - y0 + 1, 3]; null for the last part
  float* carry;             // [B, n, 3]: column y0 - 1 in, y1 - 1 out
  uint8_t* tb;              // [B, tb_bytes(n + 1, n2)]
  float* corner;            // [B, 3]
  int n1;
  int n2;
  int row0;                 // the part's first row
  int n;                    // the part's rows
  int y0;                   // the tile's columns [y0, y1)
  int y1;
};

__global__ void __launch_bounds__(32)
split_fill_kernel(const SplitFillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n1 = a.n1, n2 = a.n2, row0 = a.row0, n = a.n;
  const int y0 = a.y0, y1 = a.y1;
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];
  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) return;
  if (l1 < row0 || l2 < y0) return;    // no cell of this tile
  const int rows = min(l1 - row0 + 1, n);   // the part's rows it has
  const int ye = min(y1 - 1, l2);           // its last column in the tile
  const int cols = y1 - y0 + 1;             // halo columns y0 - 1 .. y1 - 1

  const float m_s = a.params[0], mm_s = a.params[1], sp_s = a.params[2];
  const float go = a.params[3], ge = a.params[4], fgm = a.params[5];
  const float ext_n = ge * 1.0f, x1_n = go + ext_n;   // gm = 1
  const float ext_t = ge * fgm, x1_t = go + ext_t;    // gm = fgm
  const uint8_t* ref = a.refs + static_cast<size_t>(b) * a.ref_stride;
  const uint8_t* read = a.reads + static_cast<size_t>(b) * a.read_stride;
  uint8_t* tbb = a.tb + static_cast<size_t>(b) * tb_bytes(n + 1, n2);
  float* carry = a.carry + static_cast<size_t>(b) * 3 * n;
  float* hout = a.halo_out != nullptr
                    ? a.halo_out + static_cast<size_t>(b) * 3 * cols
                    : nullptr;
  auto border = [&](int k) {
    return (go + static_cast<float>(k) * ge) * fgm;
  };

  // s_read[y - y0] = read[y - 1]; s_in[3q..3q+2] = the planes at column
  // y0 - 1 + q of the row above the band
  uint8_t* s_read = smem;
  float* s_in = reinterpret_cast<float*>(smem + (y1 - y0 + 15) / 16 * 16);
  float* s_out = s_in + 3 * cols;
  for (int q = lane; q <= ye - y0; q += 32) s_read[q] = read[y0 - 1 + q];
  const float* hin = a.halo_in != nullptr
                         ? a.halo_in + static_cast<size_t>(b) * 3 * cols
                         : nullptr;
  for (int q = lane; q <= ye - y0 + 1; q += 32) {
    const int y = y0 - 1 + q;
    if (hin != nullptr) {
      s_in[3 * q] = hin[3 * q];
      s_in[3 * q + 1] = hin[3 * q + 1];
      s_in[3 * q + 2] = hin[3 * q + 2];
    } else {                           // row 0: the origin, then the border
      s_in[3 * q] = y == 0 ? 0.0f : kMaxNegScore;
      s_in[3 * q + 1] = s_in[3 * q + 2] = y == 0 ? kMaxNegScore : border(y);
    }
  }
  __syncwarp();

  // the part's last row goes out as the halo when this alignment has it
  const bool halo_on = hout != nullptr && rows == n;
  const int h_band = (n - 1) / kBandRows;
  const int h_lane = (n - 1) % kBandRows / kStripRows;
  const int h_r = (n - 1) % kStripRows;
  const int nbands = (rows + kBandRows - 1) / kBandRows;
  for (int band = 0; band < nbands; ++band) {
    const int xl0 = band * kBandRows + lane * kStripRows + 1;  // part row
    const int x0 = row0 - 1 + xl0;                              // DP row
    const bool active = xl0 <= rows;
    // lanes of this band that hold a row of the alignment
    const int nact = min(32, (rows - band * kBandRows + kStripRows - 1) /
                                 kStripRows);
    const int rs = row_bytes(band_lanes(n + 1, band));
    uint8_t* tbs = tbb + band_base(n2, band) + lane * kStripRows;
    float M[kStripRows], Dp[kStripRows], Ip[kStripRows];
    int rb[kStripRows];
    uint32_t rsp = 0;        // bit r: row r's reference byte is special
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      const int xl = xl0 + r;
      const bool real = xl <= rows;
      rb[r] = real ? static_cast<int>(ref[xl - 1]) : 0;
      rsp |= static_cast<uint32_t>(real && (rb[r] == 78 || rb[r] < 58)) << r;
      // column y0 - 1: the y = 0 border for the first tile, else the carry
      if (y0 == 1) {
        M[r] = real ? kMaxNegScore : 0.0f;
        Dp[r] = Ip[r] = real ? border(x0 + r) : 0.0f;
      } else {
        M[r] = real ? carry[3 * (xl - 1)] : 0.0f;
        Dp[r] = real ? carry[3 * (xl - 1) + 1] : 0.0f;
        Ip[r] = real ? carry[3 * (xl - 1) + 2] : 0.0f;
      }
    }
    // the row above the strip at column y0 - 1: lane k - 1's last row, or
    // for lane 0 the staged row above the band
    float um = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
    float ud = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
    float ui = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
    if (lane == 0) {
      um = s_in[0];
      ud = s_in[1];
      ui = s_in[2];
    }
    const bool hand_on = lane == 31 && band + 1 < nbands;
    const bool halo_lane = halo_on && band == h_band && lane == h_lane;
    // entry 0 of the next band's row and of the halo: column y0 - 1
    if (hand_on) {
      s_out[0] = M[kStripRows - 1];
      s_out[1] = Dp[kStripRows - 1];
      s_out[2] = Ip[kStripRows - 1];
    }
    auto put_halo = [&](int q) {
      float hm = 0.0f, hd = 0.0f, hi = 0.0f;
#pragma unroll
      for (int r = 0; r < kStripRows; ++r) {
        if (r == h_r) {
          hm = M[r];
          hd = Dp[r];
          hi = Ip[r];
        }
      }
      hout[3 * q] = hm;
      hout[3 * q + 1] = hd;
      hout[3 * q + 2] = hi;
    };
    if (halo_lane) put_halo(0);

    const int steps = ye - y0 + nact;
    for (int t = 0; t < steps; ++t) {
      const int y = y0 + t - lane;
      // the row above the strip at column y: lane k - 1's last row,
      // computed at the previous step; lane 0 reads the staged row
      float vm = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
      float vd = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
      float vi = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
      const bool in = active && y >= y0 && y <= ye;
      if (!in) continue;
      const int q = y - y0 + 1;
      if (lane == 0) {
        vm = s_in[3 * q];
        vd = s_in[3 * q + 1];
        vi = s_in[3 * q + 2];
      }
      const int ry = s_read[y - y0];
      const bool ysp = ry == 78 || ry < 58;
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
        const float ms = ((rsp >> r) & 1u) ? sp_s
                                          : (rb[r] == ry ? ms_eq : ms_ne);
        const bool term = last_col || x == l1;
        const float ext = term ? ext_t : ext_n;
        const float x1 = term ? x1_t : x1_n;
        uint32_t m_dir, d_dir, i_dir;
        const float nm = three_way(dd + ms, di + ms, dm + ms, &m_dir);
        const float nd = three_way(pd + ext, pi + x1, pm + x1, &d_dir);
        const float ni = three_way(ld + x1, li + ext, lm + x1, &i_dir);
        if (last_col && x == l1) {
          float* c = a.corner + 3 * b;
          c[0] = nm;
          c[1] = nd;
          c[2] = ni;
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
        w[r / 4] |= (m_dir | (d_dir << 2) | (i_dir << 4)) << (8 * (r % 4));
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          tbs + static_cast<size_t>(y + lane - 1) * rs);
      dst[0] = w[0];
      dst[1] = w[1];
      dst[2] = w[2];
      if (hand_on) {
        s_out[3 * q] = M[kStripRows - 1];
        s_out[3 * q + 1] = Dp[kStripRows - 1];
        s_out[3 * q + 2] = Ip[kStripRows - 1];
      }
      if (halo_lane) put_halo(q);
      if (y == y1 - 1) {       // the carry: this part's rows at column y1 - 1
#pragma unroll
        for (int r = 0; r < kStripRows; ++r) {
          if (xl0 + r <= rows) {
            carry[3 * (xl0 + r - 1)] = M[r];
            carry[3 * (xl0 + r - 1) + 1] = Dp[r];
            carry[3 * (xl0 + r - 1) + 2] = Ip[r];
          }
        }
      }
      um = vm;
      ud = vd;
      ui = vi;
    }
    __syncwarp();              // the hand-on row is visible to the next band
    float* sw = s_in;
    s_in = s_out;
    s_out = sw;
  }
}

struct SplitWalkArgs {
  const uint8_t* tb;        // [B, tb_bytes(n + 1, n2)]
  const float* corner;      // [B, 3]
  const int* ref_lens;      // [B]
  const int* read_lens;     // [B]
  const float* params;      // [6]
  int* state;               // [B, 4] in/out: x, y, plane, score bits
  uint8_t* ops;             // [B, n1 + n2 - 1] in/out
  int n1;
  int n2;
  int row0;
  int n;
};

__global__ void __launch_bounds__(32)
split_walk_kernel(const SplitWalkArgs a) {
  __shared__ __align__(16) uint4 s_win[kSplitWalkSteps * kBandRows / 16];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n1 = a.n1, n2 = a.n2, row0 = a.row0, n = a.n;
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];
  int* st = a.state + 4 * b;
  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) {
    if (lane == 0) {
      st[0] = st[1] = -2;
      st[2] = 0;
      st[3] = static_cast<int>(__float_as_uint(nanf("")));
    }
    return;
  }
  const bool own = (l1 >= row0 && l1 < row0 + n) || (l1 == 0 && row0 == 1);
  int x, y, z;
  uint32_t sb;
  if (own) {
    // the corner's planes: the border's closed form on row or column 0
    const float go = a.params[3], ge = a.params[4], fgm = a.params[5];
    float c0, c1, c2;
    if (l1 == 0 && l2 == 0) {
      c0 = 0.0f;
      c1 = c2 = kMaxNegScore;
    } else if (l1 == 0 || l2 == 0) {
      c0 = kMaxNegScore;
      c1 = c2 = (go + static_cast<float>(l1 + l2) * ge) * fgm;
    } else {
      c0 = a.corner[3 * b];
      c1 = a.corner[3 * b + 1];
      c2 = a.corner[3 * b + 2];
    }
    // starting plane: argmax over the corner, later plane wins ties
    z = (c2 >= fmaxf(c0, c1)) ? 2 : ((c1 >= c0) ? 1 : 0);
    sb = __float_as_uint((z == 2) ? c2 : ((z == 1) ? c1 : c0));
    x = l1;
    y = l2;
  } else {
    x = st[0];
    y = st[1];
    z = st[2];
    sb = static_cast<uint32_t>(st[3]);
    if (x <= 0 || y <= 0) return;     // not started here, or done
  }
  __syncwarp();                        // every lane has read the state

  uint8_t* ops = a.ops + static_cast<size_t>(b) * (n1 + n2 - 1);
  const uint8_t* tbb = a.tb + static_cast<size_t>(b) * tb_bytes(n + 1, n2);
  const uint8_t* win = reinterpret_cast<const uint8_t*>(s_win);
  int wj = -1, wt = 0, wrs = 0;  // window: band wj, steps [wt, wt + 16)
  // run by every lane alike; lane 0 writes the ops
  while (x >= row0 && y > 0) {
    const int xl = x - row0 + 1;
    const int j = (xl - 1) / kBandRows;
    const int xr = xl - 1 - j * kBandRows;
    const int t = y + xr / kStripRows - 1;
    if (j != wj || t < wt) {
      wj = j;
      wt = max(0, t - (kSplitWalkSteps - 1));
      const int nl = band_lanes(n + 1, j);
      wrs = row_bytes(nl);
      const int steps = min(kSplitWalkSteps, n2 - 2 + nl - wt);
      const int n16 = steps * wrs / 16;
      const uint4* src = reinterpret_cast<const uint4*>(
          tbb + band_base(n2, j) + static_cast<size_t>(wt) * wrs);
      __syncwarp();
      for (int i = lane; i < n16; i += 32) s_win[i] = __ldcg(src + i);
      __syncwarp();
    }
    const int byte = win[(t - wt) * wrs + xr];
    if (lane == 0) ops[x + y] = static_cast<uint8_t>(z);
    x -= (z == 2) ? 0 : 1;
    y -= (z == 1) ? 0 : 1;
    z = (byte >> (2 * z)) & 3;
  }
  if (x > 0 && y > 0) {                // the path leaves the part upward
    if (lane == 0) {
      st[0] = x;
      st[1] = y;
      st[2] = z;
      st[3] = static_cast<int>(sb);
    }
    return;
  }
  // the border run the walk ends with: x deletions or y insertions
  const uint8_t tail_op = x > 0 ? kOpDel : kOpIns;
  for (int q = lane + 1; q <= x + y; q += 32) ops[q] = tail_op;
  if (lane == 0) {
    st[0] = 0;
    st[1] = 0;
    st[2] = z;
    st[3] = static_cast<int>(sb);
  }
}

}  // namespace
}  // namespace clique_dp

// Dynamic shared memory of one fill CTA (one warp) for a tile of w
// columns.
extern "C" int clique_dp_segment_smem_bytes(int w) {
  using namespace clique_dp;
  return split_smem_bytes(w);
}

// Fill columns [y0, y1) of rows [row0, row0 + n) of B alignments on
// `stream`, one warp an alignment: refs [B, ref_stride] u8 (the part's
// rows' reference bytes), reads [B, read_stride] u8, lens [B] i32 (the
// whole alignments'), params [6] f32; halo_in [B, y1 - y0 + 1, 3] f32 (row
// row0 - 1 at columns y0 - 1 .. y1 - 1; null for row0 == 1); halo_out of
// the same shape (row row0 + n - 1; null: not written); carry [B, n, 3]
// f32 in/out; tb [B, clique_dp_align_tb_bytes(n + 1, n2)] u8; corner
// [B, 3] f32. Returns the CUDA error of the launch (0 on success).
extern "C" int clique_dp_segment_fill(
    const void* refs, int ref_stride, const void* reads, int read_stride,
    const void* ref_lens, const void* read_lens, const void* params,
    const void* halo_in, void* halo_out, void* carry, void* tb, void* corner,
    int B, int n1, int n2, int row0, int n, int y0, int y1, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2 || n < 1 || row0 < 1 || row0 + n > n1 ||
      y0 < 1 || y1 <= y0 || y1 > n2 || (halo_in == nullptr) != (row0 == 1))
    return cudaErrorInvalidValue;
  SplitFillArgs a{};
  a.refs = static_cast<const uint8_t*>(refs);
  a.ref_stride = ref_stride;
  a.reads = static_cast<const uint8_t*>(reads);
  a.read_stride = read_stride;
  a.ref_lens = static_cast<const int*>(ref_lens);
  a.read_lens = static_cast<const int*>(read_lens);
  a.params = static_cast<const float*>(params);
  a.halo_in = static_cast<const float*>(halo_in);
  a.halo_out = static_cast<float*>(halo_out);
  a.carry = static_cast<float*>(carry);
  a.tb = static_cast<uint8_t*>(tb);
  a.corner = static_cast<float*>(corner);
  a.n1 = n1;
  a.n2 = n2;
  a.row0 = row0;
  a.n = n;
  a.y0 = y0;
  a.y1 = y1;
  const int smem = split_smem_bytes(y1 - y0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  split_fill_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Walk rows [row0, row0 + n) of B alignments on `stream`, one warp an
// alignment, over the part's tb and corner (as clique_dp_segment_fill left
// them): state [B, 4] i32 (x, y, plane, score bits; -1: not started) and
// ops [B, n1 + n2 - 1] u8 (the op of the step from (x, y) at x + y) in
// place. Returns the CUDA error of the launch (0 on success).
extern "C" int clique_dp_segment_walk(const void* tb, const void* corner,
                                      const void* ref_lens,
                                      const void* read_lens,
                                      const void* params, void* state,
                                      void* ops, int B, int n1, int n2,
                                      int row0, int n, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2 || n < 1 || row0 < 1 || row0 + n > n1)
    return cudaErrorInvalidValue;
  SplitWalkArgs a{};
  a.tb = static_cast<const uint8_t*>(tb);
  a.corner = static_cast<const float*>(corner);
  a.ref_lens = static_cast<const int*>(ref_lens);
  a.read_lens = static_cast<const int*>(read_lens);
  a.params = static_cast<const float*>(params);
  a.state = static_cast<int*>(state);
  a.ops = static_cast<uint8_t*>(ops);
  a.n1 = n1;
  a.n2 = n2;
  a.row0 = row0;
  a.n = n;
  split_walk_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
