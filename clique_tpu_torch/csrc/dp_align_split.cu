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
// What bounds them on an H100: the fill is dp_align's cell, about 30 lane
// instructions an interior cell, compute-bound at many alignments. This
// function's use is a few alignments too long for one device, where the
// dependence sets the time: a warp's step is a chain of 12 dependent
// cells, and a part of 384 b rows is b bands, each a wavefront of
// (tile + 31) steps. The first port ran them one after another in one
// warp: a 4,224-row tile of 512 columns took 11 x 543 steps, 4.39 ms
// (0.0009 of its bound). The walk is a chain of dependent steps, each a
// byte of the part's traceback (126-139 MB at k = 4, more than L2 holds);
// the first port loaded a 16-step window only once it had left the last
// one, and spent most of each step on index arithmetic.
//
// What the design does about it:
// - segment_fill: one thread-block cluster of C CTAs of W warps an
//   (alignment, part), from the host's plan (align/dp_kernels.py::
//   segment_plan, re-checked here): every band of the part in flight at
//   once where 8 CTAs of the warps the registers allow hold them, spread
//   over as many CTAs as that takes (a lone warp's step is shorter with
//   fewer warps on its SM); band j on warp j mod (C W) of the cluster
//   (warp g is warp g mod W of CTA g / W). The cell, its candidates'
//   order and the strip code are dp_align's (csrc/dp_align.cu): lane k a
//   strip of 12 rows of a 384-row band, the band swept over the tile's
//   columns in a wavefront, the row above a strip from __shfl_up_sync.
// - Band j hands its last row (M, D, I a column) to band j + 1 through a
//   ring of R entries in the shared memory of the consumer's CTA: its
//   lane 31 writes each column's entry there (across CTAs through
//   distributed shared memory). The steps run in chunks of kRingChunk:
//   at a chunk's start the consumer's lane 0 waits until the band above
//   has published the chunk's entries, its lanes take one entry each into
//   registers (step t broadcasts entry t + 1 with __shfl_sync) and it
//   publishes what it has consumed; the producer's lane 31 waits while
//   the chunk's entries would overfill the ring, and publishes its
//   progress after the chunk, behind a release fence (dp_align_local's
//   scheme, with the L2 scratch replaced by on-chip memory). The steps
//   inside a chunk wait for nothing. A band starts ~31 + kRingChunk
//   steps after the band above. Where warps take bands in turn, the ring
//   holds a whole tile row, so that every wait is on a lower band: no
//   deadlock (every warp of the cluster is resident).
// - Band 0 takes the halo handed in (or row 0's border) the same way, a
//   chunk ahead from device memory. The last band's bottom row is written
//   out as the next part's halo; the part's column y0 - 1 comes from its
//   carry (column 0's border for the first tile), and the tile writes its
//   column y1 - 1 back.
// - The traceback of a part is dp_align's wavefront layout of its rows as
//   rows 1..n of an alignment of n + 1 rows; with a part's first row at
//   1 + 384 j, its bytes are those of dp_align's bands from j on.
// - segment_walk: one warp an alignment, dp_align's walk over windows of
//   kWalkSteps steps of a band. A band's steps are contiguous bytes, so
//   the next window is known in advance: the steps below the current
//   window in the same band, or, once the walk is in a band's top strip,
//   the end of the band above. kWalkSlots windows live in shared memory;
//   up to kWalkSlots - 1 of them are in flight ahead of the walk, each
//   fetched by one lane with a bulk asynchronous copy (cp.async.bulk)
//   whose completion an mbarrier signals. A step that finds its window in
//   no slot (a wrong prediction) waits for a copy of its own; every slot
//   is tagged with its band and steps, so no step reads stale bytes. The
//   slots' tags live in registers, and a step follows its cell's band,
//   row, step and byte offset without a division or a branch (one branch
//   to the rare cases). It writes the op of each step at the index of the
//   cell it leaves (x + y), so the parts' ops join by position, and hands
//   the cell, plane and score to the part above.
//
// Rows whose lengths lie outside the bucket do no work; the walk marks
// them with the state (-2, -2, 0, NaN), which the host raises on.
//
// Exactness: as dp_align, the build passes --fmad=false and each cell
// evaluates its candidates in the reference's order, so the parts' bytes
// equal the plain versions' and one dp_align call's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace cg = cooperative_groups;

namespace clique_dp {
namespace {

constexpr int kMaxWarps = 12;       // warps a fill CTA (launch bounds)
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kRingChunk = 16;      // ring entries between progress counts
constexpr int kWalkSteps = 32;      // steps of a walk window
constexpr int kWalkSlots = 4;       // windows the walk holds
constexpr int kSmemLimit = 232448;  // shared memory an H100 block may use

// Shared memory of a fill CTA of W warps for a tile of w columns with
// rings of R entries: the tile's read bytes (16-byte aligned), W rings of
// R entries (M, D, I, unused), then W produced and W consumed counts.
__host__ __device__ inline int split_smem_bytes(int w, int W, int R) {
  return (w + 15) / 16 * 16 + W * R * 16 + 2 * 4 * W;
}

// Shared memory of a walk CTA: kWalkSlots windows of a full band.
__host__ __device__ inline int walk_smem_bytes() {
  return kWalkSlots * kWalkSteps * row_bytes(32);
}

// Release / acquire between the warps of a cluster: the ring's entries
// before the count that publishes them, the reads of a chunk before the
// count that frees its slots.
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One lane: copy `bytes` (a multiple of 16) from device memory at src to
// shared memory at dst, both 16-byte aligned; `bar`'s phase completes when
// they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Whether `bar`'s phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return ok != 0;
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
  int C;                    // CTAs a cluster (an alignment)
  int W;                    // warps a CTA
  int R;                    // ring entries (a power of two)
};

// Every CTA of the cluster has reset its counts before any warp of
// another reads or writes them.
__device__ __forceinline__ void sync_cluster(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <class T>
__device__ __forceinline__ T* at_rank(T* local, int rank, int C) {
  return C > 1 ? cg::this_cluster().map_shared_rank(local, rank) : local;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
split_fill_kernel(const SplitFillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, W = a.W, R = a.R, T = C * W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  const int b = blockIdx.x / C;
  const int n1 = a.n1, n2 = a.n2, row0 = a.row0, n = a.n;
  const int y0 = a.y0, y1 = a.y1;
  const int l1 = a.ref_lens[b];
  const int l2 = a.read_lens[b];
  // the same for every CTA of the cluster: they leave together, before
  // any of them touches another's memory
  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) return;
  if (l1 < row0 || l2 < y0) return;    // no cell of this tile
  const int rows = min(l1 - row0 + 1, n);   // the part's rows it has
  const int ye = min(y1 - 1, l2);           // its last column in the tile
  const int cols = y1 - y0 + 1;             // halo columns y0 - 1 .. y1 - 1
  const int ncol = ye - y0 + 2;             // entries a band hands on

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
  const float* hin = a.halo_in != nullptr
                         ? a.halo_in + static_cast<size_t>(b) * 3 * cols
                         : nullptr;
  auto border = [&](int k) {
    return (go + static_cast<float>(k) * ge) * fgm;
  };

  // s_read[y - y0] = read[y - 1]; then the rings and the counts
  uint8_t* s_read = smem;
  float4* s_ring = reinterpret_cast<float4*>(smem + (y1 - y0 + 15) / 16 * 16);
  int* s_prod = reinterpret_cast<int*>(s_ring + W * R);
  int* s_cons = s_prod + W;
  for (int q = threadIdx.x; q <= ye - y0; q += blockDim.x)
    s_read[q] = read[y0 - 1 + q];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_prod[i] = s_cons[i] = 0;
  sync_cluster(C);

  // the part's last row goes out as the halo when this alignment has it
  const bool halo_on = hout != nullptr && rows == n;
  const int h_band = (n - 1) / kBandRows;
  const int h_lane = (n - 1) % kBandRows / kStripRows;
  const int h_r = (n - 1) % kStripRows;
  const int nbands = (rows + kBandRows - 1) / kBandRows;
  for (int band = rank * W + warp; band < nbands; band += T) {
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

    // The row above the band, entry e at column y0 - 1 + e (e < ncol):
    // band 0 reads the halo in (row 0's border for the first part), a chunk
    // ahead; a later band takes it from its ring in this CTA, filled by the
    // band above (base: the entries the warp's earlier bands consumed).
    // Lane q holds entry c * kRingChunk + q of the current chunk c; step t
    // takes entry t + 1 from lane (t + 1) mod kRingChunk.
    float4* ring = s_ring + warp * R;
    volatile int* prod = s_prod + warp;
    volatile int* cons = s_cons + warp;
    const int base = band > 0 ? (band - 1) / T * ncol : 0;
    float cm = 0.0f, cd = 0.0f, ci = 0.0f;   // the current chunk
    float nm = 0.0f, nd = 0.0f, ni = 0.0f;   // band 0: the next chunk
    auto top = [&](int e) {
      if (e >= ncol) return;
      if (hin != nullptr) {
        nm = __ldg(hin + 3 * e);
        nd = __ldg(hin + 3 * e + 1);
        ni = __ldg(hin + 3 * e + 2);
      } else {                         // row 0: the origin, then the border
        const int y = y0 - 1 + e;
        nm = y == 0 ? 0.0f : kMaxNegScore;
        nd = ni = y == 0 ? kMaxNegScore : border(y);
      }
    };
    // warp-wide: chunk c into (cm, cd, ci)
    auto take = [&](int c) {
      if (band == 0) {
        cm = nm;
        cd = nd;
        ci = ni;
        if (lane < kRingChunk) top((c + 1) * kRingChunk + lane);
        return;
      }
      const int need = min((c + 1) * kRingChunk, ncol);
      if (lane == 0)
        while (*prod < base + need) __nanosleep(20);
      __syncwarp();
      fence_cluster();
      const int e = c * kRingChunk + lane;
      if (lane < kRingChunk && e < ncol) {
        const float4 v = ring[(base + e) & (R - 1)];
        cm = v.x;
        cd = v.y;
        ci = v.z;
      }
      fence_cluster();
      __syncwarp();
      if (lane == 0) *cons = base + need;
    };

    // The band this one hands its last row to: warp (band + 1) mod T of
    // the cluster, its ring in that warp's CTA. Lane 31 writes entry q at
    // step q + 30; the counts move at the ends of chunks.
    const bool hand_on = band + 1 < nbands;
    const bool lane_out = hand_on && lane == 31;
    float4* oring = nullptr;
    volatile int* oprod = nullptr;
    volatile int* ocons = nullptr;
    const int obase = band / T * ncol;
    if (hand_on) {
      const int g = (band + 1) % T;
      const int orank = g / W;
      oring = at_rank(s_ring, orank, C) + (g % W) * R;
      oprod = at_rank(s_prod, orank, C) + g % W;
      ocons = at_rank(s_cons, orank, C) + g % W;
    }
    // lane 31: wait until the entries below qend fit the ring
    auto room = [&](int qend) {
      if (!lane_out) return;
      const int need = obase + min(qend, ncol) - R;
      while (*ocons < need) __nanosleep(20);
      fence_cluster();
    };
    // lane 31: the entries below qend are in the ring (the count only
    // rises: the ring's earlier bands left it at obase)
    auto publish = [&](int qend) {
      if (!lane_out || qend < 1) return;
      fence_cluster();
      *oprod = obase + min(qend, ncol);
    };

    if (band == 0 && lane < kRingChunk) top(lane);
    take(0);
    // the row above the strip at column y0 - 1: lane k - 1's last row, or
    // for lane 0 entry 0
    float um = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
    float ud = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
    float ui = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
    {
      const float qm = __shfl_sync(kFull, cm, 0);
      const float qd = __shfl_sync(kFull, cd, 0);
      const float qi = __shfl_sync(kFull, ci, 0);
      if (lane == 0) {
        um = qm;
        ud = qd;
        ui = qi;
      }
    }
    const bool halo_lane = halo_on && band == h_band && lane == h_lane;
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
    room(1);
    if (lane_out)
      oring[obase & (R - 1)] = make_float4(
          M[kStripRows - 1], Dp[kStripRows - 1], Ip[kStripRows - 1], 0.0f);
    if (halo_lane) put_halo(0);

    // chunk c: steps [c K - 1, c K + K - 1), entries c K .. c K + K - 1
    const int steps = ye - y0 + nact;
    for (int c = 0, t = 0; t < steps; ++c) {
      if (c > 0 && c * kRingChunk < ncol) take(c);
      const int t_end = min((c + 1) * kRingChunk - 1, steps);
      room(t_end - 30);
      for (; t < t_end; ++t) {
        const int y = y0 + t - lane;
        // the row above the strip at column y: lane k - 1's last row,
        // computed at the previous step; lane 0 takes entry t + 1
        float vm = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
        float vd = __shfl_up_sync(kFull, Dp[kStripRows - 1], 1);
        float vi = __shfl_up_sync(kFull, Ip[kStripRows - 1], 1);
        const int ce = (t + 1) & (kRingChunk - 1);
        const float qm = __shfl_sync(kFull, cm, ce);
        const float qd = __shfl_sync(kFull, cd, ce);
        const float qi = __shfl_sync(kFull, ci, ce);
        if (lane == 0) {
          vm = qm;
          vd = qd;
          vi = qi;
        }
        const bool in = active && y >= y0 && y <= ye;
        if (!in) continue;
        const int q = y - y0 + 1;
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
          const float nm2 = three_way(dd + ms, di + ms, dm + ms, &m_dir);
          const float nd2 = three_way(pd + ext, pi + x1, pm + x1, &d_dir);
          const float ni2 = three_way(ld + x1, li + ext, lm + x1, &i_dir);
          if (last_col && x == l1) {
            float* cr = a.corner + 3 * b;
            cr[0] = nm2;
            cr[1] = nd2;
            cr[2] = ni2;
          }
          M[r] = nm2;
          Dp[r] = nd2;
          Ip[r] = ni2;
          dm = lm;
          dd = ld;
          di = li;
          pm = nm2;
          pd = nd2;
          pi = ni2;
          w[r / 4] |= (m_dir | (d_dir << 2) | (i_dir << 4)) << (8 * (r % 4));
        }
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            tbs + static_cast<size_t>(y + lane - 1) * rs);
        dst[0] = w[0];
        dst[1] = w[1];
        dst[2] = w[2];
        if (lane_out)
          oring[(obase + q) & (R - 1)] =
              make_float4(M[kStripRows - 1], Dp[kStripRows - 1],
                          Ip[kStripRows - 1], 0.0f);
        if (halo_lane) put_halo(q);
        if (y == y1 - 1) {     // the carry: this part's rows at column y1 - 1
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
      publish(t_end - 30);
    }
    publish(ncol);
  }
  // no CTA leaves while a warp of another may write its rings or read its
  // counts
  if (C > 1) cg::this_cluster().sync();
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
  extern __shared__ __align__(128) unsigned char s_win[];
  __shared__ __align__(8) uint64_t s_bar[kWalkSlots];
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
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kWalkSlots; ++s) mbar_init(&s_bar[s]);
  }
  __syncwarp();                        // the state is read, the bars set

  uint8_t* ops = a.ops + static_cast<size_t>(b) * (n1 + n2 - 1);
  const uint8_t* tbb = a.tb + static_cast<size_t>(b) * tb_bytes(n + 1, n2);
  const int kSlotBytes = kWalkSteps * row_bytes(32);

  // The slots, alike in every lane and indexed only by unrolled loops (so
  // they stay in registers): band, first step and steps of the window
  // each holds (band -1: none); bit s of busy: a copy into slot s is in
  // flight, of phase: the parity of slot s's next phase.
  int tj[kWalkSlots], tt[kWalkSlots], tn[kWalkSlots];
#pragma unroll
  for (int s = 0; s < kWalkSlots; ++s) tj[s] = tt[s] = tn[s] = -1;
  uint32_t busy = 0, phase = 0;
  auto wait = [&](int s) {
    while (!mbar_done(&s_bar[s], (phase >> s) & 1u)) {
    }
    phase ^= 1u << s;
    busy &= ~(1u << s);
  };
  // fetch steps [t0, t0 + kWalkSteps) of band j (as many as it has) into
  // slot s
  auto issue = [&](int s, int j, int t0) {
    if ((busy >> s) & 1u) wait(s);     // a dropped prediction lands first
    const int nl = band_lanes(n + 1, j);
    const int rsj = row_bytes(nl);
    const int steps = min(kWalkSteps, n2 - 2 + nl - t0);
    __syncwarp();                      // every lane is done reading slot s
    if (lane == 0)
      bulk_load(s_win + s * kSlotBytes,
                tbb + band_base(n2, j) + static_cast<long long>(t0) * rsj,
                static_cast<uint32_t>(steps * rsj), &s_bar[s]);
#pragma unroll
    for (int k = 0; k < kWalkSlots; ++k) {
      if (k == s) {
        tj[k] = j;
        tt[k] = t0;
        tn[k] = steps;
      }
    }
    busy |= 1u << s;
  };
  // The windows wanted next, most wanted first: where the walk is in the
  // top strip of band j > 0, the end of band j - 1 at the current column
  // (the walk enters it at a column y' <= y, at step y' + 30); then the
  // windows below the current one in band j.
  int cur = 0, cj = -1, ct0 = 0, crs = 0;
  bool top_asked = false;
  auto plan = [&](bool top, int y_now) {
    int wj[kWalkSlots - 1], wt[kWalkSlots - 1];
    bool wv[kWalkSlots - 1];
#pragma unroll
    for (int k = 0; k < kWalkSlots - 1; ++k) {
      const int i = top ? k : k + 1;   // the window i below the current
      const int t0 = ct0 - i * kWalkSteps;
      const bool above = top && k == 0;
      wj[k] = above ? cj - 1 : cj;
      wt[k] = above ? max(0, y_now + band_lanes(n + 1, cj - 1) - 2 -
                                 (kWalkSteps - 1))
                    : max(0, t0);
      wv[k] = above || t0 + kWalkSteps > 0;
    }
    // a slot is kept when it holds (or fetches) a wanted window
    uint32_t keep = 1u << cur, have = 0;
#pragma unroll
    for (int k = 0; k < kWalkSlots - 1; ++k) {
#pragma unroll
      for (int s = 0; s < kWalkSlots; ++s) {
        if (wv[k] && s != cur && tj[s] == wj[k] && tt[s] == wt[k]) {
          have |= 1u << k;
          keep |= 1u << s;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWalkSlots - 1; ++k) {
      if (wv[k] && !((have >> k) & 1u)) {
        // a free slot, one with no copy in flight if there is one
        int free_s = -1;
#pragma unroll
        for (int s = kWalkSlots - 1; s >= 0; --s)
          if (!((keep >> s) & 1u)) free_s = s;
#pragma unroll
        for (int s = kWalkSlots - 1; s >= 0; --s)
          if (!(((keep | busy) >> s) & 1u)) free_s = s;
        keep |= 1u << free_s;
        issue(free_s, wj[k], wt[k]);
      }
    }
  };
  // make the window of step t of band j current: a slot that holds it,
  // else a copy of its own (a miss); returns the byte offset of the slot
  auto use = [&](int j, int t, int y_now) {
    int s = -1, t0 = 0;
#pragma unroll
    for (int k = kWalkSlots - 1; k >= 0; --k) {
      if (tj[k] == j && tt[k] <= t && t < tt[k] + tn[k]) {
        s = k;
        t0 = tt[k];
      }
    }
    if (s < 0) {
      s = cur == 0 ? 1 : 0;
#pragma unroll
      for (int k = kWalkSlots - 1; k >= 0; --k)
        if (k != cur && tj[k] < 0) s = k;
      t0 = max(0, t - (kWalkSteps - 1));
      issue(s, j, t0);
    }
    if ((busy >> s) & 1u) wait(s);
    cur = s;
    cj = j;
    ct0 = t0;
    crs = row_bytes(band_lanes(n + 1, j));
    top_asked = false;
    plan(false, y_now);
  };

  // run by every lane alike; lane 0 writes the ops. The cell's band j,
  // its row xr in the band and r in its strip, its step t and its byte's
  // offset in shared memory follow each step without a division or a
  // branch: up lowers xr and r (and t where it leaves a strip), left
  // lowers t; leaving a band's top row enters the band above (a full one)
  // at step y + 30.
  int xl = x - row0 + 1;
  int j = (xl - 1) / kBandRows;
  int xr = xl - 1 - j * kBandRows;
  int r = xr % kStripRows;
  int t = y + xr / kStripRows - 1;
  int off = 0;
  if (xl >= 1 && y > 0) {
    use(j, t, y);
    off = cur * kSlotBytes + (t - ct0) * crs + xr;
  }
  while (xl >= 1 && y > 0) {
    const int byte = s_win[off];
    if (lane == 0) ops[x + y] = static_cast<uint8_t>(z);
    const int up = z != 2, left = z != 1;
    const int wrap = up & (r == 0);    // up out of the strip
    x -= up;
    xl -= up;
    y -= left;
    xr -= up;
    r = wrap ? kStripRows - 1 : r - up;
    t -= left + wrap;
    off -= up + (left + wrap) * crs;
    z = (byte >> (2 * z)) & 3;
    // one branch to the rare cases: out of the window, into the band
    // above, into a band's top strip
    if (t < ct0 || xr < kStripRows) {
      if (xl < 1 || y <= 0) break;
      if (xr < 0) {                    // the band above, a full one
        --j;
        xr = kBandRows - 1;
        r = kStripRows - 1;
        t = y + (kBandRows - 1) / kStripRows - 1;
        use(j, t, y);
        off = cur * kSlotBytes + (t - ct0) * crs + xr;
      } else if (t < ct0) {
        use(j, t, y);
        off = cur * kSlotBytes + (t - ct0) * crs + xr;
      }
      if (!top_asked && j > 0 && xr < kStripRows) {
        top_asked = true;
        plan(true, y);
      }
    }
  }
  // no copy may land after the CTA has left
#pragma unroll
  for (int s = 0; s < kWalkSlots; ++s)
    if ((busy >> s) & 1u) wait(s);
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

// Registers a thread of the fill kernel uses (ptxas's count), from which
// the host's plan takes the warps a CTA may have; -1 on a CUDA error.
extern "C" int clique_dp_segment_fill_regs() {
  using namespace clique_dp;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, split_fill_kernel) != cudaSuccess)
    return -1;
  return attr.numRegs;
}

// Dynamic shared memory of one fill CTA of W warps for a tile of w
// columns and rings of R entries.
extern "C" int clique_dp_segment_smem_bytes(int w, int W, int R) {
  using namespace clique_dp;
  return split_smem_bytes(w, W, R);
}

// Fill columns [y0, y1) of rows [row0, row0 + n) of B alignments on
// `stream`, a cluster of C CTAs of W warps an alignment with rings of R
// entries (align/dp_kernels.py::segment_plan): refs [B, ref_stride] u8
// (the part's rows' reference bytes), reads [B, read_stride] u8, lens [B]
// i32 (the whole alignments'), params [6] f32; halo_in [B, y1 - y0 + 1, 3]
// f32 (row row0 - 1 at columns y0 - 1 .. y1 - 1; null for row0 == 1);
// halo_out of the same shape (row row0 + n - 1; null: not written); carry
// [B, n, 3] f32 in/out; tb [B, clique_dp_align_tb_bytes(n + 1, n2)] u8;
// corner [B, 3] f32. A plan the kernel cannot run (too many warps for its
// registers, a ring that could deadlock or does not fit, a cluster the
// card cannot hold) is refused. Returns the CUDA error of the launch (0 on
// success).
extern "C" int clique_dp_segment_fill(
    const void* refs, int ref_stride, const void* reads, int read_stride,
    const void* ref_lens, const void* read_lens, const void* params,
    const void* halo_in, void* halo_out, void* carry, void* tb, void* corner,
    int B, int n1, int n2, int row0, int n, int y0, int y1, int C, int W,
    int R, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2 || n < 1 || row0 < 1 || row0 + n > n1 ||
      y0 < 1 || y1 <= y0 || y1 > n2 || (halo_in == nullptr) != (row0 == 1))
    return cudaErrorInvalidValue;
  // the plan: C <= 8 CTAs of W warps that the registers let an SM hold,
  // rings of a power of two >= 2 chunks, a whole tile row where warps take
  // bands in turn
  const int regs = clique_dp_segment_fill_regs();
  if (regs <= 0) return cudaErrorInvalidDeviceFunction;
  const int bands = (n + kBandRows - 1) / kBandRows;
  const int smem = split_smem_bytes(y1 - y0, W, R);
  if (C < 1 || C > kMaxCluster || W < 1 || W > kMaxWarps ||
      W * 32 * ((regs + 7) / 8 * 8) > 65536 || R < 2 * kRingChunk ||
      (R & (R - 1)) != 0 || (bands > C * W && R < y1 - y0 + 1) ||
      smem > kSmemLimit)
    return cudaErrorInvalidConfiguration;
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
  a.C = C;
  a.W = W;
  a.R = R;
  cudaError_t err = cudaFuncSetAttribute(
      split_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, split_fill_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, split_fill_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Walk rows [row0, row0 + n) of B alignments on `stream`, one warp an
// alignment, over the part's tb and corner (as clique_dp_segment_fill left
// them): state [B, 4] i32 (x, y, plane, score bits; -1: not started) and
// ops [B, n1 + n2 - 1] u8 (the op of the step from (x, y) at x + y) in
// place. tb must be 16-byte aligned (the windows are bulk copies).
// Returns the CUDA error of the launch (0 on success).
extern "C" int clique_dp_segment_walk(const void* tb, const void* corner,
                                      const void* ref_lens,
                                      const void* read_lens,
                                      const void* params, void* state,
                                      void* ops, int B, int n1, int n2,
                                      int row0, int n, void* stream) {
  using namespace clique_dp;
  if (B <= 0 || n1 < 2 || n2 < 2 || n < 1 || row0 < 1 || row0 + n > n1 ||
      reinterpret_cast<uintptr_t>(tb) % 16 != 0)
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
  const int smem = walk_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      split_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  split_walk_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
