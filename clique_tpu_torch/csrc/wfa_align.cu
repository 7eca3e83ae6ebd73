// Wavefront alignment (WFA) of a batch of (reference, read) pairs, for
// Hopper (sm_90a): the gap-affine and dual-affine ("convex") wavefront
// fills, with an op store and the backtrace walk fused after the fill
// (wfa_align), score only (wfa_score, which also takes the gap-linear
// penalties and with them edit distance), or gap-affine with the bialign
// engine's split payload (wfa_mid).
//
// Replaces: clique_tpu/align/wavefront.py::wfa_affine_tb_batch (:726),
// wfa_affine2p_tb_batch (:878) and wfa_walk_device (:1156) -> wfa_align;
// wfa_affine_batch (:319), wfa_affine2p_batch (:615), wfa_linear_batch
// (:232) and wfa_edit_batch (:166) -> wfa_score; wfa_affine_mid_batch
// (:442) -> wfa_mid. Each JAX function is a
// lax.while_loop that advances the whole batch one score step an
// iteration as [B, K] vector ops, until every lane is done. The plain
// versions are align/wfa_kernels.py::wfa_fill_reference,
// wfa_linear_reference, wfa_walk_reference, wfa_runs_reference (the
// replay) and wfa_mid_reference.
//
// G, the gap classes of a model: 1 gap-affine (M, I, D planes), 2
// dual-affine (M, I1, D1, I2, D2), 0 gap-linear (the M plane alone: the
// mismatch reads M at s - x on k, an indel M at s - e on k -/+ 1, no gap
// open; edit distance is x = e = 1 without wildcards). G = 0 is score
// only. The cell code keeps one "class" slot for G = 0 (nc(G) = 1) whose
// open lookback o + e is the indel's s - e (the host passes o = 0) and
// whose I and D planes do not exist.
//
// What bounds it on an H100: integer work. A score step updates the live
// diagonals of a pair (K = 2 * kmax + 1 in all, kmax the exact band
// (smax - o) / e of wfa_kernels.exact_kband): a handful of ring loads, a
// few dozen integer max / compare / select instructions, one op byte
// stored. A pair takes as many steps as its penalty, and the bytes it
// must move (two sequences in, a penalty, its op-store rows and skeleton
// out) are small against that, so it is bound by integer operations
// (chip_smoke.py counts a cell's instructions in this file's SASS through
// clique_wfa_cell_probe_*). Greedy extension compares bytes. In practice
// a launch of few pairs waits on each step's chain of dependent loads and
// its barrier (a step holds a few diagonals a thread), and wfa_mid's
// launch of ~1,000 pairs on the SMs' issue of its instructions.
//
// What the design does about it (layout from wfa_kernels.wfa_plan, which
// the launch checks):
// - Live diagonals only. Step s visits |k| <= min(s, kmax, reach(s)) and
//   -l2 - 1 <= k <= l1 + 1, reach(s) the widest |k| a penalty of s pays
//   for (one gap of (s - o_g) / e_g bases, the wider class). Every other
//   diagonal is NEG in every ring and 0 in the op store at that step (a
//   finite value on diagonal k costs at least min_g(o_g + e_g |k|); the op
//   bits of k = l1 + 1 and -l2 - 1 record gap extends from the rectangle's
//   edge). Ring cells are cleared once and never written outside the band,
//   which only grows; one memset zeroes the op store before the launch.
// - Compact rings: each plane keeps its own lookback. M (and wfa_mid's
//   payload PM) keeps max(x, o_g + e_g) + steps rows, I_g and D_g (PI, PD)
//   e_g + steps, each indexed by s mod its own height. A lookback before
//   step 0 lands on a row no step has written yet: NEG (-1 for payloads),
//   as the plain version's.
// - Two score steps between barriers where every lookback is at least 2
//   (x and the extends; gap-affine at 4, 6, 2) and the trim is off: the
//   second step reads no row the first writes, so a thread computes both
//   steps of its diagonal back to back.
// - Greedy extension compares four bytes at a time: two aligned 32-bit
//   loads and a funnel shift give four bytes at any offset, a ^ b the
//   bytes that differ; the wildcard masks (__vcmpltu4 / __vcmpeq4: below
//   '0' + 10, or 'N') only where four bytes differ and the pair holds a
//   wildcard at all.
// - wfa_score where the band fits a warp (K <= kWarpMaxK, up to four
//   diagonals a lane): one warp a pair, W pairs a CTA (wfa_plan), each
//   warp its own slice of shared memory (its pair's rows and rings, no
//   control words). __syncwarp ends a barrier interval, the wildcard and
//   done tests are ballots, and the steps' ring bookkeeping is issued once
//   a pair; the cell code is run_pair's, the same as wfa_align's. Its
//   launch bounds let an SM hold kWarpCtas CTAs of kWarpPairs warps, so a
//   launch of 4,096 pairs fits the 132 SMs in one wave. It beat wfa_kernel
//   run as one-warp CTAs under the same 32 warps an SM at the screen's
//   launch (profile_wfa.py variant cta32), so it stays a kernel of its own.
// - wfa_align and wfa_score: one CTA a pair, its rings in shared memory;
//   a thread-block cluster of C CTAs a pair where the rings need it or a
//   small launch leaves SMs idle (wfa_plan: C = 1, 2, 4 or 8). Each CTA
//   of a cluster owns a contiguous slice of the diagonals, its rings
//   between two halo columns in its own shared memory; a cell at a slice
//   edge also stores its values into the neighbour's halo (distributed
//   shared memory), so every read is local, and each barrier interval ends
//   at a cluster barrier (release / acquire). The done step, wfa_mid's
//   payload at it and the trim's maximum go into every CTA's control
//   words, so that all leave the loop at the same step; rank 0 writes the
//   outputs and walks. Past what a cluster of 8 holds, the rings live in a
//   global workspace and a persistent grid takes pairs from a counter.
// - wfa_mid: a persistent grid of CTAs of up to 1,024 threads, one an SM,
//   each taking pairs from a counter; its M, I and D rings hold int16
//   offsets (NEG as -32768) in shared memory, its payload planes (PM, PI,
//   PD: the last on-path M cell at or before the anti-diagonal (l1 + l2) /
//   2, as h * 65536 + v) in the CTA's slice of the workspace, which L2
//   holds. Each payload follows the choice the cell's op byte records, so
//   payload and traceback cannot disagree (the candidates are loaded
//   before the byte is known); pay_update moves an M payload across the
//   step's greedy extension.
// - wfa_align writes each step's op bytes to the global op store
//   [smax+1, B, K] in the plain version's layout, then rank 0's thread 0
//   walks that pair's store backwards once, exactly as wfa_walk_device
//   does (one op a row, an M -> gap switch fused with the gap's first
//   step at the same row), into shared memory over the dead rings, and
//   every thread writes the skeleton row [smax+1] forwards (0-padded),
//   and the end row into fin: -1 a converged walk, -2 a censored pair.
// - Then warp 0 replays a converged skeleton forwards over the pair's
//   bytes in shared memory, as the host helper wfa_replay_cigar does, and
//   writes the CIGAR as run words (count << 2 | op) to runs [B, rmax]:
//   each greedy match run is found 128 bytes a step, four a lane, the
//   first stop by a warp minimum. The ops are few (one a skeleton op), so
//   the replay costs the launch little and spares the host a Python loop
//   over every op.
//
// Exactness: integers only. The recurrence, its clamp order (affine clamps
// I and D after taking M's maximum, affine2p before), its tie orders
// (mismatch > I > D, mismatch > I1 > D1 > I2 > D2; a gap extends only
// where extend > open), the NEG sentinel's order and the bounds are the
// JAX functions'. Rows of the op store past a pair's penalty are not
// defined.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace clique_wfa {
namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kMaxThreads = 512;
// wfa_mid's CTAs: one an SM holds its int16 rings, and its 64 registers a
// thread allow 1,024 threads, whose warps hide its payloads' L2 loads
constexpr int kMidThreads = 1024;
constexpr int kSmemLimit = 232448;  // an H100 block's shared memory
constexpr int kMaxCluster = 8;      // the portable cluster size
// wfa_score's warp path: the widest band it takes (four diagonals a lane),
// pairs (warps) a CTA at most, and the CTAs an SM holds at its launch
// bounds (32 warps: 4,096 pairs on 132 SMs in one wave)
constexpr int kWarpMaxK = 128;
constexpr int kWarpPairs = 4;
constexpr int kWarpCtas = 8;
constexpr unsigned kFull = 0xffffffffu;
// control words: [0] [1] the done step, [2] [3] the trim's maximum, each
// by the parity of the barrier interval (a thread that reads interval i's
// word after its barrier cannot see interval i + 1's write), [4] wfa_mid's
// payload at the done step, [5] the walk's ops, [6] the pair (persistent
// grid), [7] the walk's end row
constexpr int kCtrlInts = 8;
constexpr int kCounterInts = 4;     // the workspace's pair counter
constexpr int kMidEnc = 1 << 16;    // wfa_mid's payload: h * kMidEnc + v

// Slots of a cell's per-class arrays: G, and one for gap-linear (G = 0).
__host__ __device__ constexpr int nc(int G) { return G > 0 ? G : 1; }

struct Params {
  int n1, n2;        // row widths: refs [B, n1], reads [B, n2]
  int B, smax, kmax, K;
  int x, o1, e1, o2, e2;
  int hm, he1, he2;  // ring rows: M (and PM), I and D of each class
  int wildcards;
  int adaptive;      // the wf-adaptive margin, < 0: off
  int C;             // CTAs a pair (a cluster when > 1)
  int cw;            // diagonals a CTA: CTA r holds r * cw .. r * cw + cw - 1
  int grid;          // > 0: a persistent grid of at most grid CTAs
  int ring_global;   // the M, I, D rings in the global workspace
  long long ws_ints; // ints of one CTA's global workspace
  // > 0: wfa_score's warp path, wp pairs (warps) a CTA; last, so that the
  // CTA path's kernels read every other field where they did without it
  int wp;
  int rmax;          // words of a pair's row of runs (wfa_align)
};

struct Bufs {
  const uint8_t* refs;
  const uint8_t* reads;
  const int* ref_lens;
  const int* read_lens;
  int* ring_ws;
  int* pen;
  uint8_t* ops;
  uint8_t* ops_fwd;
  int* fin;
  int* pay;
  int* runs;
};

// Bytes a sequence row takes in shared memory: whole words and one spare
// word, so that a four-byte read at any offset below n stays inside.
__host__ __device__ inline int seq_bytes(int n) { return ((n + 3) / 4 + 1) * 4; }

// Values of one CTA's M, I, D rings: every plane's rows of its cw
// diagonals between two halo columns (wfa_mid's payload planes, as many
// rows of ints, live in the global workspace).
__host__ __device__ inline long long cta_ring_values(const Params& p, int G) {
  return (long long)(p.hm + (G >= 1 ? 2 * p.he1 : 0) +
                     (G == 2 ? 2 * p.he2 : 0)) *
         (p.cw + 2);
}

// Ints of one CTA's global workspace: wfa_mid's payload planes, then the
// rings where they are global.
__host__ inline long long cta_ws_ints(const Params& p, int G, bool mid) {
  return (mid ? cta_ring_values(p, G) : 0) +
         (p.ring_global ? cta_ring_values(p, G) : 0);
}

// Shared memory of one CTA: the sequences, the control words, then its
// rings of `value` bytes (unless they are global) or, after the fill, the
// walk's ops.
__host__ inline long long cta_smem(const Params& p, int G, bool tb,
                                   bool mid, int value) {
  const long long walk = tb ? (p.smax + 4) / 4 * 4 : 0;
  const long long rings =
      p.ring_global ? 0 : (value * cta_ring_values(p, G) + 3) / 4 * 4;
  return seq_bytes(p.n1) + seq_bytes(p.n2) + 4LL * kCtrlInts +
         std::max(rings, walk);
}

// Shared memory of one warp's pair on wfa_score's warp path: the
// sequences and its rings, no control words (16-byte multiple).
__host__ __device__ inline long long warp_slice(const Params& p, int G) {
  return (seq_bytes(p.n1) + seq_bytes(p.n2) + 4 * cta_ring_values(p, G) +
          15) / 16 * 16;
}

__device__ __forceinline__ uint32_t load4(const uint8_t* base, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base);
  const int q = i >> 2;
  return __funnelshift_r(w[q], w[q + 1], 8 * (i & 3));
}

__device__ __forceinline__ uint32_t wild4(uint32_t w) {
  return __vcmpltu4(w, 0x3a3a3a3au) | __vcmpeq4(w, 0x4e4e4e4eu);
}

__device__ __forceinline__ bool wild1(int c) { return c < 58 || c == 78; }

// The bytes of four that differ (non-zero bytes of a ^ b) and are not a
// wildcard on either side.
__device__ __forceinline__ uint32_t differ4(uint32_t a, uint32_t b,
                                           bool wildcards) {
  uint32_t x = a ^ b;
  if (wildcards && x) x &= ~(wild4(a) | wild4(b));
  return x;
}

// The greedy match run from ref[h], read[v], at most n bytes (wildcards:
// the pair holds a wildcard byte and they are on).
__device__ int extend_run(const uint8_t* ref, const uint8_t* read, int h,
                          int v, int n, bool wildcards) {
  int run = 0;
  for (; run + 4 <= n; run += 4) {
    const uint32_t x =
        differ4(load4(ref, h + run), load4(read, v + run), wildcards);
    if (x) return run + (__ffs(x) - 1) / 8;
  }
  for (; run < n; ++run) {
    const int a = ref[h + run], b = read[v + run];
    if (!(a == b || (wildcards && (wild1(a) || wild1(b))))) break;
  }
  return run;
}

template <int kN = kNeg>
__device__ __forceinline__ int plus1(int w) { return w > kN ? w + 1 : kN; }

// The ring row `back` steps before row `cur` of a plane of h rows.
__device__ __forceinline__ int back_row(int cur, int back, int h) {
  const int r = cur - back;
  return r < 0 ? r + h : r;
}

// The ring values one diagonal of one score step reads: M at s1 - x (k),
// and for each gap class the opens (M at s1 - o_g - e_g, k -/+ 1) and the
// extends (D at k - 1, I at k + 1, s1 - e_g). Gap-linear (G = 0) reads the
// opens only, M at s1 - e.
template <int G>
struct CellIn {
  int mism;
  int d_open[nc(G)], d_ext[nc(G)], i_open[nc(G)], i_ext[nc(G)];
};

// The recurrence of one diagonal k at score s1 from its ring values: the
// new M (before extension), I and D of each gap class (clamped), and the
// op byte. kN: the NEG sentinel (any value below every offset and -kmax
// gives the same bytes; wfa_mid's int16 rings use -32768).
template <int G, int kN = kNeg>
__device__ __forceinline__ void combine(const CellIn<G>& in, int k, int s1,
                                        int l1, int l2, int* new_m,
                                        int* new_i, int* new_d, uint8_t* op) {
  const bool vld = (k <= s1 && -k <= s1) && k >= -l2 && k <= l1;
  int raw_i[nc(G)], raw_d[nc(G)];
  int byte = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    raw_d[g] = plus1<kN>(max(in.d_open[g], in.d_ext[g]));
    raw_i[g] = max(in.i_open[g], in.i_ext[g]);
    const int shift = (G == 1 ? 2 : 3) + 2 * g;
    byte |= (int(in.i_ext[g] > in.i_open[g]) << shift) |
            (int(in.d_ext[g] > in.d_open[g]) << (shift + 1));
  }
  const int mism = plus1<kN>(in.mism);
  auto clamp = [&](int offs) {
    const int v = offs - k;
    return (vld && offs <= l1 && v <= l2 && v >= 0) ? offs : kN;
  };
  int m, src;
  if constexpr (G == 0) {
    // gap-linear: M from the mismatch and the two indels (mismatch > I >
    // D, as the affine source order), no gap planes
    const int ins = in.i_open[0], del = plus1<kN>(in.d_open[0]);
    m = max(mism, max(del, ins));
    src = mism == m ? 1 : (ins == m ? 2 : 3);
  } else if constexpr (G == 1) {
    // affine: M from the raw gaps, then every plane clamped
    m = max(mism, max(raw_i[0], raw_d[0]));
    src = mism == m ? 1 : (raw_i[0] == m ? 2 : 3);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      new_i[g] = clamp(raw_i[g]);
      new_d[g] = clamp(raw_d[g]);
    }
  } else {
    // affine2p: the gaps clamped first, M from the clamped gaps
#pragma unroll
    for (int g = 0; g < G; ++g) {
      new_i[g] = clamp(raw_i[g]);
      new_d[g] = clamp(raw_d[g]);
    }
    m = max(mism, max(max(new_i[0], new_d[0]), max(new_i[G - 1], new_d[G - 1])));
    src = mism == m ? 1
        : new_i[0] == m ? 2
        : new_d[0] == m ? 3
        : new_i[G - 1] == m ? 4 : 5;
  }
  if (m <= kN) src = 0;
  *op = static_cast<uint8_t>(byte | src);
  *new_m = clamp(m);
}

// wfa_mid's payloads of one diagonal's new I, D and M (M before its
// extension), each following the choice its op byte records, as the
// traceback would: I from extend (PI at k + 1, s1 - e) where bit 2 says
// so, else from the M at s1 - o - e (PM, k + 1); D likewise at k - 1 (bit
// 3); M from the mismatch (PM at s1 - x, k), the I or the D (bits 0-1; -1
// where no source: the cell is NEG). c: those five candidates, PI(k + 1),
// PM(k + 1), PD(k - 1), PM(k - 1), PM(k).
__device__ __forceinline__ void mid_pays(uint8_t op, const int (&c)[5],
                                         int* pm, int* pi, int* pd) {
  *pi = (op >> 2) & 1 ? c[0] : c[1];
  *pd = (op >> 3) & 1 ? c[2] : c[3];
  const int src = op & 3;
  *pm = src == 1 ? c[4] : src == 2 ? *pi : src == 3 ? *pd : -1;
}

// pay_update of wfa_affine_mid_batch: across an M step and its greedy
// extension h_base .. h_ext on diagonal k, the payload becomes the last
// cell of that run at or before the mid anti-diagonal, if one is (>> is
// an arithmetic shift: a floor, as jnp's).
template <int kN = kNeg>
__device__ __forceinline__ int pay_update(int h_base, int h_ext, int pay,
                                          int k, int mid) {
  if (h_base <= kN) return pay;
  const int cand = min(max((mid + k) >> 1, h_base), h_ext);
  return 2 * cand - k <= mid ? cand * kMidEnc + (cand - k) : pay;
}

// The walk of wfa_walk_device from (row score, diagonal k_target): returns
// the end row (fin); its ops go to rev[0 .. *n_ops) last op first.
template <int G>
__device__ int walk(const uint8_t* ops, const Params& p, int b, int score,
                    int k_target, uint8_t* rev, int* n_ops) {
  int s = score;
  int k = min(max(k_target, -p.kmax), p.kmax);
  int st = 0, j = 0;
  const int mmask = G == 1 ? 3 : 7;
  while (s >= 0) {
    const int row = s;
    const int kk = k + p.kmax;
    const int byte =
        (kk >= 0 && kk < p.K) ? ops[((size_t)row * p.B + b) * p.K + kk] : 0;
    if (st == 0) {
      if (row == 0) {
        s = -1;
        break;
      }
      const int src = byte & mmask;
      if (src == 1) {
        rev[j++] = 'X';
        s -= p.x;
        if (s >= row) break;     // no later row is this one: the lane stays
        continue;
      }
      if (src == 0) break;       // nothing to do at this row: the lane stays
      st = src - 1;
    }
    if (st > 2 * G) break;       // no gap state of this model
    const bool ins = (st & 1) != 0;
    const int g = (st - 1) >> 1;
    const int shift = (G == 1 ? 2 : 3) + (st - 1);
    const int e = g == 0 ? p.e1 : p.e2;
    const int oe = (g == 0 ? p.o1 : p.o2) + e;
    const int ext = (byte >> shift) & 1;
    rev[j++] = ext ? (ins ? 'i' : 'd') : (ins ? 'I' : 'D');
    s -= ext ? e : oe;
    k += ins ? 1 : -1;
    if (!ext) st = 0;
    if (s >= row) break;
  }
  *n_ops = j;
  return s;
}

// The greedy match run from ref[h], read[v], at most n bytes, found by a
// whole warp: each step's 32 lanes test four bytes each, 128 in all, and
// the warp's least stop (n where a lane's bytes all match) ends it. Every
// lane calls it with the same arguments and gets the same length; 0 where
// n <= 0.
__device__ int warp_run(const uint8_t* ref, const uint8_t* read, int h,
                        int v, int n, bool wildcards) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 128) {
    const int i = base + 4 * lane;
    int stop = n;
    if (i < n) {
      const uint32_t x =
          differ4(load4(ref, h + i), load4(read, v + i), wildcards);
      if (x) stop = min(n, i + (__ffs(x) - 1) / 8);
    }
    stop = __reduce_min_sync(kFull, stop);
    if (stop < n) return stop;
  }
  return max(n, 0);
}

// The CIGAR of a converged walk, as the host helper wfa_replay_cigar
// rebuilds it from the skeleton rev[n - 1] .. rev[0] (first op first): the
// greedy match run before each X, I and D (an i or d extends an open gap,
// with no matches before it), one more after the last op; X adds an M, I
// and i an I, D and d a D; a run of the op before grows, an empty one is
// not emitted. Run by one whole warp, each lane with the same arguments;
// lane 0 writes the run words (count << 2 | op: M 0, I 1, D 2) to out,
// then a 0. A replay that does not end at (l1, l2) writes h << 2 | 3,
// v << 2 | 3 and a 0 instead. rmax bounds the words (2n + 3 hold them).
__device__ void replay(const uint8_t* ref, const uint8_t* read, int l1,
                       int l2, const uint8_t* rev, int n, bool wildcards,
                       int* out, int rmax) {
  const bool lead = (threadIdx.x & 31) == 0;
  int h = 0, v = 0, nr = 0, op = -1, count = 0;
  auto put = [&](int w) {
    if (lead && nr < rmax) out[nr] = w;
    ++nr;
  };
  auto emit = [&](int o, int c) {
    if (c <= 0) return;
    if (o == op) {
      count += c;
      return;
    }
    if (op >= 0) put(count << 2 | op);
    op = o;
    count = c;
  };
  auto match = [&] {
    const int r = warp_run(ref, read, h, v, min(l1 - h, l2 - v), wildcards);
    h += r;
    v += r;
    emit(0, r);
  };
  for (int j = n - 1; j >= 0; --j) {
    const int c = rev[j];
    if (c == 'X' || c == 'I' || c == 'D') match();
    if (c == 'X') {
      emit(0, 1);
      ++h;
      ++v;
    } else if (c == 'I' || c == 'i') {
      emit(1, 1);
      ++v;
    } else {
      emit(2, 1);
      ++h;
    }
  }
  match();
  if (op >= 0) put(count << 2 | op);
  if (h != l1 || v != l2) {
    nr = 0;
    put(h << 2 | 3);
    put(v << 2 | 3);
  }
  if (lead) out[min(nr, rmax - 1)] = 0;
}

// A pair's ring planes in a CTA: M, I and D of each class (RT: int, or
// int16_t with -32768 its NEG), wfa_mid's payload planes PM, PI, PD
// (int); rw values a row: the CTA's cw diagonals between two halo
// columns.
template <int G, class RT>
struct Rings {
  RT* M;
  RT* I[nc(G)];
  RT* D[nc(G)];
  int *PM, *PI, *PD;
  int rw;
};

template <class RT>
__device__ __forceinline__ void st(RT* p, int v) { *p = static_cast<RT>(v); }

// The NEG sentinel of a ring value type.
template <class RT>
__host__ __device__ constexpr int neg_of() { return sizeof(RT) == 2 ? -32768 : kNeg; }

__device__ __forceinline__ void sync_pair(const Params& p) {
  if (p.C > 1)
    cg::this_cluster().sync();   // barrier.cluster arrive (release), wait (acquire)
  else
    __syncthreads();
}

// This CTA's copy of a shared word in the pair's CTA `rank`.
template <class T>
__device__ __forceinline__ T* at_rank(T* local, int rank, const Params& p) {
  return p.C > 1 ? cg::this_cluster().map_shared_rank(local, rank) : local;
}

// A cell's planes at column q = li + 1 of rows cm (M, PM) and ce[] (I, D,
// PI, PD); at the edge of the CTA's slice also into the neighbouring
// CTA's halo: M and I for the CTA before (it reads them as k + 1), M and
// D for the CTA after (k - 1). Clusters carry no payload planes.
template <int G, bool kMid, class RT>
__device__ __forceinline__ void put(const Rings<G, RT>& R, const Params& p,
                                    int li, int rank, int cm,
                                    const int (&ce)[2], int m,
                                    const int (&ni)[nc(G)],
                                    const int (&nd)[nc(G)],
                                    int pm, int pi, int pd) {
  const int rw = R.rw, q = li + 1;
  st(&R.M[cm * rw + q], m);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    st(&R.I[h][ce[h] * rw + q], ni[h]);
    st(&R.D[h][ce[h] * rw + q], nd[h]);
  }
  if (kMid) {
    R.PM[cm * rw + q] = pm;
    R.PI[ce[0] * rw + q] = pi;
    R.PD[ce[0] * rw + q] = pd;
  }
  if (p.C == 1) return;
  if (li == 0 && rank > 0) {
    st(&at_rank(R.M, rank - 1, p)[cm * rw + p.cw + 1], m);
#pragma unroll
    for (int h = 0; h < G; ++h)
      st(&at_rank(R.I[h], rank - 1, p)[ce[h] * rw + p.cw + 1], ni[h]);
  }
  if (li == p.cw - 1 && rank + 1 < p.C) {
    st(&at_rank(R.M, rank + 1, p)[cm * rw], m);
#pragma unroll
    for (int h = 0; h < G; ++h)
      st(&at_rank(R.D[h], rank + 1, p)[ce[h] * rw], nd[h]);
  }
}

// The step at which some lane of the warp saw the pair done (mine: this
// lane's, -1 if none), the same in every lane; -1 if none did.
__device__ __forceinline__ int warp_done(int mine) {
  const unsigned hit = __ballot_sync(kFull, mine >= 0);
  return hit ? __shfl_sync(kFull, mine, __ffs(hit) - 1) : -1;
}

// One pair: its CTA (or one of the C CTAs of its cluster, `rank`) holds
// diagonal indices rank * cw .. rank * cw + cw - 1 in local slots li. ring:
// the M, I, D planes (shared memory, or the CTA's global workspace); pays:
// wfa_mid's payload planes (the CTA's global workspace). kSteps score steps
// run between two barriers: every lookback is at least kSteps (the host
// passes 2 where x and the extends allow it and the trim is off), so a
// step never reads a row written in its own interval, and each plane keeps
// its longest lookback + kSteps rows. kWarp (wfa_score's warp path): the
// pair is one warp's, smem its slice (sequences, then the rings), its
// barriers __syncwarp and its done step and wildcard test ballots, so no
// control words are kept.
template <int G, bool kTb, bool kMid, int kSteps, class RT,
          bool kWarp = false>
__device__ void run_pair(const Bufs& g, const Params& p, int b,
                         uint8_t* smem, RT* ring, int* pays, int rank) {
  static_assert(!kWarp || (!kTb && !kMid), "the warp path is wfa_score's");
  const int tid = kWarp ? threadIdx.x & 31 : threadIdx.x;
  const int nt = kWarp ? 32 : blockDim.x;
  // a barrier interval's end: the rings written in it are seen by all
  auto sync = [&] {
    if constexpr (kWarp)
      __syncwarp();
    else
      sync_pair(p);
  };
  const int K = p.K, kmax = p.kmax;
  const int S1 = p.smax + 1;
  const int l1 = g.ref_lens[b], l2 = g.read_lens[b];
  if (l1 < 0 || l1 > p.n1 || l2 < 0 || l2 > p.n2) {
    // lengths outside the rows: marked, not aligned (every CTA of the
    // pair leaves here)
    if (rank == 0) {
      if (tid == 0) {
        g.pen[b] = -1;
        if (kTb) g.fin[b] = -3;
        if (kMid) g.pay[b] = -1;
      }
      if (kTb) {
        for (int i = tid; i < S1; i += nt) g.ops_fwd[(size_t)b * S1 + i] = 0;
        if (tid == 0) g.runs[(size_t)b * p.rmax] = 0;
      }
    }
    return;
  }
  const int sa = seq_bytes(p.n1), sb = seq_bytes(p.n2);
  uint8_t* sref = smem;
  uint8_t* sread = smem + sa;
  int* ctrl = kWarp ? nullptr : reinterpret_cast<int*>(smem + sa + sb);
  bool any_wild = false;
  for (int i = tid; i < sa; i += nt) {
    const int c = i < l1 ? g.refs[(size_t)b * p.n1 + i] : 0;
    sref[i] = c;
    any_wild |= i < l1 && wild1(c);
  }
  for (int i = tid; i < sb; i += nt) {
    const int c = i < l2 ? g.reads[(size_t)b * p.n2 + i] : 0;
    sread[i] = c;
    any_wild |= i < l2 && wild1(c);
  }
  // wildcards only cost where the pair holds one
  bool wild;
  if constexpr (kWarp) {
    __syncwarp();
    wild = p.wildcards != 0 && __any_sync(kFull, any_wild);
  } else {
    wild = p.wildcards != 0 && __syncthreads_or(any_wild);
  }
  const int rw = p.cw + 2;                 // values of a ring row
  const int k0 = rank * p.cw;              // the slice's first diagonal index
  const int he[2] = {p.he1, p.he2};
  Rings<G, RT> R;
  R.rw = rw;
  R.M = ring;
  int rn = p.hm * rw;
#pragma unroll
  for (int c = 0; c < G; ++c) {
    R.I[c] = ring + rn;
    R.D[c] = ring + rn + he[c] * rw;
    rn += 2 * he[c] * rw;
  }
  // wfa_mid's payload planes: PM (hm rows), PI, PD (he1)
  R.PM = pays;
  R.PI = pays + p.hm * rw;
  R.PD = R.PI + p.he1 * rw;
  constexpr int kN = neg_of<RT>();
  for (int i = tid; i < rn; i += nt) st(&ring[i], kN);
  if (kMid)
    for (int i = tid; i < rn; i += nt) pays[i] = -1;
  if (!kWarp && tid == 0) {
    ctrl[0] = ctrl[1] = ctrl[4] = -1;
    ctrl[2] = ctrl[3] = kNeg;
  }
  const int k_target = l1 - l2;
  const bool target_ok = k_target <= kmax && -k_target <= kmax;
  const int tli = min(max(k_target, -kmax), kmax) + kmax - k0;
  const int mid = (l1 + l2) / 2;
  // the done step (and wfa_mid's payload at it) into every CTA's control
  // words (slot sl, the parity of the barrier interval), read by all after
  // the interval's barrier; on the warp path into the lane's own mine
  int mine = -1;
  auto set_done = [&](int sl, int s, int pay) {
    if constexpr (kWarp) {
      if (mine < 0) mine = s;
    } else {
      for (int r = 0; r < p.C; ++r) {
        int* c = at_rank(ctrl, r, p);
        c[sl] = s;
        if (kMid) c[4] = pay;
      }
    }
  };
  // the done step after an interval's barrier, -1 while the pair runs
  auto done_at = [&](int sl) {
    if constexpr (kWarp)
      return warp_done(mine);
    else
      return ctrl[sl];
  };
  int negs[nc(G)];
#pragma unroll
  for (int h = 0; h < nc(G); ++h) negs[h] = kN;
  int ce[2] = {0, 0};

  sync();   // every CTA's rings are clear before a halo is written
  if (tid == 0 && kmax >= k0 && kmax < k0 + p.cw) {
    // s = 0: diagonal 0 from offset 0, extended, in the CTA that holds it
    const int m0 = extend_run(sref, sread, 0, 0, min(l1, l2), wild);
    const int p0 = kMid ? pay_update<kN>(0, m0, -1, 0, mid) : -1;
    put<G, kMid>(R, p, kmax - k0, rank, 0, ce, m0, negs, negs, p0, -1, -1);
    if (target_ok && tli == kmax - k0 && m0 >= l1) set_done(0, 0, p0);
  }
  sync();
  int result = done_at(0);
  const int o_e[2] = {p.o1 + p.e1, p.o2 + p.e2};
  const int e_[2] = {p.e1, p.e2};
  const int o_[2] = {p.o1, p.o2};
  int cm = 0;
  int rq[2] = {0, 0}, rr[2] = {0, 0};   // (s - o_g) / e_g and its remainder
  for (int s0 = 1, it = 1; result < 0 && s0 <= p.smax; s0 += kSteps, ++it) {
    // each step's ring rows (written, and its lookbacks) and live slots
    int wm[kSteps], we[kSteps][nc(G)], rx[kSteps], roe[kSteps][nc(G)],
        re[kSteps][nc(G)];
    int lo[kSteps], hi[kSteps];
#pragma unroll
    for (int dt = 0; dt < kSteps; ++dt) {
      const int s1 = s0 + dt;
      cm = cm + 1 == p.hm ? 0 : cm + 1;
      wm[dt] = cm;
      rx[dt] = back_row(cm, p.x, p.hm);
      int reach = 0;
#pragma unroll
      for (int h = 0; h < nc(G); ++h) {
        if constexpr (G > 0) ce[h] = ce[h] + 1 == he[h] ? 0 : ce[h] + 1;
        we[dt][h] = ce[h];
        roe[dt][h] = back_row(cm, o_e[h], p.hm);
        // no gap planes for G = 0
        re[dt][h] = G > 0 ? back_row(ce[h], e_[h], he[h]) : 0;
        if (s1 > o_[h] && ++rr[h] == e_[h]) {
          rr[h] = 0;
          ++rq[h];
        }
        reach = max(reach, rq[h]);
      }
      // the live band: the diagonals a penalty of s1 reaches
      const int kr = min(min(s1, kmax), reach);
      lo[dt] = min(max(kmax - min(kr, l2 + 1) - k0, 0), p.cw);
      hi[dt] = min(max(kmax + min(kr, l1 + 1) + 1 - k0, 0), p.cw);
      if (s1 > p.smax) hi[dt] = lo[dt];
    }
    const int sl = it & 1;
    int best = kNeg;
    // the band only grows: the interval's last step holds every live slot
    for (int li = lo[kSteps - 1] + tid; li < hi[kSteps - 1]; li += nt) {
      const int q = li + 1, k = li + k0 - kmax;
      bool done_here = false;
#pragma unroll
      for (int dt = 0; dt < kSteps; ++dt) {
        if (li < lo[dt] || li >= hi[dt]) continue;
        const int s1 = s0 + dt;
        CellIn<G> in;
        in.mism = R.M[rx[dt] * rw + q];
#pragma unroll
        for (int h = 0; h < nc(G); ++h) {
          in.d_open[h] = R.M[roe[dt][h] * rw + q - 1];
          if constexpr (G > 0) in.d_ext[h] = R.D[h][re[dt][h] * rw + q - 1];
          in.i_open[h] = R.M[roe[dt][h] * rw + q + 1];
          if constexpr (G > 0) in.i_ext[h] = R.I[h][re[dt][h] * rw + q + 1];
        }
        int cand[5];
        if (kMid) {
          // every payload the op byte may pick, loaded before it is known
          cand[0] = R.PI[re[dt][0] * rw + q + 1];
          cand[1] = R.PM[roe[dt][0] * rw + q + 1];
          cand[2] = R.PD[re[dt][0] * rw + q - 1];
          cand[3] = R.PM[roe[dt][0] * rw + q - 1];
          cand[4] = R.PM[rx[dt] * rw + q];
        }
        int m, ni[nc(G)], nd[nc(G)];
        uint8_t op;
        combine<G, kN>(in, k, s1, l1, l2, &m, ni, nd, &op);
        int pm = -1, pi = -1, pd = -1;
        if (kMid) mid_pays(op, cand, &pm, &pi, &pd);
        const int h_base = m;
        if (m >= 0) {
          const int v = m - k;
          const int n = min(l1 - m, l2 - v);
          if (n > 0) m += extend_run(sref, sread, m, v, n, wild);
        }
        if (kMid) pm = pay_update<kN>(h_base, m, pm, k, mid);
        int wce[2] = {we[dt][0], we[dt][nc(G) - 1]};
        put<G, kMid>(R, p, li, rank, wm[dt], wce, m, ni, nd, pm, pi, pd);
        if (kTb) g.ops[((size_t)s1 * p.B + b) * K + li + k0] = op;
        if (!kWarp && p.adaptive >= 0) {
          if (m > kN) best = max(best, 2 * m - k);
        } else if (li == tli && target_ok && m >= l1 && !done_here) {
          done_here = true;
          set_done(sl, s1, pm);
        }
      }
    }
    if (!kWarp && p.adaptive >= 0) {
      // wf-adaptive trim (kSteps is 1): drop diagonals whose antidiagonal
      // progress 2h - k lags the pair's best by more than the margin
      const int s1 = s0;
      const int ms = 2 + sl;
      best = __reduce_max_sync(0xffffffffu, best);
      if ((tid & 31) == 0) atomicMax(&ctrl[ms], best);
      if (p.C > 1) {
        __syncthreads();
        if (tid == 0) {
          // an atomic read: other CTAs' maxima may arrive meanwhile
          const int mine = atomicMax(&ctrl[ms], kNeg);
          for (int r = 0; r < p.C; ++r)
            if (r != rank) atomicMax(at_rank(ctrl, r, p) + ms, mine);
        }
      }
      sync_pair(p);
      const int lim = ctrl[ms] - p.adaptive;
      int wce[2] = {we[0][0], we[0][nc(G) - 1]};
      for (int li = lo[0] + tid; li < hi[0]; li += nt) {
        const int k = li + k0 - kmax;
        const int m = R.M[wm[0] * rw + li + 1];
        if (m > kN && 2 * m - k < lim) {
          put<G, kMid>(R, p, li, rank, wm[0], wce, kN, negs, negs, -1, -1,
                       -1);
        } else if (li == tli && target_ok && m >= l1) {
          set_done(sl, s1, -1);
        }
      }
      if (tid == 0) ctrl[2 + (sl ^ 1)] = kNeg;
    }
    sync();
    result = done_at(sl);
  }
  const int score = result < 0 ? p.smax + 1 : result;
  if (rank != 0) return;   // no CTA reads another's shared memory any more
  if (tid == 0) {
    g.pen[b] = score;
    if (kMid) g.pay[b] = result < 0 ? -1 : ctrl[4];
  }
  if (!kTb) return;

  // the walk, once: thread 0 walks backwards into shared memory past the
  // control words (over the rings, dead now), every thread writes the
  // skeleton row forwards and clears the rest of it; warp 0 replays a
  // converged walk's skeleton into the pair's row of runs
  uint8_t* rev = reinterpret_cast<uint8_t*>(ctrl + kCtrlInts);
  if (tid == 0) {
    int n = 0;
    int s_end = -2;
    if (score < S1) s_end = walk<G>(g.ops, p, b, score, k_target, rev, &n);
    ctrl[5] = n;
    ctrl[7] = s_end;
    g.fin[b] = s_end;
  }
  __syncthreads();
  const int n = ctrl[5];
  uint8_t* out = g.ops_fwd + (size_t)b * S1;
  for (int i = tid; i < S1; i += nt) out[i] = i < n ? rev[n - 1 - i] : 0;
  if (tid < 32) {
    int* row = g.runs + (size_t)b * p.rmax;
    if (ctrl[7] == -1)
      replay(sref, sread, l1, l2, rev, n, wild, row, p.rmax);
    else if (tid == 0)
      row[0] = 0;
  }
}

// kTb: with the op store and the walk (wfa_align). kMid (G = 1, no kTb):
// the midpoint fill (wfa_mid), payload planes beside the rings and the
// target diagonal's payload at the done step in pay. RT: the M, I, D
// rings' values (int16_t for wfa_mid, whose lengths stay below 32,767).
template <int G, bool kTb, bool kMid, int kSteps, class RT>
__global__ void __launch_bounds__(kMid ? kMidThreads : kMaxThreads, 1)
    wfa_kernel(const Bufs g, const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* ctrl = reinterpret_cast<int*>(smem + seq_bytes(p.n1) + seq_bytes(p.n2));
  RT* shared_ring = reinterpret_cast<RT*>(ctrl + kCtrlInts);
  if (p.grid == 0) {
    // one pair a cluster of C CTAs (rank = blockIdx.x % C), its rings in
    // shared memory after the control words
    const int rank = p.C > 1 ? (int)cg::this_cluster().block_rank() : 0;
    run_pair<G, kTb, kMid, kSteps, RT>(g, p, blockIdx.x / p.C, smem,
                                       shared_ring, nullptr, rank);
    return;
  }
  // a persistent grid: each CTA takes pairs from the counter; its global
  // workspace holds its payload planes (wfa_mid), then its rings unless
  // they are shared
  int* ws = g.ring_ws + kCounterInts + (size_t)blockIdx.x * p.ws_ints;
  const long long pay_ints =
      kMid ? (long long)(p.hm + 2 * p.he1) * (p.cw + 2) : 0;
  RT* ring = p.ring_global ? reinterpret_cast<RT*>(ws + pay_ints) : shared_ring;
  for (;;) {
    __syncthreads();   // the last pair's walk has read its control words
    if (threadIdx.x == 0) ctrl[6] = atomicAdd(g.ring_ws, 1);
    __syncthreads();
    const int b = ctrl[6];
    if (b >= p.B) return;
    run_pair<G, kTb, kMid, kSteps, RT>(g, p, b, smem, ring, ws, 0);
  }
}

// wfa_score's warp path: warp w of CTA c runs pair c * p.wp + w in its
// own slice of shared memory.
template <int G, int kSteps>
__global__ void __launch_bounds__(kWarpPairs * 32, kWarpCtas)
    wfa_score_warp_kernel(const Bufs g, const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * p.wp + warp;
  if (b >= p.B) return;   // the whole warp
  uint8_t* slice = smem + warp * warp_slice(p, G);
  int* ring =
      reinterpret_cast<int*>(slice + seq_bytes(p.n1) + seq_bytes(p.n2));
  run_pair<G, false, false, kSteps, int, true>(g, p, b, slice, ring, nullptr,
                                               0);
}

template <int G, int kSteps>
int launch_warp(const Bufs& g, const Params& p, cudaStream_t stream) {
  const long long smem_ll = p.wp * warp_slice(p, G);
  if (smem_ll > kSmemLimit) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_ll);
  auto kern = wfa_score_warp_kernel<G, kSteps>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(p.B + p.wp - 1) / p.wp, 32 * p.wp, smem, stream>>>(g, p);
  return cudaGetLastError();
}

template <int G, bool kTb, bool kMid, int kSteps, class RT>
int launch(const Bufs& g, Params p, cudaStream_t stream) {
  if constexpr (!kTb && !kMid) {
    if (p.wp > 0) return launch_warp<G, kSteps>(g, p, stream);
  }
  const long long smem_ll = cta_smem(p, G, kTb, kMid, sizeof(RT));
  if (smem_ll > kSmemLimit) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_ll);
  auto kern = wfa_kernel<G, kTb, kMid, kSteps, RT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = std::min(kMid ? kMidThreads : kMaxThreads,
                               std::max(32, (p.cw + 31) / 32 * 32));
  if (p.grid) {
    // no more CTAs than the card holds at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    p.grid = std::min(p.grid, per_sm * sms);
    err = cudaMemsetAsync(g.ring_ws, 0, 4 * kCounterInts, stream);
    if (err != cudaSuccess) return err;
  }
  if (kTb) {
    // the op store's dead cells read 0 (the steps write live cells only)
    const cudaError_t err = cudaMemsetAsync(
        g.ops, 0, (size_t)(p.smax + 1) * p.B * p.K, stream);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid ? p.grid : p.B * p.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, g, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int G, bool kTb, bool kMid, class RT>
int launch_steps(const Bufs& g, const Params& p, int steps,
                 cudaStream_t stream) {
  return steps == 2 ? launch<G, kTb, kMid, 2, RT>(g, p, stream)
                    : launch<G, kTb, kMid, 1, RT>(g, p, stream);
}

// tb: wfa_align; mid: wfa_mid (G = 1, pay [B] i32); neither: wfa_score
// (G = 0 too: gap-linear, o1 = 0, he1 = he2 = 0).
int run(bool tb, bool mid, const void* refs, int n1, const void* reads,
        int n2, const void* ref_lens, const void* read_lens, int B, int G,
        int smax, int kmax, int x, int o1, int e1, int o2, int e2,
        int wildcards, int adaptive, int steps, int hm, int he1, int he2,
        int C, int wp, int grid, int ring_global, long long ws_ints,
        void* ring_ws,
        void* pen, void* ops, void* ops_fwd, void* fin, void* pay,
        void* runs, int rmax, void* stream) {
  if (B <= 0 || n1 < 1 || n2 < 1 || smax < 0 || kmax < 0 ||
      G < 0 || G > 2 || x < 1 || o1 < 0 || e1 < 1)
    return cudaErrorInvalidValue;
  if (G == 0) {
    // gap-linear: score only, no gap open, no gap planes
    if (tb || mid || o1 != 0 || he1 != 0) return cudaErrorInvalidValue;
    o2 = e2 = he2 = 0;
  } else if (G == 1) {
    o2 = e2 = he2 = 0;
  } else if (o2 < 0 || e2 < 1) {
    return cudaErrorInvalidValue;
  }
  if (!tb) adaptive = -1;
  // steps between barriers: no lookback shorter, no trim between them
  int least = std::min(x, e1);
  if (G == 2) least = std::min(least, e2);
  if (steps != 1 && (steps != 2 || least < 2 || adaptive >= 0))
    return cudaErrorInvalidValue;
  // each plane's rows cover its lookbacks and the steps of an interval
  int back = std::max(x, o1 + e1);
  if (G == 2) back = std::max(back, o2 + e2);
  if (hm < back + steps || (G >= 1 && he1 < e1 + steps) ||
      (G == 2 && he2 < e2 + steps))
    return cudaErrorInvalidValue;
  const int K = 2 * kmax + 1;
  if (C != 1 && C != 2 && C != 4 && C != kMaxCluster) return cudaErrorInvalidValue;
  // the warp path: score only, one warp a pair, a band of kWarpMaxK
  if (wp < 0 || (wp > 0 && (tb || mid || C != 1 || grid || K > kWarpMaxK ||
                            wp > kWarpPairs)))
    return cudaErrorInvalidValue;
  if (grid < 0 || (grid > 0 && C != 1) || (grid > 0) != (ring_ws != nullptr) ||
      (ring_global && !grid) || (mid && !grid))
    return cudaErrorInvalidValue;
  // wfa_mid's int16 rings hold offsets below 32,767
  if (mid && (n1 >= 32767 || n2 >= 32767)) return cudaErrorInvalidValue;
  if (tb && (!ops || !ops_fwd || !fin || !runs || rmax < 3))
    return cudaErrorInvalidValue;
  if (mid && (tb || G != 1 || !pay)) return cudaErrorInvalidValue;
  const Params p{n1, n2, B, smax, kmax, K, x, o1, e1, o2, e2, hm, he1, he2,
                 wildcards, adaptive, C, (K + C - 1) / C, grid,
                 ring_global, ws_ints, wp, rmax};
  if (grid && ws_ints < cta_ws_ints(p, G, mid)) return cudaErrorInvalidValue;
  const Bufs g{static_cast<const uint8_t*>(refs),
               static_cast<const uint8_t*>(reads),
               static_cast<const int*>(ref_lens),
               static_cast<const int*>(read_lens),
               static_cast<int*>(ring_ws), static_cast<int*>(pen),
               static_cast<uint8_t*>(ops), static_cast<uint8_t*>(ops_fwd),
               static_cast<int*>(fin), static_cast<int*>(pay),
               static_cast<int*>(runs)};
  auto s = static_cast<cudaStream_t>(stream);
  if (mid) return launch_steps<1, false, true, int16_t>(g, p, steps, s);
  if (G == 0) return launch_steps<0, false, false, int>(g, p, steps, s);
  if (G == 1)
    return tb ? launch_steps<1, true, false, int>(g, p, steps, s)
              : launch_steps<1, false, false, int>(g, p, steps, s);
  return tb ? launch<2, true, false, 1, int>(g, p, s)
            : launch<2, false, false, 1, int>(g, p, s);
}

}  // namespace
}  // namespace clique_wfa

// The recurrence of one diagonal of one score step and nothing else:
// never launched for work, compiled (with external linkage, so that it is
// kept) so that its SASS gives the operations of a cell (chip_smoke.py).
// Its ring values and (k, s1, l1, l2) are loaded from fixed offsets and
// its outputs stored to fixed offsets, so that besides the recurrence the
// probe holds loads, stores and moves only. kOp: with the op byte
// (wfa_align), else without it (wfa_score, where it is dead code).
template <int G, bool kOp>
__device__ void wfa_cell_probe(const int* in, const int* lens, int* out) {
  clique_wfa::CellIn<G> c;
  c.mism = in[0];
#pragma unroll
  for (int g = 0; g < clique_wfa::nc(G); ++g) {
    c.d_open[g] = in[1 + 4 * g];
    if (G > 0) c.d_ext[g] = in[2 + 4 * g];
    c.i_open[g] = in[3 + 4 * g];
    if (G > 0) c.i_ext[g] = in[4 + 4 * g];
  }
  int m, ni[clique_wfa::nc(G)], nd[clique_wfa::nc(G)];
  uint8_t op;
  clique_wfa::combine<G>(c, lens[0], lens[1], lens[2], lens[3], &m, ni, nd,
                         &op);
  out[0] = m;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    out[1 + 2 * g] = ni[g];
    out[2 + 2 * g] = nd[g];
  }
  if (kOp) out[5] = op;
}

extern "C" __global__ void clique_wfa_cell_probe_affine(const int* in,
                                                        const int* lens,
                                                        int* out) {
  wfa_cell_probe<1, true>(in, lens, out);
}

extern "C" __global__ void clique_wfa_cell_probe_affine2p(const int* in,
                                                          const int* lens,
                                                          int* out) {
  wfa_cell_probe<2, true>(in, lens, out);
}

extern "C" __global__ void clique_wfa_score_probe_affine(const int* in,
                                                         const int* lens,
                                                         int* out) {
  wfa_cell_probe<1, false>(in, lens, out);
}

extern "C" __global__ void clique_wfa_score_probe_affine2p(const int* in,
                                                           const int* lens,
                                                           int* out) {
  wfa_cell_probe<2, false>(in, lens, out);
}

// The gap-linear cell of wfa_score (G = 0): the mismatch and the two
// indels from M, the clamp, no gap planes.
extern "C" __global__ void clique_wfa_score_probe_linear(const int* in,
                                                         const int* lens,
                                                         int* out) {
  wfa_cell_probe<0, false>(in, lens, out);
}

// wfa_mid's cell: the affine recurrence as clique_wfa_score_probe_affine,
// then the payload work (mid_pays' choices from the op byte, pay_update
// across the extension), its ring values and payload candidates loaded
// from fixed offsets.
extern "C" __global__ void clique_wfa_mid_probe(const int* in,
                                                const int* lens, int* out) {
  clique_wfa::CellIn<1> c;
  c.mism = in[0];
  c.d_open[0] = in[1];
  c.d_ext[0] = in[2];
  c.i_open[0] = in[3];
  c.i_ext[0] = in[4];
  int m, ni[1], nd[1];
  uint8_t op;
  clique_wfa::combine<1>(c, lens[0], lens[1], lens[2], lens[3], &m, ni, nd,
                         &op);
  int pm, pi, pd;
  const int cand[5] = {in[5], in[6], in[7], in[8], in[9]};
  clique_wfa::mid_pays(op, cand, &pm, &pi, &pd);
  out[0] = m;
  out[1] = ni[0];
  out[2] = nd[0];
  out[3] = clique_wfa::pay_update(m, lens[4], pm, lens[0], lens[5]);
  out[4] = pi;
  out[5] = pd;
}

// Four bytes of greedy extension with wildcards that differ and nothing
// else (the loop body of extend_run; its funnel shift is loaded, since a
// run keeps one), for its operation count (chip_smoke.py).
extern "C" __global__ void clique_wfa_word_probe(const uint32_t* in,
                                                 int* out) {
  const uint32_t a = __funnelshift_r(in[0], in[1], in[4]);
  const uint32_t b = __funnelshift_r(in[2], in[3], in[5]);
  out[0] = clique_wfa::differ4(a, b, true) != 0;
}

// Launch wfa_align on `stream`: refs [B, n1] u8, reads [B, n2] u8
// (row-padded), lens [B] i32; G gap classes (1 affine: o1, e1; 2
// affine2p: also o2, e2), K = 2 * kmax + 1 diagonals; wildcards 0/1;
// adaptive the wf-adaptive margin or -1. The layout of wfa_kernels.wfa_plan:
// steps (1, or 2 where x and every extend are >= 2 and the trim is off)
// score steps between barriers, ring rows hm (M), he1 and he2 (I and D of
// each class), C CTAs a pair (a cluster when > 1), or grid > 0: a
// persistent grid of at most grid CTAs with ws_ints ints of the workspace
// ring_ws each ([4 + grid * ws_ints] i32), the rings there when
// ring_global (else in shared memory); ring_ws null when grid is 0. pen
// [B] i32, ops [smax+1, B, K] u8, ops_fwd [B, smax+1] u8, fin [B] i32,
// runs [B, rmax] i32 (rmax >= 3; wfa_kernels.runs_width holds any
// converged walk's CIGAR). A pair whose lengths lie outside its rows gets
// pen -1, fin -3 and no runs. Returns the CUDA error of the launch (a
// cluster the card cannot hold is refused).
extern "C" int clique_wfa_align(const void* refs, int n1, const void* reads,
                                int n2, const void* ref_lens,
                                const void* read_lens, int B, int G, int smax,
                                int kmax, int x, int o1, int e1, int o2,
                                int e2, int wildcards, int adaptive, int steps,
                                int hm, int he1, int he2, int C, int grid,
                                int ring_global, long long ws_ints,
                                void* ring_ws, void* pen, void* ops,
                                void* ops_fwd, void* fin, void* runs,
                                int rmax, void* stream) {
  return clique_wfa::run(true, false, refs, n1, reads, n2, ref_lens,
                         read_lens, B, G, smax, kmax, x, o1, e1, o2, e2,
                         wildcards, adaptive, steps, hm, he1, he2, C, 0, grid,
                         ring_global, ws_ints, ring_ws, pen, ops, ops_fwd,
                         fin, nullptr, runs, rmax, stream);
}

// Launch wfa_score: the arguments of clique_wfa_align without the trim and
// the outputs but the penalties, and wp: > 0 for the warp path (one warp a
// pair, wp pairs a CTA, C 1, no persistent grid, K <= 128; wfa_plan). G =
// 0 is gap-linear: mismatch x, e an indel base, o1 = 0, he1 = he2 = 0 (M
// rings only).
extern "C" int clique_wfa_score(const void* refs, int n1, const void* reads,
                                int n2, const void* ref_lens,
                                const void* read_lens, int B, int G, int smax,
                                int kmax, int x, int o1, int e1, int o2,
                                int e2, int wildcards, int steps, int hm,
                                int he1, int he2, int C, int wp, int grid,
                                int ring_global, long long ws_ints,
                                void* ring_ws, void* pen, void* stream) {
  return clique_wfa::run(false, false, refs, n1, reads, n2, ref_lens,
                         read_lens, B, G, smax, kmax, x, o1, e1, o2, e2,
                         wildcards, -1, steps, hm, he1, he2, C, wp, grid,
                         ring_global, ws_ints, ring_ws, pen, nullptr, nullptr,
                         nullptr, nullptr, nullptr, 0, stream);
}

// Launch wfa_mid, the gap-affine midpoint fill of the bialign engine:
// inputs as clique_wfa_align's with G = 1 (x, o, e; rows hm and he of M
// and of I and D) and always a persistent grid: each CTA's workspace holds
// its payload planes, then its rings when ring_global; the M, I, D rings
// hold int16 offsets (n1, n2 < 32,767). pen [B] i32 (smax + 1 censored),
// pay [B] i32 (h * 65536 + v of the split cell, -1 censored). A pair
// whose lengths lie outside its rows gets pen -1 and pay -1. Returns the
// CUDA error of the launch.
extern "C" int clique_wfa_mid(const void* refs, int n1, const void* reads,
                              int n2, const void* ref_lens,
                              const void* read_lens, int B, int smax,
                              int kmax, int x, int o, int e, int wildcards,
                              int steps, int hm, int he, int grid,
                              int ring_global, long long ws_ints,
                              void* ring_ws, void* pen, void* pay,
                              void* stream) {
  return clique_wfa::run(false, true, refs, n1, reads, n2, ref_lens,
                         read_lens, B, 1, smax, kmax, x, o, e, 0, 0,
                         wildcards, -1, steps, hm, he, 0, 1, 0, grid,
                         ring_global, ws_ints, ring_ws, pen, nullptr,
                         nullptr, nullptr, pay, nullptr, 0, stream);
}
