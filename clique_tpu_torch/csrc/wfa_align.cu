// Wavefront alignment (WFA) of a batch of (reference, read) pairs, for
// Hopper (sm_90a): the gap-affine and dual-affine ("convex") wavefront
// fills, with an op store and the backtrace walk fused after the fill
// (wfa_align), score only (wfa_score), or gap-affine with the bialign
// engine's split payload (wfa_mid).
//
// Replaces: clique_tpu/align/wavefront.py::wfa_affine_tb_batch (:723),
// wfa_affine2p_tb_batch (:874) and wfa_walk_device (:1154) -> wfa_align;
// wfa_affine_batch (:316) and wfa_affine2p_batch (:612) -> wfa_score;
// wfa_affine_mid_batch (:442) -> wfa_mid. Each JAX function is a
// lax.while_loop that advances the whole batch one score step an
// iteration as [B, K] vector ops, until every lane is done. The plain
// versions are align/wfa_kernels.py::wfa_fill_reference,
// wfa_walk_reference and wfa_mid_reference.
//
// What bounds it on an H100: integer work. A score step updates every one
// of the K diagonals of a pair (K = 2 * kmax + 1, kmax the exact band
// (smax - o) / e of wfa_kernels.exact_kband): a handful of ring loads, a
// few dozen integer max / compare / select instructions, one op byte
// stored. A pair takes as many steps as its penalty, and the bytes it
// must move (two sequences in, a penalty, its op-store rows and skeleton
// out) are small against that, so it is bound by integer operations
// (chip_smoke.py counts a cell's instructions in this file's SASS through
// clique_wfa_cell_probe_*). Greedy extension compares bytes.
//
// What the design does about it (a simple kernel first):
// - One CTA a pair, its two sequences in shared memory. The threads stride
//   over the K diagonals; one __syncthreads a score step (two with the
//   wf-adaptive trim, whose CTA maximum of 2h - k needs its own barrier).
//   A pair stops at its own penalty: no lane waits for the batch's worst.
// - The ring buffers (hist rows of K offsets for M, and for I and D of
//   each gap class, hist = the longest lookback + 1) live in shared memory
//   when they fit beside the sequences, else in a per-pair global
//   workspace that stays in L2: affine2p at the 1,024-ceiling reruns of
//   an L = 384 bucket (K = 1,537) needs 5 x 26 x 1,537 x 4 B ~ 800 KB.
//   clique_wfa_global_ring_ints says which shapes take that path.
// - Extension compares four bytes at a time: two aligned 32-bit loads and
//   a funnel shift give four bytes at any offset, __vcmpeq4 the equal
//   bytes, __vcmpltu4 / __vcmpeq4 the wildcard bytes (below '0' + 10, or
//   'N'); on HiFi reads diagonal 0 extends across almost the whole read.
// - wfa_align writes each step's op bytes (every diagonal) to the global
//   op store [smax+1, B, K] in the plain version's layout, then thread 0
//   walks that pair's store backwards exactly as wfa_walk_device does: one
//   op a row, an M -> gap switch fused with the gap's first step at the
//   same row. It counts the ops, then writes them in forward order into
//   the skeleton row [smax+1] (0-padded), and the end row into fin: -1 a
//   converged walk, -2 a censored pair.
//
// - wfa_mid is the score fill with three payload planes (PM, PI, PD: the
//   last on-path M cell at or before the anti-diagonal (l1 + l2) / 2, as
//   h * 65536 + v) beside the M, I and D rings, in the same shared or
//   global ring space. Each payload follows the choice the cell's op byte
//   records, so payload and traceback cannot disagree; pay_update moves
//   an M payload across the step's greedy extension. Its steps visit only
//   |k| <= min(s, (s - o) / e), the diagonals a penalty of s reaches (every
//   other cell is NEG in every ring row). At the bialign engine's top rung
//   (L = 4,224, smax 4,096, K = 4,091) the planes take 884 KB a pair, so
//   they live in the global workspace.
//
// Exactness: integers only. The recurrence, its clamp order (affine clamps
// I and D after taking M's maximum, affine2p before), its tie orders
// (mismatch > I > D, mismatch > I1 > D1 > I2 > D2; a gap extends only
// where extend > open), the NEG sentinel and the bounds are the JAX
// functions'. Rows of the op store past a pair's penalty are not written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace clique_wfa {
namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // an H100 block's shared memory
constexpr int kCtrlInts = 4;        // done step, two adaptive maxima, ops
                                    // (wfa_mid: the payload in slot 1)
constexpr int kMidEnc = 1 << 16;    // wfa_mid's payload: h * kMidEnc + v

struct Params {
  int n1, n2;        // row widths: refs [B, n1], reads [B, n2]
  int B, smax, kmax, K, hist;
  int x, o1, e1, o2, e2;
  int wildcards;
  int adaptive;      // the wf-adaptive margin, < 0: off
};

// Bytes a sequence row takes in shared memory: whole words and one spare
// word, so that a four-byte read at any offset below n stays inside.
__host__ __device__ inline int seq_bytes(int n) { return ((n + 3) / 4 + 1) * 4; }

// Ints of a pair's rings: hist rows of K for M and for I and D of each gap
// class; wfa_mid keeps a payload plane beside each of them.
__host__ __device__ inline long long ring_ints(int G, int hist, int K,
                                               bool mid) {
  return (1LL + 2 * G) * hist * K * (mid ? 2 : 1);
}

__host__ inline long long smem_with_rings(int n1, int n2, int G, int hist,
                                          int K, bool mid) {
  return seq_bytes(n1) + seq_bytes(n2) + 4LL * kCtrlInts +
         4 * ring_ints(G, hist, K, mid);
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

// The greedy match run from ref[h], read[v], at most n bytes.
__device__ int extend_run(const uint8_t* ref, const uint8_t* read, int h,
                          int v, int n, bool wildcards) {
  int run = 0;
  for (; run + 4 <= n; run += 4) {
    const uint32_t a = load4(ref, h + run), b = load4(read, v + run);
    uint32_t eq = __vcmpeq4(a, b);
    if (wildcards) eq |= wild4(a) | wild4(b);
    if (eq != 0xffffffffu) return run + (__ffs(~eq) - 1) / 8;
  }
  for (; run < n; ++run) {
    const int a = ref[h + run], b = read[v + run];
    if (!(a == b || (wildcards && (wild1(a) || wild1(b))))) break;
  }
  return run;
}

__device__ __forceinline__ int plus1(int w) { return w > kNeg ? w + 1 : kNeg; }

// The rows of a score step's lookbacks: ring row of s1 - back, or -1
// before the first step (a NEG wavefront).
__device__ __forceinline__ int back_row(int s1, int back, int hist) {
  return s1 - back >= 0 ? (s1 - back) % hist : -1;
}

__device__ __forceinline__ int ring_at(const int* plane, int row, int ki,
                                       int K) {
  return (row >= 0 && ki >= 0 && ki < K) ? plane[row * K + ki] : kNeg;
}

// The ring values one diagonal of one score step reads: M at s1 - x (k),
// and for each gap class the opens (M at s1 - o_g - e_g, k -/+ 1) and the
// extends (D at k - 1, I at k + 1, s1 - e_g); NEG outside the rows.
template <int G>
struct CellIn {
  int mism;
  int d_open[G], d_ext[G], i_open[G], i_ext[G];
};

// rows: [0] s1 - x, [1 + g] s1 - o_g - e_g, [3 + g] s1 - e_g.
template <int G>
__device__ __forceinline__ CellIn<G> gather(const int* M, const int* const* I,
                                            const int* const* D,
                                            const int* rows, int ki, int K) {
  CellIn<G> in;
  in.mism = ring_at(M, rows[0], ki, K);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    in.d_open[g] = ring_at(M, rows[1 + g], ki - 1, K);
    in.d_ext[g] = ring_at(D[g], rows[3 + g], ki - 1, K);
    in.i_open[g] = ring_at(M, rows[1 + g], ki + 1, K);
    in.i_ext[g] = ring_at(I[g], rows[3 + g], ki + 1, K);
  }
  return in;
}

// The recurrence of one diagonal k at score s1 from its ring values: the
// new M (before extension), I and D of each gap class (clamped), and the
// op byte.
template <int G>
__device__ __forceinline__ void combine(const CellIn<G>& in, int k, int s1,
                                        int l1, int l2, int* new_m,
                                        int* new_i, int* new_d, uint8_t* op) {
  const bool vld = (k <= s1 && -k <= s1) && k >= -l2 && k <= l1;
  int raw_i[G], raw_d[G];
  int byte = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    raw_d[g] = plus1(max(in.d_open[g], in.d_ext[g]));
    raw_i[g] = max(in.i_open[g], in.i_ext[g]);
    const int shift = (G == 1 ? 2 : 3) + 2 * g;
    byte |= (int(in.i_ext[g] > in.i_open[g]) << shift) |
            (int(in.d_ext[g] > in.d_open[g]) << (shift + 1));
  }
  const int mism = plus1(in.mism);
  auto clamp = [&](int offs) {
    const int v = offs - k;
    return (vld && offs <= l1 && v <= l2 && v >= 0) ? offs : kNeg;
  };
  int m, src;
  if (G == 1) {
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
  if (m <= kNeg) src = 0;
  *op = static_cast<uint8_t>(byte | src);
  *new_m = clamp(m);
}

// wfa_mid's payloads of one diagonal's new I, D and M (M before its
// extension), each following the choice its op byte records, as the
// traceback would: I from extend (k + 1, s1 - e) where bit 2 says so,
// else from the M at s1 - o - e (k + 1); D likewise at k - 1 (bit 3); M
// from the mismatch (s1 - x, k), the I or the D (bits 0-1; -1 where no
// source: the cell is NEG). load(plane, row, ki) reads payload plane 0
// (PM), 1 (PI) or 2 (PD) at rows[row] of the step's lookbacks.
template <class Load>
__device__ __forceinline__ void mid_pays(uint8_t op, int ki, Load load,
                                         int* pm, int* pi, int* pd) {
  *pi = (op >> 2) & 1 ? load(1, 3, ki + 1) : load(0, 1, ki + 1);
  *pd = (op >> 3) & 1 ? load(2, 3, ki - 1) : load(0, 1, ki - 1);
  const int src = op & 3;
  *pm = src == 1 ? load(0, 0, ki) : src == 2 ? *pi : src == 3 ? *pd : -1;
}

// pay_update of wfa_affine_mid_batch: across an M step and its greedy
// extension h_base .. h_ext on diagonal k, the payload becomes the last
// cell of that run at or before the mid anti-diagonal, if one is (>> is
// an arithmetic shift: a floor, as jnp's).
__device__ __forceinline__ int pay_update(int h_base, int h_ext, int pay,
                                          int k, int mid) {
  if (h_base <= kNeg) return pay;
  const int cand = min(max((mid + k) >> 1, h_base), h_ext);
  return 2 * cand - k <= mid ? cand * kMidEnc + (cand - k) : pay;
}

// The walk of wfa_walk_device from (row score, diagonal k_target): returns
// the end row (fin) and the number of ops; with `out`, writes them in
// forward order to out[0 .. n).
template <int G>
__device__ int walk(const uint8_t* ops, const Params& p, int b, int score,
                    int k_target, uint8_t* out, int n_total, int* n_ops) {
  int s = score;
  int k = min(max(k_target, -p.kmax), p.kmax);
  int st = 0, j = 0;
  const int mmask = G == 1 ? 3 : 7;
  auto emit = [&](int c) {
    if (out) out[n_total - 1 - j] = static_cast<uint8_t>(c);
    ++j;
  };
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
        emit('X');
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
    emit(ext ? (ins ? 'i' : 'd') : (ins ? 'I' : 'D'));
    s -= ext ? e : oe;
    k += ins ? 1 : -1;
    if (!ext) st = 0;
    if (s >= row) break;
  }
  *n_ops = j;
  return s;
}

// kTb: with the op store and the walk (wfa_align). kMid (G = 1, no kTb):
// the midpoint fill (wfa_mid), payload planes beside the rings and the
// target diagonal's payload at the done step in pay; its steps visit only
// the diagonals a penalty of s1 can reach.
template <int G, bool kTb, bool kMid>
__global__ void __launch_bounds__(kMaxThreads)
    wfa_kernel(const uint8_t* __restrict__ refs,
               const uint8_t* __restrict__ reads,
               const int* __restrict__ ref_lens,
               const int* __restrict__ read_lens, const Params p,
               int* __restrict__ ring_ws, int* __restrict__ pen,
               uint8_t* __restrict__ ops, uint8_t* __restrict__ ops_fwd,
               int* __restrict__ fin, int* __restrict__ pay) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = p.K, kmax = p.kmax, hist = p.hist;
  const int S1 = p.smax + 1;
  const int l1 = ref_lens[b], l2 = read_lens[b];
  if (l1 < 0 || l1 > p.n1 || l2 < 0 || l2 > p.n2) {
    // lengths outside the rows: marked, not aligned
    if (tid == 0) {
      pen[b] = -1;
      if (kTb) fin[b] = -3;
      if (kMid) pay[b] = -1;
    }
    if (kTb)
      for (int i = tid; i < S1; i += nt) ops_fwd[(size_t)b * S1 + i] = 0;
    return;
  }
  const int sa = seq_bytes(p.n1), sb = seq_bytes(p.n2);
  uint8_t* sref = smem;
  uint8_t* sread = smem + sa;
  int* ctrl = reinterpret_cast<int*>(smem + sa + sb);
  int* ring = ring_ws ? ring_ws + (size_t)b * ring_ints(G, hist, K, kMid)
                      : ctrl + kCtrlInts;
  for (int i = tid; i < sa; i += nt)
    sref[i] = i < l1 ? refs[(size_t)b * p.n1 + i] : 0;
  for (int i = tid; i < sb; i += nt)
    sread[i] = i < l2 ? reads[(size_t)b * p.n2 + i] : 0;
  const int plane = hist * K;
  const long long rn = ring_ints(G, hist, K, false);
  for (long long i = tid; i < rn; i += nt) ring[i] = kNeg;
  // wfa_mid's payload planes PM, PI, PD after the rings, -1 (none)
  int* P = ring + rn;
  if (kMid)
    for (long long i = tid; i < rn; i += nt) P[i] = -1;
  int* M = ring;
  int* I[G];
  int* D[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    I[g] = ring + (1 + 2 * g) * plane;
    D[g] = ring + (2 + 2 * g) * plane;
  }
  if (kTb)
    for (int ki = tid; ki < K; ki += nt) ops[(size_t)b * K + ki] = 0;
  if (tid == 0) {
    ctrl[0] = -1;
    ctrl[1] = ctrl[2] = kNeg;
    if (kMid) ctrl[1] = -1;
  }
  const int k_target = l1 - l2;
  const bool target_ok = k_target <= kmax && -k_target <= kmax;
  const int tki = min(max(k_target, -kmax), kmax) + kmax;
  const bool wild = p.wildcards != 0;
  const int mid = (l1 + l2) / 2;
  __syncthreads();
  if (tid == 0) {
    // s = 0: diagonal 0 from offset 0, extended
    const int m0 = extend_run(sref, sread, 0, 0, min(l1, l2), wild);
    M[kmax] = m0;
    if (kMid) P[kmax] = pay_update(0, m0, -1, 0, mid);
    if (target_ok && tki == kmax && m0 >= l1) {
      ctrl[0] = 0;
      if (kMid) ctrl[1] = P[kmax];
    }
  }
  __syncthreads();
  int result = ctrl[0];
  const int o_e[2] = {p.o1 + p.e1, p.o2 + p.e2};
  const int e_[2] = {p.e1, p.e2};
  for (int s1 = 1; result < 0 && s1 <= p.smax; ++s1) {
    int rows[5];
    rows[0] = back_row(s1, p.x, hist);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      rows[1 + g] = back_row(s1, o_e[g], hist);
      rows[3 + g] = back_row(s1, e_[g], hist);
    }
    const int row = s1 % hist;
    // wfa_mid: no diagonal past min(s1, (s1 - o) / e) holds a value yet
    int k_lo = 0, k_hi = K;
    if (kMid) {
      const int reach =
          p.e1 > 0 ? (s1 > p.o1 ? (s1 - p.o1) / p.e1 : 0) : kmax;
      const int kr = min(kmax, min(s1, reach));
      k_lo = kmax - kr;
      k_hi = kmax + kr + 1;
    }
    int best = kNeg;
    for (int ki = k_lo + tid; ki < k_hi; ki += nt) {
      const int k = ki - kmax;
      int m, ni[G], nd[G];
      uint8_t op;
      combine<G>(gather<G>(M, I, D, rows, ki, K), k, s1, l1, l2, &m, ni, nd,
                 &op);
      int pm = -1, pi = -1, pd = -1;
      if (kMid)
        mid_pays(op, ki,
                 [&](int pl, int r, int kj) {
                   return (rows[r] >= 0 && kj >= 0 && kj < K)
                              ? P[pl * plane + rows[r] * K + kj]
                              : -1;
                 },
                 &pm, &pi, &pd);
      const int h_base = m;
      if (m > kNeg && m >= 0) {
        const int v = m - k;
        const int n = min(l1 - m, l2 - v);
        if (n > 0) m += extend_run(sref, sread, m, v, n, wild);
      }
      M[row * K + ki] = m;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        I[g][row * K + ki] = ni[g];
        D[g][row * K + ki] = nd[g];
      }
      if (kMid) {
        pm = pay_update(h_base, m, pm, k, mid);
        P[row * K + ki] = pm;
        P[plane + row * K + ki] = pi;
        P[2 * plane + row * K + ki] = pd;
      }
      if (kTb) ops[((size_t)s1 * p.B + b) * K + ki] = op;
      if (p.adaptive >= 0) {
        if (m > kNeg) best = max(best, 2 * m - k);
      } else if (ki == tki && target_ok && m >= l1) {
        ctrl[0] = s1;
        if (kMid) ctrl[1] = pm;
      }
    }
    if (p.adaptive >= 0) {
      // wf-adaptive trim: drop diagonals whose antidiagonal progress
      // 2h - k lags the pair's best by more than the margin
      best = __reduce_max_sync(0xffffffffu, best);
      if ((tid & 31) == 0) atomicMax(&ctrl[1 + (s1 & 1)], best);
      __syncthreads();
      const int lim = ctrl[1 + (s1 & 1)] - p.adaptive;
      for (int ki = tid; ki < K; ki += nt) {
        const int k = ki - kmax;
        const int m = M[row * K + ki];
        if (m > kNeg && 2 * m - k < lim) {
          M[row * K + ki] = kNeg;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            I[g][row * K + ki] = kNeg;
            D[g][row * K + ki] = kNeg;
          }
        } else if (ki == tki && target_ok && m >= l1) {
          ctrl[0] = s1;
        }
      }
      if (tid == 0) ctrl[1 + ((s1 + 1) & 1)] = kNeg;
    }
    __syncthreads();
    result = ctrl[0];
  }
  const int score = result < 0 ? p.smax + 1 : result;
  if (tid == 0) {
    pen[b] = score;
    if (kMid) pay[b] = result < 0 ? -1 : ctrl[1];
  }
  if (!kTb) return;

  // the walk: thread 0 counts the ops, everyone clears the rest of the
  // skeleton row, thread 0 writes the ops in forward order
  uint8_t* out = ops_fwd + (size_t)b * S1;
  const bool alive = score < S1;
  if (tid == 0) {
    int n = 0;
    int s_end = -2;
    if (alive) s_end = walk<G>(ops, p, b, score, k_target, nullptr, 0, &n);
    ctrl[3] = n;
    fin[b] = s_end;
  }
  __syncthreads();
  const int n = ctrl[3];
  for (int i = n + tid; i < S1; i += nt) out[i] = 0;
  if (tid == 0 && n > 0) {
    int n2;
    walk<G>(ops, p, b, score, k_target, out, n, &n2);
  }
}

template <int G, bool kTb, bool kMid>
int launch(const uint8_t* refs, const uint8_t* reads, const int* ref_lens,
           const int* read_lens, const Params& p, int* ring_ws, int* pen,
           uint8_t* ops, uint8_t* ops_fwd, int* fin, int* pay,
           cudaStream_t stream) {
  const long long full = smem_with_rings(p.n1, p.n2, G, p.hist, p.K, kMid);
  const int smem = static_cast<int>(
      ring_ws ? full - 4 * ring_ints(G, p.hist, p.K, kMid) : full);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wfa_kernel<G, kTb, kMid>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads =
      std::min(kMaxThreads, std::max(32, (p.K + 31) / 32 * 32));
  wfa_kernel<G, kTb, kMid><<<p.B, threads, smem, stream>>>(
      refs, reads, ref_lens, read_lens, p, ring_ws, pen, ops, ops_fwd, fin,
      pay);
  return cudaGetLastError();
}

// tb: wfa_align; mid: wfa_mid (G = 1, pay [B] i32); neither: wfa_score.
int run(bool tb, bool mid, const void* refs, int n1, const void* reads,
        int n2, const void* ref_lens, const void* read_lens, int B, int G,
        int smax, int kmax, int hist, int x, int o1, int e1, int o2, int e2,
        int wildcards, int adaptive, void* ring_ws, void* pen, void* ops,
        void* ops_fwd, void* fin, void* pay, void* stream) {
  if (B <= 0 || n1 < 1 || n2 < 1 || smax < 0 || kmax < 0 ||
      (G != 1 && G != 2) || std::min({x, o1, e1, o2, e2}) < 0)
    return cudaErrorInvalidValue;
  int back = std::max({x, o1 + e1, e1});
  if (G == 2) back = std::max({back, o2 + e2, e2});
  if (hist != back + 1) return cudaErrorInvalidValue;
  const int K = 2 * kmax + 1;
  const bool global = smem_with_rings(n1, n2, G, hist, K, mid) > kSmemLimit;
  if (global != (ring_ws != nullptr)) return cudaErrorInvalidValue;
  if (tb && (!ops || !ops_fwd || !fin)) return cudaErrorInvalidValue;
  if (mid && (tb || G != 1 || !pay)) return cudaErrorInvalidValue;
  if (!tb) adaptive = -1;
  const Params p{n1, n2, B, smax, kmax, K, hist, x, o1, e1, o2, e2,
                 wildcards, adaptive};
  auto* a = static_cast<const uint8_t*>(refs);
  auto* r = static_cast<const uint8_t*>(reads);
  auto* la = static_cast<const int*>(ref_lens);
  auto* lb = static_cast<const int*>(read_lens);
  auto* w = static_cast<int*>(ring_ws);
  auto* pe = static_cast<int*>(pen);
  auto* op = static_cast<uint8_t*>(ops);
  auto* of = static_cast<uint8_t*>(ops_fwd);
  auto* fi = static_cast<int*>(fin);
  auto* pa = static_cast<int*>(pay);
  auto s = static_cast<cudaStream_t>(stream);
  if (mid)
    return launch<1, false, true>(a, r, la, lb, p, w, pe, op, of, fi, pa, s);
  if (G == 1)
    return tb ? launch<1, true, false>(a, r, la, lb, p, w, pe, op, of, fi,
                                       pa, s)
              : launch<1, false, false>(a, r, la, lb, p, w, pe, op, of, fi,
                                        pa, s);
  return tb ? launch<2, true, false>(a, r, la, lb, p, w, pe, op, of, fi, pa,
                                     s)
            : launch<2, false, false>(a, r, la, lb, p, w, pe, op, of, fi,
                                      pa, s);
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
  for (int g = 0; g < G; ++g) {
    c.d_open[g] = in[1 + 4 * g];
    c.d_ext[g] = in[2 + 4 * g];
    c.i_open[g] = in[3 + 4 * g];
    c.i_ext[g] = in[4 + 4 * g];
  }
  int m, ni[G], nd[G];
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
  clique_wfa::mid_pays(
      op, 0, [&](int pl, int r, int) { return in[5 + 4 * pl + r]; }, &pm,
      &pi, &pd);
  out[0] = m;
  out[1] = ni[0];
  out[2] = nd[0];
  out[3] = clique_wfa::pay_update(m, lens[4], pm, lens[0], lens[5]);
  out[4] = pi;
  out[5] = pd;
}

// Four bytes of greedy extension with wildcards and nothing else (the
// loop body of extend_run; its funnel shift is loaded, since a run keeps
// one), for its operation count (chip_smoke.py).
extern "C" __global__ void clique_wfa_word_probe(const uint32_t* in,
                                                 int* out) {
  const uint32_t a = __funnelshift_r(in[0], in[1], in[4]);
  const uint32_t b = __funnelshift_r(in[2], in[3], in[5]);
  const uint32_t eq =
      __vcmpeq4(a, b) | clique_wfa::wild4(a) | clique_wfa::wild4(b);
  out[0] = eq != 0xffffffffu;
}

// Ints of global ring workspace one pair needs: (1 + 2G) * hist * K (twice
// that with wfa_mid's payload planes, mid 1) when the rings do not fit in
// shared memory beside the two sequences, else 0.
extern "C" long long clique_wfa_global_ring_ints(int n1, int n2, int G,
                                                 int hist, int K, int mid) {
  using namespace clique_wfa;
  return smem_with_rings(n1, n2, G, hist, K, mid != 0) > kSmemLimit
             ? ring_ints(G, hist, K, mid != 0)
             : 0;
}

// Launch wfa_align on `stream`: refs [B, n1] u8, reads [B, n2] u8
// (row-padded), lens [B] i32; G gap classes (1 affine: o1, e1; 2
// affine2p: also o2, e2), K = 2 * kmax + 1 diagonals, hist rings rows
// (the longest lookback + 1); wildcards 0/1; adaptive the wf-adaptive
// margin or -1; ring_ws [B, clique_wfa_global_ring_ints] i32 when that is
// not 0, else null; pen [B] i32, ops [smax+1, B, K] u8, ops_fwd
// [B, smax+1] u8, fin [B] i32. A pair whose lengths lie outside its rows
// gets pen -1 and fin -3. Returns the CUDA error of the launch.
extern "C" int clique_wfa_align(const void* refs, int n1, const void* reads,
                                int n2, const void* ref_lens,
                                const void* read_lens, int B, int G, int smax,
                                int kmax, int hist, int x, int o1, int e1,
                                int o2, int e2, int wildcards, int adaptive,
                                void* ring_ws, void* pen, void* ops,
                                void* ops_fwd, void* fin, void* stream) {
  return clique_wfa::run(true, false, refs, n1, reads, n2, ref_lens,
                         read_lens, B, G, smax, kmax, hist, x, o1, e1, o2, e2,
                         wildcards, adaptive, ring_ws, pen, ops, ops_fwd, fin,
                         nullptr, stream);
}

// Launch wfa_score: the arguments of clique_wfa_align, with ops, ops_fwd
// and fin null and adaptive ignored.
extern "C" int clique_wfa_score(const void* refs, int n1, const void* reads,
                                int n2, const void* ref_lens,
                                const void* read_lens, int B, int G, int smax,
                                int kmax, int hist, int x, int o1, int e1,
                                int o2, int e2, int wildcards, int adaptive,
                                void* ring_ws, void* pen, void* ops,
                                void* ops_fwd, void* fin, void* stream) {
  return clique_wfa::run(false, false, refs, n1, reads, n2, ref_lens,
                         read_lens, B, G, smax, kmax, hist, x, o1, e1, o2, e2,
                         wildcards, adaptive, ring_ws, pen, ops, ops_fwd, fin,
                         nullptr, stream);
}

// Launch wfa_mid, the gap-affine midpoint fill of the bialign engine:
// inputs as clique_wfa_align's with G = 1 (x, o, e); ring_ws [B,
// clique_wfa_global_ring_ints(..., mid = 1)] i32 or null; pen [B] i32
// (smax + 1 censored), pay [B] i32 (h * 65536 + v of the split cell, -1
// censored). A pair whose lengths lie outside its rows gets pen -1 and
// pay -1. Returns the CUDA error of the launch.
extern "C" int clique_wfa_mid(const void* refs, int n1, const void* reads,
                              int n2, const void* ref_lens,
                              const void* read_lens, int B, int smax,
                              int kmax, int hist, int x, int o, int e,
                              int wildcards, void* ring_ws, void* pen,
                              void* pay, void* stream) {
  return clique_wfa::run(false, true, refs, n1, reads, n2, ref_lens,
                         read_lens, B, 1, smax, kmax, hist, x, o, e, 0, 0,
                         wildcards, -1, ring_ws, pen, nullptr, nullptr,
                         nullptr, pay, stream);
}
