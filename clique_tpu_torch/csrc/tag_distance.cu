// Tag-distance kernels for Hopper (sm_90a): the device work of collapse's
// tag correction.
//
// Replaces, in clique_tpu/collapse/distance.py:
// - _match_count_kernel (:240-252) fused with hamming_hits's radius test
//   (:295-296): every (tag, allowlist entry) pair whose Hamming distance,
//   L - min(matches, 255), is at most d. The XLA version one-hot encodes
//   byte classes, contracts them on the matrix unit into a [U, K] count
//   matrix and thresholds it on the host; the port's earlier kernel wrote
//   the u8 matrix too, 2048 x 16384 at a time, and two torch passes read it
//   back to find about one hit per tag. Here no matrix exists: the kernel tests
//   the radius itself and writes only the hits.
// - _edit_distance_kernel (:36-91): Levenshtein distance per row pair. The
//   XLA version sweeps anti-diagonals over [P, L+1] lanes with a scan; here
//   one thread owns one pair and runs the Myers/Hyyro bit-vector
//   recurrence over it.
// - the same kernel where collapse's degenerate correction calls it, fused
//   with the pair preparation of clique_tpu/collapse/correct.py:273-399
//   (triu or count-filtered pair enumeration, the count-ratio test) and
//   the radius test: clique_edit_hits takes one tag matrix for many groups
//   and writes only the pairs of one group whose counts differ by the
//   ratio and whose Levenshtein distance is at most d.
//
// What bounds them on an H100, and what the design does about it:
// - match hits: at the known-list shape (~25,000 tags x 737,280 entries,
//   L = 16) the inputs are 12 MB and the hits a few hundred KB, so the
//   integer pipe bounds it: one test per pair, 1.8e10 pairs. The wrapper
//   (distance.py::pack_hit_inputs) maps bytes to class codes over the
//   allowlist's distinct bytes, 2 bits a column for an ACGT list (4 up to
//   16 classes, 8 beyond), so a 16 bp row is one 32-bit word. A tag byte
//   no allowlist row holds mismatches every row: it is counted once into
//   the tag's budget (d minus such bytes) and masked out of its column.
//   One pair is then XOR, a shift-or that folds each code's bits onto its
//   top bit, an AND with the tag's live mask (one lop3), a popc and a
//   compare. Each lane holds 8 / words tags in registers; every lane of a
//   warp reads the same 16 bytes of the packed allowlist (one broadcast
//   load of 4 rows at 1 word a row), which sits in L2 (2.9 MB at the 10x
//   shape). A warp that finds any hit among its 32 x 8 tags x 4 rows
//   recomputes them, ballots, and reserves space with one atomicAdd per
//   ballot; hits go out as (u, k) i32 pairs in no order. One launch covers
//   the whole U x K. Rows wider than 8 words (L > 128 at 2 bits) take a
//   kernel with one tag a lane whose words stay in L1.
// - edit distance: at 2M pairs of 16 bp in 32-byte rows the function reads
//   134 MB once (0.04 ms at 3.35 TB/s); a DP over la x lb cells per pair
//   (the port's first kernel: a thread a pair, a rolling row, each thread
//   reading its own rows byte by byte) took 0.37-0.42 ms there. Design: the
//   Myers/Hyyro recurrence with no early exit, one thread a pair, the
//   pattern a[:la] as bit-vector words and one column step a text byte of
//   b[:lb]. Rows hold any byte, so a column's match mask is built in the
//   kernel from the pattern's eight bit planes (plane k, bit i: bit k of
//   a[i]; an 8 x 8 bit transpose a group of eight bytes, once a pair): the
//   OR of plane_k ^ (bit k of b[j], replicated by one PRMT) is 1 exactly
//   where a[i] != b[j]. A word takes one lop3 a plane, whatever the
//   alphabet. The distance is read from the last column's vertical deltas,
//   lb + popc(VP) - popc(VN) over rows below la: rows at or past la never
//   feed rows below them (carries, shifts and the horizontal delta between
//   words all move up), so bytes past la need no mask and columns past lb
//   are never run. One 32-bit word for L <= 32 (collapse's tags), up to four
//   64-bit words in registers up to kEditBandBytes, the words chained by
//   the horizontal delta (Hyyro's blocks, as edlib's calculateBlock). A
//   warp stages its 32 pairs' rows, each row block 32 L contiguous bytes,
//   through shared memory with coalesced 16-byte loads. Past
//   kEditBandBytes, bands of 256 pattern rows run one after another over
//   the whole text; each column's horizontal delta out of a band (2 bits)
//   waits in shared memory for the next band, so no device scratch is
//   needed at any width. min(d, 255) is taken at the end.
// - edit hits: the host used to enumerate every candidate pair, gather two
//   32-byte rows a pair and read every distance back (1.0-1.4 s of host
//   work for 3.66M pairs against 0.4 ms of kernel). Here the host uploads
//   one code matrix (O(T) bytes) and the kernel enumerates the pairs
//   itself. Operations bound it: a pair of w-byte tags is w column steps
//   of the Myers/Hyyro bit-vector recurrence (about 17 lane operations a
//   step in one 32-bit word for w <= 32, twice that in 64 bits up to 64),
//   instead of w x 32 DP cells. Bytes map to class codes over the matrix's
//   distinct bytes; a warp holds one high-count tag as the pattern and
//   its Peq masks (one word a class) in shared memory, and its lanes take
//   the partners. Tags are sorted by count within their group (by the
//   wrapper), so a pattern's partners, the tags of lower count that pass
//   c_h >= ratio * c_j, are a prefix of its group: the lanes sweep 32 at a
//   time and stop at the first 32 with no partner, so the ratio test
//   costs no divergence. The CTA's 8 warps hold 8 patterns of one group
//   and stage the group's codes in shared memory, 32 KB a tile, with
//   cp.async. A lane leaves a pair once score - (columns left) > d: the
//   score moves by at most 1 a column, so that pair cannot end within d.
//   Hits leave through emit() as (h, j) pairs, h the higher count. Pairs
//   the host chose (the pigeonhole candidates of groups past 4,096 tags)
//   take a second kernel, one pair a lane with the lane's Peq masks in
//   shared memory, on the same matrix.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace clique_tag {

constexpr int kHitThreads = 128;     // 4 warps a CTA
constexpr int kHitTagWords = 8;      // tag words a lane holds (tags x words)
constexpr int kHitWaves = 4;         // CTAs per SM the grid aims for, x 4
constexpr int kEditThreads = 128;
constexpr int kEditBandBytes = 256;  // pattern rows a band keeps in registers
constexpr int kSmemLimit = 232448;   // an H100 block's shared memory
constexpr int kEditHitWarps = 8;     // patterns (warps) a CTA of edit hits
constexpr int kEditHitTileBytes = 32768;  // shared tile of partner codes
constexpr int kEditHitPairSmem = 48 * 1024;  // Peq budget a pairs CTA
constexpr unsigned kFull = 0xffffffffu;

namespace {

// Fold each BITS-wide code of x onto its top bit: the top bit of a field
// is set iff the field is not zero (the other bits are garbage, masked
// by the caller).
template <int BITS>
__device__ __forceinline__ uint32_t fold(uint32_t x) {
  x |= x << 1;
  if (BITS >= 4) x |= x << 2;
  if (BITS >= 8) x |= x << 4;
  return x;
}

// Mismatched columns of one tag against one allowlist row of WT words.
template <int BITS, int WT>
__device__ __forceinline__ int mismatches(const uint32_t* t, const uint32_t* m,
                                          const uint32_t* a) {
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < WT; ++w) cnt += __popc(fold<BITS>(t[w] ^ a[w]) & m[w]);
  return cnt;
}

// Append the lanes' hits (h) as (u, k) pairs: one atomicAdd per warp.
// Hits past `cap` are counted and not written; the wrapper relaunches.
__device__ __forceinline__ void emit(bool h, int u, int k,
                                     unsigned long long* count, int2* out,
                                     unsigned long long cap) {
  const unsigned b = __ballot_sync(kFull, h);
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(b) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned long long)__popc(b));
  base = __shfl_sync(kFull, base, leader);
  if (h) {
    const unsigned long long i = base + __popc(b & ((1u << lane) - 1u));
    if (i < cap) out[i] = make_int2(u, k);
  }
}

// Hits for rows of WT words (WT in 1, 2, 4, 8). Lane `lane` of warp g
// holds tags g*32*T + 32*j + lane, j < T. The allowlist is [Kp][WT]
// words, Kp a multiple of 4; rows past K are read and never emitted.
// CTA (x, y) covers tag block x against rows [y*kchunk, (y+1)*kchunk).
template <int BITS, int WT>
__global__ void __launch_bounds__(kHitThreads)
match_hits_kernel(const uint32_t* __restrict__ tw,
                  const uint32_t* __restrict__ tm,
                  const int* __restrict__ tr,
                  const uint32_t* __restrict__ aw, int U, int K, int Kp,
                  int kchunk, unsigned long long* __restrict__ count,
                  int2* __restrict__ out, unsigned long long cap) {
  constexpr int T = kHitTagWords / WT;   // tags a lane
  constexpr int G = WT >= 4 ? 1 : 4 / WT; // rows a 16-byte group
  constexpr int V = (G * WT) / 4;        // 16-byte loads a group
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kHitThreads / 32) + (threadIdx.x >> 5);
  uint32_t t[T][WT], m[T][WT];
  int r[T], u[T];
  bool live = false;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    u[j] = warp * 32 * T + 32 * j + lane;
    const bool in = u[j] < U;
    r[j] = in ? tr[u[j]] : -1;
    live |= r[j] >= 0;
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      t[j][w] = in ? tw[static_cast<size_t>(u[j]) * WT + w] : 0u;
      m[j][w] = in ? tm[static_cast<size_t>(u[j]) * WT + w] : 0u;
    }
  }
  if (!__any_sync(kFull, live)) return;   // warp-uniform
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(Kp, k0 + kchunk);
  const uint4* src = reinterpret_cast<const uint4*>(aw);
  for (int k = k0; k < k1; k += G) {
    uint32_t a[G * WT];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 q = __ldg(src + static_cast<size_t>(k) * WT / 4 + v);
      a[4 * v] = q.x;
      a[4 * v + 1] = q.y;
      a[4 * v + 2] = q.z;
      a[4 * v + 3] = q.w;
    }
    bool any = false;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < T; ++j)
        any |= mismatches<BITS, WT>(t[j], m[j], a + g * WT) <= r[j];
    if (__any_sync(kFull, any)) {         // rare: recompute and emit
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < T; ++j)
          emit(k + g < K &&
                   mismatches<BITS, WT>(t[j], m[j], a + g * WT) <= r[j],
               u[j], k + g, count, out, cap);
    }
  }
}

// Hits for rows of any width W words (W > 8): one tag a lane, its words
// read from tw (L1-resident across the row loop).
template <int BITS>
__global__ void __launch_bounds__(kHitThreads)
match_hits_wide_kernel(const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ tm,
                       const int* __restrict__ tr,
                       const uint32_t* __restrict__ aw, int U, int K, int W,
                       int kchunk, unsigned long long* __restrict__ count,
                       int2* __restrict__ out, unsigned long long cap) {
  const int u = blockIdx.x * kHitThreads + threadIdx.x;
  const int r = u < U ? tr[u] : -1;
  if (!__any_sync(kFull, r >= 0)) return;
  const size_t row = static_cast<size_t>(u < U ? u : U - 1) * W;
  const uint32_t* t = tw + row;
  const uint32_t* m = tm + row;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  for (int k = k0; k < k1; ++k) {
    const uint32_t* a = aw + static_cast<size_t>(k) * W;
    int cnt = 0;
    for (int w = 0; w < W; ++w)
      cnt += __popc(fold<BITS>(t[w] ^ __ldg(a + w)) & m[w]);
    emit(cnt <= r, u, k, count, out, cap);
  }
}

template <int BITS>
int launch_hits(const uint32_t* tw, const uint32_t* tm, const int* tr,
                const uint32_t* aw, int U, int K, int Kp, int S,
                unsigned long long* count, int2* out,
                unsigned long long cap, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tags_cta = S <= kHitTagWords
                           ? (kHitThreads / 32) * 32 * (kHitTagWords / S)
                           : kHitThreads;
  const int xblocks = (U + tags_cta - 1) / tags_cta;
  // enough CTAs to fill every SM kHitWaves times over, in chunks of
  // whole 4-row groups
  const int target = sms * 16 * kHitWaves;
  int ychunks = (target + xblocks - 1) / xblocks;
  ychunks = max(1, min(ychunks, min((Kp + 3) / 4, 65535)));
  int kchunk = (Kp + ychunks - 1) / ychunks;
  kchunk = (kchunk + 3) / 4 * 4;
  ychunks = (Kp + kchunk - 1) / kchunk;
  const dim3 grid(xblocks, ychunks);
  switch (S) {
    case 1:
      match_hits_kernel<BITS, 1><<<grid, kHitThreads, 0, s>>>(
          tw, tm, tr, aw, U, K, Kp, kchunk, count, out, cap);
      break;
    case 2:
      match_hits_kernel<BITS, 2><<<grid, kHitThreads, 0, s>>>(
          tw, tm, tr, aw, U, K, Kp, kchunk, count, out, cap);
      break;
    case 4:
      match_hits_kernel<BITS, 4><<<grid, kHitThreads, 0, s>>>(
          tw, tm, tr, aw, U, K, Kp, kchunk, count, out, cap);
      break;
    case 8:
      match_hits_kernel<BITS, 8><<<grid, kHitThreads, 0, s>>>(
          tw, tm, tr, aw, U, K, Kp, kchunk, count, out, cap);
      break;
    default:
      match_hits_wide_kernel<BITS><<<grid, kHitThreads, 0, s>>>(
          tw, tm, tr, aw, U, K, S, kchunk, count, out, cap);
  }
  return cudaGetLastError();
}

// Four bytes from byte i of a shared-memory row (any alignment; reads up
// to byte i + 7).
__device__ __forceinline__ uint32_t smem_word(const uint8_t* row, int i) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(row) + i;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
  return __funnelshift_r(w[0], w[1], 8 * static_cast<int>(at & 3));
}

// The 8 x 8 bit transpose of eight bytes (byte i of x, bit j its bit j):
// byte k of the result holds bit k of byte i at bit i.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// The sign bit of a byte of {y, x} (bytes 0-3 of x, 4-7 of y) replicated
// over each byte of the result, as selector s picks them (prmt with the
// sign-replicate bit of each selector nibble).
__device__ __forceinline__ uint32_t prmt_sign(uint32_t x, uint32_t y,
                                              uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(s));
  return r;
}

// The text word tw shifted so that bit k of each byte is the byte's top
// bit: tk[k] = tw << (7 - k).
__device__ __forceinline__ void text_word(uint32_t tw, uint32_t (&tk)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) tk[k] = tw << (7 - k);
}

// Bit k of byte j of the text word, replicated over 32 bits, for k =
// 0..7: one prmt of tk[k] (text_word) each.
__device__ __forceinline__ void text_bits(const uint32_t (&tk)[8], int j,
                                          uint32_t (&m)[8]) {
  const uint32_t sel = (8u + j) * 0x1111u;
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = prmt_sign(tk[k], 0u, sel);
}

// A column's mismatch mask for patterns of at most 16 bytes: planes 2q and
// 2q + 1 share a word pp[q] (2q's in the low half) and one prmt gives both
// their bits of byte j, so four prmt and four lop3 build the mask. The
// high half (rows 16-31) holds garbage, which never feeds rows below la.
__device__ __forceinline__ uint32_t mismatch16(const uint32_t (&pp)[4],
                                               const uint32_t (&tk)[8],
                                               int j) {
  const uint32_t sel = (8u + j) * 0x0011u | (12u + j) * 0x1100u;
  uint32_t ne = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    ne |= pp[q] ^ prmt_sign(tk[2 * q], tk[2 * q + 1], sel);
  return ne | (ne >> 16);
}

// The columns j = 0 .. m - 1 of the text row (shared memory), four a text
// word: whole words every live lane runs (below mmin) without a test, then
// the ragged rest (up to mmax) lane by lane. col(tk, j) runs one.
template <class Col>
__device__ __forceinline__ void text_columns(const uint8_t* brow, int m,
                                             int mmin, int mmax, Col col) {
  int j0 = 0;
  for (; j0 + 4 <= mmin; j0 += 4) {
    uint32_t tk[8];
    text_word(smem_word(brow, j0), tk);
#pragma unroll
    for (int j = 0; j < 4; ++j) col(tk, j);
  }
  for (; j0 < mmax; j0 += 4) {
    uint32_t tk[8];
    text_word(smem_word(brow, j0), tk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + j < m) col(tk, j);
  }
}

// The pattern's bit planes in W words: pl[k][w] bit i is bit k of pattern
// byte w * bits + i, for the groups of eight bytes below n (the rest 0).
// read4(i) gives the four bytes i .. i + 3 as a little-endian word.
template <typename Word, int W, class Read4>
__device__ __forceinline__ void build_planes(Word (&pl)[8][W], int n,
                                             Read4 read4) {
  constexpr int kBits = 8 * sizeof(Word);
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int k = 0; k < 8; ++k) pl[k][w] = 0;
#pragma unroll
    for (int g = 0; g < kBits / 8; ++g) {
      const int i = w * kBits + 8 * g;
      if (i >= n) break;
      const uint64_t y = transpose8(static_cast<uint64_t>(read4(i)) |
                                    static_cast<uint64_t>(read4(i + 4)) << 32);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        pl[k][w] |= static_cast<Word>((y >> (8 * k)) & 0xffu) << (8 * g);
    }
  }
}

// One column of one word of the recurrence (edlib's calculateBlock): ne
// the word's mismatch mask, pv / mv its vertical +1 / -1 deltas, hin the
// horizontal delta into its lowest row (+1 in the first word: D(0, j) =
// j). Returns the horizontal delta out of its top row.
template <typename Word>
__device__ __forceinline__ int myers_word(Word ne, Word& pv, Word& mv,
                                          int hin) {
  constexpr int kTop = 8 * sizeof(Word) - 1;
  const Word hneg = hin < 0 ? Word(1) : Word(0);
  const Word hpos = hin > 0 ? Word(1) : Word(0);
  const Word eq = ~ne;
  const Word xv = eq | mv;
  const Word e = eq | hneg;
  const Word xh = (((e & pv) + pv) ^ pv) | e;
  Word ph = mv | ~(xh | pv);
  Word mh = pv & xh;
  const int hout = static_cast<int>(ph >> kTop) - static_cast<int>(mh >> kTop);
  ph = (ph << 1) | hpos;
  mh = (mh << 1) | hneg;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  return hout;
}

// One column over the first nw of W words: the mismatch mask of each word
// from the planes and the text byte's bits m, the words chained by their
// horizontal deltas. Returns the delta out of the last word run.
template <typename Word, int W>
__device__ __forceinline__ int myers_column(const Word (&pl)[8][W],
                                            const uint32_t (&m)[8], int nw,
                                            Word (&pv)[W], Word (&mv)[W],
                                            int hin) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w >= nw) break;
    Word ne = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ne |= pl[k][w] ^ static_cast<Word>(static_cast<int32_t>(m[k]));
    hin = myers_word<Word>(ne, pv[w], mv[w], hin);
  }
  return hin;
}

// The vertical deltas' sum over rows below n of W words (rows r0 ..).
template <typename Word, int W>
__device__ __forceinline__ int rows_sum(const Word (&pv)[W],
                                        const Word (&mv)[W], int n) {
  constexpr int kBits = 8 * sizeof(Word);
  int d = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int r = n - w * kBits;
    if (r <= 0) break;
    const Word mask = r >= kBits ? ~Word(0) : (Word(1) << r) - Word(1);
    d += __popcll(static_cast<unsigned long long>(pv[w] & mask)) -
         __popcll(static_cast<unsigned long long>(mv[w] & mask));
  }
  return d;
}

// Shared-memory bytes of one staged row block of a warp: its 32 rows after
// up to 15 bytes of misalignment, and the last row's pattern words, which
// read W * bits + 3 bytes from its start.
template <typename Word, int W>
__host__ __device__ inline int edit_block_bytes(int L) {
  return (31 * L + W * 8 * static_cast<int>(sizeof(Word)) + 32 + 15) / 16 *
         16;
}

// Copy the bytes [first, first + n) of a tensor of `total` bytes at `base`
// into dst (16-byte aligned) by the warp: asynchronous 16-byte copies
// (cp.async, the caller commits and waits) of the aligned chunks that lie
// inside the tensor, the tensor's ragged ends byte by byte. Returns where
// byte `first` lands.
__device__ __forceinline__ int stage_rows(const uint8_t* base, long long first,
                                          long long n, long long total,
                                          uint8_t* dst, int lane) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(base);
  const uintptr_t hi = lo + static_cast<uintptr_t>(total);
  const uintptr_t start = lo + static_cast<uintptr_t>(first);
  const uintptr_t c0 = start & ~uintptr_t(15);
  const int chunks = static_cast<int>((start + n - c0 + 15) / 16);
  for (int i = lane; i < chunks; i += 32) {
    const uintptr_t c = c0 + 16 * static_cast<uintptr_t>(i);
    if (c >= lo && c + 16 <= hi) {
      __pipeline_memcpy_async(dst + 16 * i, reinterpret_cast<const void*>(c),
                              16);
    } else {
      for (int k = 0; k < 16; ++k)
        if (c + k >= lo && c + k < hi)
          dst[16 * i + k] = *reinterpret_cast<const uint8_t*>(c + k);
    }
  }
  return static_cast<int>(start - c0);
}

// Levenshtein distance of a[p, :la[p]] and b[p, :lb[p]], min(d, 255), for
// L <= W words of Word. Each warp takes blocks of 32 pairs, one after
// another (block q of P / 32, then q + the grid's warps): it stages the
// next block's rows of a and b into its other pair of shared-memory
// buffers (cp.async) while its lanes run the current block's pairs: the
// planes of each pattern once, then one column a text byte.
template <typename Word, int W>
__global__ void __launch_bounds__(kEditThreads)
edit_distance_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b,
                     const int* __restrict__ la,
                     const int* __restrict__ lb,
                     uint8_t* __restrict__ out, int P, int L) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kBits = 8 * sizeof(Word);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long blocks = (static_cast<long long>(P) + 31) / 32;
  const long long step =
      static_cast<long long>(gridDim.x) * (kEditThreads / 32);
  long long q = static_cast<long long>(blockIdx.x) * (kEditThreads / 32) +
                warp;
  if (q >= blocks) return;   // warp-uniform
  const int blk = edit_block_bytes<Word, W>(L);
  uint8_t* buf = smem + 4 * warp * blk;    // [buffer][a, b]
  const long long total = static_cast<long long>(P) * L;
  // stage block q into buffer s; its lengths into n, m (0 past P)
  auto stage = [&](long long q, int s, int& oa, int& ob, int& n, int& m) {
    const long long p0 = q * 32;
    const long long bytes = min(32LL, P - p0) * L;
    oa = stage_rows(a, p0 * L, bytes, total, buf + 2 * s * blk, lane);
    ob = stage_rows(b, p0 * L, bytes, total, buf + (2 * s + 1) * blk, lane);
    const bool live = p0 + lane < P;
    n = live ? min(max(la[p0 + lane], 0), L) : 0;
    m = live ? min(max(lb[p0 + lane], 0), L) : 0;
  };
  int oa, ob, n, m;
  stage(q, 0, oa, ob, n, m);
  __pipeline_commit();
  for (int s = 0; q < blocks; q += step, s ^= 1) {
    int noa = 0, nob = 0, nn = 0, nm = 0;
    if (q + step < blocks) stage(q + step, s ^ 1, noa, nob, nn, nm);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this block's rows have landed
    __syncwarp();
    const uint8_t* arow = buf + 2 * s * blk + oa + lane * L;
    const uint8_t* brow = buf + (2 * s + 1) * blk + ob + lane * L;
    // words and plane groups past the warp's longest pattern never run
    const int nmax = __reduce_max_sync(kFull, n);
    const int nw = (nmax + kBits - 1) / kBits;
    const int mmax = __reduce_max_sync(kFull, m);
    Word pl[8][W];
    build_planes<Word, W>(pl, nmax, [&](int i) { return smem_word(arow, i); });
    Word pv[W], mv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pv[w] = ~Word(0);
      mv[w] = 0;
    }
    const int mmin = __reduce_min_sync(kFull, q * 32 + lane < P ? m : L);
    bool done = false;
    if constexpr (W == 1 && sizeof(Word) == 4) {
      if (nmax <= 16) {   // collapse's tags: two planes a word
        uint32_t pp[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pp[k] = (pl[2 * k][0] & 0xffffu) | (pl[2 * k + 1][0] << 16);
        text_columns(brow, m, mmin, mmax,
                     [&](const uint32_t (&tk)[8], int j) {
                       myers_word<Word>(mismatch16(pp, tk, j), pv[0], mv[0],
                                        1);
                     });
        done = true;
      }
    }
    if (!done)
      text_columns(brow, m, mmin, mmax, [&](const uint32_t (&tk)[8], int j) {
        uint32_t bits[8];
        text_bits(tk, j, bits);
        myers_column<Word, W>(pl, bits, nw, pv, mv, 1);
      });
    if (q * 32 + lane < P) {
      const int d = m + rows_sum<Word, W>(pv, mv, n);
      out[q * 32 + lane] = static_cast<uint8_t>(d < 255 ? d : 255);
    }
    __syncwarp();   // every lane is done with buffer s before it refills
    oa = noa;
    ob = nob;
    n = nn;
    m = nm;
  }
}

// The same distance for L > kEditBandBytes: one thread a pair reading its
// rows from global memory, the pattern in bands of kEditBandBytes rows
// (four 64-bit words) run one after another over the whole text. The
// horizontal deltas out of a band's top row, one a column, wait for the
// next band in shared memory as two bit vectors (+1, -1) of cw 64-bit
// words a thread, laid out [vector][word][thread].
__global__ void __launch_bounds__(kEditThreads)
edit_distance_bands_kernel(const uint8_t* __restrict__ a,
                           const uint8_t* __restrict__ b,
                           const int* __restrict__ la,
                           const int* __restrict__ lb,
                           uint8_t* __restrict__ out, int P, int L, int cw) {
  extern __shared__ __align__(16) uint64_t hbits[];
  constexpr int W = kEditBandBytes / 64;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int T = blockDim.x;
  uint64_t* hp = hbits + threadIdx.x;
  uint64_t* hn = hp + static_cast<size_t>(cw) * T;
  const uint8_t* arow = a + static_cast<size_t>(p) * L;
  const uint8_t* brow = b + static_cast<size_t>(p) * L;
  const int n = min(max(la[p], 0), L);
  const int m = min(max(lb[p], 0), L);
  const int nb = (n + kEditBandBytes - 1) / kEditBandBytes;
  int d = m;
  for (int band = 0; band < nb; ++band) {
    const int r0 = band * kEditBandBytes;
    const bool last = band + 1 == nb;
    const int nw = min(W, (n - r0 + 63) / 64);
    uint64_t pl[8][W];
    build_planes<uint64_t, W>(pl, n - r0, [&](int i) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r0 + i + k < L) v |= static_cast<uint32_t>(__ldg(arow + r0 + i + k)) << (8 * k);
      return v;
    });
    uint64_t pv[W], mv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pv[w] = ~0ull;
      mv[w] = 0;
    }
    uint64_t in_p = 0, in_n = 0, out_p = 0, out_n = 0;
    for (int j = 0; j < m; ++j) {
      const int q = j >> 6, bit = j & 63;
      if (bit == 0 && band > 0) {
        in_p = hp[static_cast<size_t>(q) * T];
        in_n = hn[static_cast<size_t>(q) * T];
      }
      const int hin = band == 0 ? 1
                                : static_cast<int>((in_p >> bit) & 1) -
                                      static_cast<int>((in_n >> bit) & 1);
      uint32_t tk[8], bits[8];
      text_word(__ldg(brow + j), tk);
      text_bits(tk, 0, bits);
      const int hout = myers_column<uint64_t, W>(pl, bits, nw, pv, mv, hin);
      if (!last) {
        out_p |= static_cast<uint64_t>(hout > 0) << bit;
        out_n |= static_cast<uint64_t>(hout < 0) << bit;
        if (bit == 63 || j + 1 == m) {
          hp[static_cast<size_t>(q) * T] = out_p;
          hn[static_cast<size_t>(q) * T] = out_n;
          out_p = out_n = 0;
        }
      }
    }
    d += rows_sum<uint64_t, W>(pv, mv, n - r0);
  }
  out[p] = static_cast<uint8_t>(d < 255 ? d : 255);
}

template <typename Word, int W>
int launch_edit(const uint8_t* a, const uint8_t* b, const int* la,
                const int* lb, uint8_t* out, int P, int L, cudaStream_t s) {
  // two buffers of a and b rows a warp
  const int smem = 4 * (kEditThreads / 32) * edit_block_bytes<Word, W>(L);
  auto kern = edit_distance_kernel<Word, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // no more CTAs than the card holds at once: each warp streams blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kEditThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (static_cast<long long>(P) + kEditThreads - 1) /
                         kEditThreads;
  const int blocks = static_cast<int>(
      min(need, static_cast<long long>(per_sm) * sms));
  kern<<<blocks, kEditThreads, smem, s>>>(a, b, la, lb, out, P, L);
  return cudaGetLastError();
}

int launch_edit_bands(const uint8_t* a, const uint8_t* b, const int* la,
                      const int* lb, uint8_t* out, int P, int L,
                      cudaStream_t s) {
  const int cw = (L + 63) / 64;
  const long long per_thread = 16LL * cw;
  int threads = kEditThreads;
  while (threads > 1 && threads * per_thread > kSmemLimit) threads /= 2;
  if (threads * per_thread > kSmemLimit) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(threads * per_thread);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edit_distance_bands_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (static_cast<long long>(P) + threads - 1) / threads;
  edit_distance_bands_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                               s>>>(a, b, la, lb, out, P, L, cw);
  return cudaGetLastError();
}

// Whether the Levenshtein distance of two w-byte code strings is at most
// d: the pattern's Peq masks (bit i of peq[c * STRIDE] set iff pattern
// byte i has code c) against the text's codes, TW words of four bytes, by
// the Myers/Hyyro recurrence of distance.py::_edit_distance_myers_host.
// Stops once score + columns done > d + w (no pair can end within d).
template <typename Word, int TW, int STRIDE>
__device__ __forceinline__ bool within_radius(const Word* peq,
                                              const uint32_t (&text)[TW],
                                              int w, int d) {
  constexpr int kBits = 8 * sizeof(Word);
  if (w <= 0) return 0 <= d;
  Word vp = w >= kBits ? ~Word(0) : (Word(1) << w) - Word(1);
  Word vn = 0;
  const Word mbit = Word(1) << (w - 1);
  int score = w;
  const int lim = d + w;
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    if (4 * k >= w) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (4 * k + b < w) {
        const Word pm = peq[((text[k] >> (8 * b)) & 0xffu) * STRIDE];
        const Word d0 = (((pm & vp) + vp) ^ vp) | pm | vn;
        Word hp = vn | ~(d0 | vp);
        Word hn = vp & d0;
        score += (hp & mbit) ? 1 : 0;
        score -= (hn & mbit) ? 1 : 0;
        hp = (hp << 1) | Word(1);
        hn <<= 1;
        vp = hn | ~(d0 | hp);
        vn = hp & d0;
      }
    }
    if (score + min(4 * k + 4, w) > lim) return false;
  }
  return score <= d;
}

// The group of tag t: g with goff[g] <= t < goff[g + 1] (goff [G + 1],
// goff[0] = 0 <= t < goff[G]).
__device__ __forceinline__ int group_of(const int* goff, int G, int t) {
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(goff + mid) <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// Every pair of one group within radius d whose counts pass the ratio
// test. codes [T][TW] words (a tag's class codes, one byte a column),
// sorted by count within each group; cnt [T]; goff [G + 1]; gw [G] widths
// (<= 4 * TW, and <= bits of Word). high [H] are the tags that have a
// partner, in the matrix's order; CTA b (counted from the last) takes
// high[bstart[b] .. bstart[b + 1]), at most kEditHitWarps tags of one
// group, one a warp. Hits (h, j) in the matrix's (sorted) indices.
template <typename Word, int TW>
__global__ void __launch_bounds__(kEditHitWarps * 32)
edit_hits_group_kernel(const uint32_t* __restrict__ codes,
                       const long long* __restrict__ cnt,
                       const int* __restrict__ goff, int G,
                       const int* __restrict__ gw,
                       const int* __restrict__ high,
                       const int* __restrict__ bstart, int NB, int d,
                       double ratio, int K,
                       unsigned long long* __restrict__ count,
                       int2* __restrict__ out, unsigned long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kEditHitTileBytes / (4 * TW);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  Word* peq = reinterpret_cast<Word*>(smem + kEditHitTileBytes) + warp * K;
  // the last blocks hold the highest counts, whose sweeps are longest:
  // they start first
  const int blk = NB - 1 - static_cast<int>(blockIdx.x);
  const int h0 = bstart[blk];
  const int h1 = bstart[blk + 1];
  const int g = group_of(goff, G, high[h0]);
  const int gs = goff[g], ge = goff[g + 1], w = gw[g];
  const bool active = h0 + warp < h1;
  const int h = active ? high[h0 + warp] : 0;
  const long long ch = active ? cnt[h] : 0;
  uint32_t pw[TW];
#pragma unroll
  for (int t = 0; t < TW; ++t)
    pw[t] = active ? codes[static_cast<size_t>(h) * TW + t] : 0u;
  for (int k = lane; k < K; k += 32) {
    Word m = 0;
#pragma unroll
    for (int i = 0; i < 4 * TW; ++i)
      if (i < w && ((pw[i >> 2] >> (8 * (i & 3))) & 0xffu) ==
                       static_cast<uint32_t>(k))
        m |= Word(1) << i;
    peq[k] = m;
  }
  __syncwarp();
  bool going = active;
  for (int t0 = gs; t0 < ge; t0 += kRows) {
    // a barrier too: every warp is done with the last tile
    if (!__syncthreads_or(going)) break;
    const int rows = min(kRows, ge - t0);
    const uint4* src = reinterpret_cast<const uint4*>(
        codes + static_cast<size_t>(t0) * TW);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < rows * (TW / 4); i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (!going) continue;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const int j = t0 + r;
      const long long cj = r < rows ? cnt[j] : 0;
      const bool pass = r < rows && cj < ch &&
                        static_cast<double>(ch) >=
                            ratio * static_cast<double>(cj);
      // partners are a prefix of the sorted group: none here, none later
      if (!__any_sync(kFull, pass)) {
        going = false;
        break;
      }
      bool hit = false;
      if (pass) {
        uint32_t text[TW];
        const uint4* row = reinterpret_cast<const uint4*>(tile + r * TW);
#pragma unroll
        for (int v = 0; v < TW / 4; ++v) {
          const uint4 q = row[v];
          text[4 * v] = q.x;
          text[4 * v + 1] = q.y;
          text[4 * v + 2] = q.z;
          text[4 * v + 3] = q.w;
        }
        hit = within_radius<Word, TW, 1>(peq, text, w, d);
      }
      emit(hit, h, j, count, out, cap);
    }
  }
}

// The pairs the host chose: pairs [P] (a, b) tag indices of one group
// each, one a lane; the same tests. Each lane keeps its pattern's Peq
// masks in shared memory at [warp][code][lane].
template <typename Word, int TW>
__global__ void edit_hits_pairs_kernel(const uint32_t* __restrict__ codes,
                                       const long long* __restrict__ cnt,
                                       const int* __restrict__ goff, int G,
                                       const int* __restrict__ gw,
                                       const int2* __restrict__ pairs, int P,
                                       int d, double ratio, int K,
                                       unsigned long long* __restrict__ count,
                                       int2* __restrict__ out,
                                       unsigned long long cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  Word* peq = reinterpret_cast<Word*>(smem) + (threadIdx.x >> 5) * K * 32 +
              lane;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  int h = 0, j = 0;
  if (p < P) {
    const int2 pr = pairs[p];
    const long long ca = cnt[pr.x], cb = cnt[pr.y];
    h = ca > cb ? pr.x : pr.y;
    j = ca > cb ? pr.y : pr.x;
    const long long hi = ca > cb ? ca : cb;
    const long long lo = ca > cb ? cb : ca;
    if (ca != cb &&
        static_cast<double>(hi) >= ratio * static_cast<double>(lo)) {
      const int w = gw[group_of(goff, G, h)];
      uint32_t pw[TW], text[TW];
      const uint4* hrow = reinterpret_cast<const uint4*>(
          codes + static_cast<size_t>(h) * TW);
      const uint4* jrow = reinterpret_cast<const uint4*>(
          codes + static_cast<size_t>(j) * TW);
#pragma unroll
      for (int v = 0; v < TW / 4; ++v) {
        const uint4 a = __ldg(hrow + v), b = __ldg(jrow + v);
        pw[4 * v] = a.x; pw[4 * v + 1] = a.y;
        pw[4 * v + 2] = a.z; pw[4 * v + 3] = a.w;
        text[4 * v] = b.x; text[4 * v + 1] = b.y;
        text[4 * v + 2] = b.z; text[4 * v + 3] = b.w;
      }
      for (int k = 0; k < K; ++k) peq[k * 32] = 0;
#pragma unroll
      for (int i = 0; i < 4 * TW; ++i)
        if (i < w) peq[((pw[i >> 2] >> (8 * (i & 3))) & 0xffu) * 32] |=
            Word(1) << i;
      hit = within_radius<Word, TW, 32>(peq, text, w, d);
    }
  }
  emit(hit, h, j, count, out, cap);
}

template <typename Word, int TW>
int launch_edit_hits(const uint32_t* codes, const long long* cnt,
                     const int* goff, int G, const int* gw, const int* high,
                     const int* bstart, int NB, const int2* pairs, int P,
                     int K, int d, double ratio, unsigned long long* count,
                     int2* out, unsigned long long cap, cudaStream_t s) {
  if (pairs == nullptr) {
    const int smem = kEditHitTileBytes + kEditHitWarps * K * sizeof(Word);
    auto kern = edit_hits_group_kernel<Word, TW>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<NB, kEditHitWarps * 32, smem, s>>>(codes, cnt, goff, G, gw, high,
                                              bstart, NB, d, ratio, K, count,
                                              out, cap);
  } else {
    const int per_warp = K * 32 * static_cast<int>(sizeof(Word));
    const int warps = max(1, min(kEditHitWarps, kEditHitPairSmem / per_warp));
    const int smem = warps * per_warp;
    auto kern = edit_hits_pairs_kernel<Word, TW>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int threads = 32 * warps;
    kern<<<(P + threads - 1) / threads, threads, smem, s>>>(
        codes, cnt, goff, G, gw, pairs, P, d, ratio, K, count, out, cap);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace clique_tag

// Launch the fused Hamming hit search on `stream`. tag_words / tag_masks
// [U][S] u32 (codes of `bits` bits; the top bit of each live field set in
// the mask), budgets [U] i32 (max_distance minus the tag's bytes no
// allowlist row holds), allow_words [Kp][S] u32 with Kp = K rounded up to
// a multiple of 4 (rows past K zero), count one u64 set to 0, out [cap]
// (u, k) i32 pairs. S is 1, 2, 4, 8 or above 8. Returns the CUDA error of
// the launch.
extern "C" int clique_match_hits(const void* tag_words, const void* tag_masks,
                                 const void* budgets, const void* allow_words,
                                 int U, int K, int S, int bits, void* count,
                                 void* out, long long cap, void* stream) {
  using namespace clique_tag;
  const int Kp = (K + 3) / 4 * 4;
  if (U <= 0 || K <= 0 || S <= 0 || cap < 0 ||
      (S <= kHitTagWords && (S & (S - 1)) != 0))
    return cudaErrorInvalidValue;
  const auto* tw = static_cast<const uint32_t*>(tag_words);
  const auto* tm = static_cast<const uint32_t*>(tag_masks);
  const auto* tr = static_cast<const int*>(budgets);
  const auto* aw = static_cast<const uint32_t*>(allow_words);
  auto* c = static_cast<unsigned long long*>(count);
  auto* o = static_cast<int2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<unsigned long long>(cap);
  switch (bits) {
    case 2: return launch_hits<2>(tw, tm, tr, aw, U, K, Kp, S, c, o, n, s);
    case 4: return launch_hits<4>(tw, tm, tr, aw, U, K, Kp, S, c, o, n, s);
    case 8: return launch_hits<8>(tw, tm, tr, aw, U, K, Kp, S, c, o, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// Four column steps (one text word) of edit_distance's 32-bit kernel and
// nothing else: never launched for work, compiled (with external linkage,
// so that it is kept) so that its SASS gives the operations of a column
// step (chip_smoke.py). The planes, the vertical deltas and the text word
// are loaded from fixed offsets and the deltas stored, so that besides the
// recurrence and the match masks the probe holds loads, stores and moves.
extern "C" __global__ void clique_edit_column_probe(const uint32_t* in,
                                                    uint32_t* out) {
  using namespace clique_tag;
  uint32_t pl[8][1];
#pragma unroll
  for (int k = 0; k < 8; ++k) pl[k][0] = in[k];
  uint32_t pv[1] = {in[8]}, mv[1] = {in[9]};
  uint32_t tk[8];
  text_word(in[10], tk);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t bits[8];
    text_bits(tk, j, bits);
    myers_column<uint32_t, 1>(pl, bits, 1, pv, mv, 1);
  }
  out[0] = pv[0];
  out[1] = mv[0];
}

// The same four column steps for patterns of at most 16 bytes (two planes
// a word, mismatch16), edit_distance's path at collapse's 16 bp tags.
extern "C" __global__ void clique_edit_column_probe16(const uint32_t* in,
                                                      uint32_t* out) {
  using namespace clique_tag;
  uint32_t pp[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pp[q] = in[q];
  uint32_t pv = in[8], mv = in[9];
  uint32_t tk[8];
  text_word(in[10], tk);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    myers_word<uint32_t>(mismatch16(pp, tk, j), pv, mv, 1);
  out[0] = pv;
  out[1] = mv;
}

// Launch the edit distance on `stream`: a, b [P, L] u8, la, lb [P] i32
// (0 <= la, lb <= L, checked by the caller), out [P] u8. Rows of up to 32
// bytes take one 32-bit word, up to 256 one to four 64-bit words, wider
// rows bands of 256. Returns the CUDA error of the launch.
extern "C" int clique_edit_distance(const void* a, const void* b,
                                    const void* la, const void* lb,
                                    void* out, int P, int L, void* stream) {
  using namespace clique_tag;
  if (P <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int* pla = static_cast<const int*>(la);
  const int* plb = static_cast<const int*>(lb);
  uint8_t* po = static_cast<uint8_t*>(out);
  if (L <= 32) return launch_edit<uint32_t, 1>(pa, pb, pla, plb, po, P, L, s);
  if (L <= 64)
    return launch_edit<unsigned long long, 1>(pa, pb, pla, plb, po, P, L, s);
  if (L <= 128)
    return launch_edit<unsigned long long, 2>(pa, pb, pla, plb, po, P, L, s);
  if (L <= 192)
    return launch_edit<unsigned long long, 3>(pa, pb, pla, plb, po, P, L, s);
  if (L <= kEditBandBytes)
    return launch_edit<unsigned long long, 4>(pa, pb, pla, plb, po, P, L, s);
  return launch_edit_bands(pa, pb, pla, plb, po, P, L, s);
}

// Patterns a CTA of the group mode of clique_edit_hits takes (the block
// size of its high-tag list).
extern "C" int clique_edit_hits_warps() { return clique_tag::kEditHitWarps; }

// Launch the edit-hit search on `stream`. codes [T][words] u32: each
// tag's class codes, one byte a column (words 4, 8 or 16: tags of up to
// 16, 32 or 64 bytes), every code below K (1 <= K <= 256); counts [T]
// i64; offsets [G + 1] i32 (0 = offsets[0] <= ... <= offsets[G] = T);
// widths [G] i32 (at most 4 * words and 64). With pairs null (group mode)
// the tags are sorted by count within each group, high [H] i32 holds the
// tags with a partner and bstart [NB + 1] i32 cuts it into blocks of at
// most clique_edit_hits_warps() tags of one group. Otherwise pairs [P]
// (a, b) i32 are the pairs to test, both of one group. count one u64 set
// to 0, out [cap] (h, j) i32 pairs. Returns the CUDA error of the launch.
extern "C" int clique_edit_hits(const void* codes, const void* counts,
                                const void* offsets, int G,
                                const void* widths, const void* high,
                                const void* bstart, int NB, const void* pairs,
                                int P, int words, int K, int max_distance,
                                double ratio, void* count, void* out,
                                long long cap, void* stream) {
  using namespace clique_tag;
  if (G <= 0 || K < 1 || K > 256 || cap < 0 ||
      (pairs == nullptr ? NB <= 0 : P <= 0))
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const uint32_t*>(codes);
  const auto* n = static_cast<const long long*>(counts);
  const auto* go = static_cast<const int*>(offsets);
  const auto* gw = static_cast<const int*>(widths);
  const auto* hi = static_cast<const int*>(high);
  const auto* bs = static_cast<const int*>(bstart);
  const auto* pr = static_cast<const int2*>(pairs);
  auto* cnt = static_cast<unsigned long long*>(count);
  auto* o = static_cast<int2*>(out);
  const auto cp = static_cast<unsigned long long>(cap);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 4:
      return launch_edit_hits<uint32_t, 4>(c, n, go, G, gw, hi, bs, NB, pr, P,
                                           K, max_distance, ratio, cnt, o, cp,
                                           s);
    case 8:
      return launch_edit_hits<uint32_t, 8>(c, n, go, G, gw, hi, bs, NB, pr, P,
                                           K, max_distance, ratio, cnt, o, cp,
                                           s);
    case 16:
      return launch_edit_hits<unsigned long long, 16>(
          c, n, go, G, gw, hi, bs, NB, pr, P, K, max_distance, ratio, cnt, o,
          cp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
