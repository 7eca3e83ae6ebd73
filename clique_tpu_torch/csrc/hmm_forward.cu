// Pair-HMM forward log-likelihood of a batch of (reference, read) pairs,
// for Hopper (sm_90a): the 3-state (M, I, D) recurrence in log space, one
// value a pair at its (l1, l2) corner.
//
// Replaces: clique_tpu/align/hmm.py::hmm_forward_batch (:39-134), an XLA
// lax.scan over anti-diagonals that HmmRouter runs on every (read, panel
// reference) pair. The plain version is
// align/hmm.py::hmm_forward_batch_reference.
//
// What bounds it on an H100: each cell evaluates one three-way and two
// two-way log-sum-exps with the precise expf / logf (no fast math). The
// exp of an LSE's own maximum is expf(0) == 1.0f exactly, so it is not
// computed: a cell takes 4 expf (4 MUFU) and 3 logf, 113 FP32-pipe
// instructions on an H100 build, 9 of them the compares, selects and
// minima that find the maximum's slot (chip_smoke.py reads the counts
// from this file's SASS through clique_hmm_cell_probe and, without that
// selection, clique_hmm_cell_floor_probe). The inputs are a few hundred
// bytes a pair against ~5 x 10^4 cells, so it is compute-bound, by the
// FP32 pipe.
// What keeps a kernel from that bound is lanes that compute no useful cell,
// and the serial chain of a strip (each row's D is an LSE of the row above
// it), which only other warps and the independent M and I work of the
// strip's rows can hide.
//
// What the design does about it:
// - One warp a stream of pairs, kWarpsPerCta warps a CTA, no CTA barrier.
//   Lane k owns a strip of R consecutive DP rows (reference positions) and
//   keeps the strip's M, I and D for the current column, its reference
//   bytes (packed four to a word) and their wildcard bits in registers.
// - R follows the launch's rows (strip_rows): 8 or 12, whichever pads
//   n1 - 1 to fewer 32-lane bands of rows, 8 at a tie. A 230-row panel
//   reference fills 29 of the 32 lanes at R = 8 (20 at R = 12, 1.46 times
//   slower); 320-350-row references take one band at R = 12 and two at 8,
//   where R = 12 is 1.35 times faster, and 1,070-1,100 rows three bands
//   against five, 1.11 times faster (profile_port.py hmm on an H100).
// - The warp sweeps a pair's columns in a wavefront: at step t lane k
//   computes column y = t - k + 1, top to bottom. The row above its strip
//   at column y is lane k - 1's last row, handed down by __shfl_up_sync one
//   step after lane k - 1 computed it, and so is the read byte of column y
//   (lane 0 loads it); the diagonal is that row at the previous step.
// - No drain between pairs: the warp's work is a sequence of items (a pair,
//   or a row band of one), and every lane runs the same sequence k steps
//   behind lane 0, so lane 0 starts the next item on the step after the
//   last column of this one while the lanes below finish it. Only the
//   first item of a warp ramps up. The grid is as many CTAs as fit on the
//   card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each warp
//   taking every (warps in the grid)-th pair.
// - __launch_bounds__(kThreads, min_ctas(R)): 6 CTAs (24 warps) an SM at
//   R = 8 (80 registers), 5 (20 warps, 96 registers) at R = 12, so that
//   the other warps hide the strip's chain; neither spills. Squeezing R = 8
//   to 7 or 8 CTAs (72 or 64 registers) ran slower on an H100: the
//   unrolled strip needs the registers to overlap its rows' independent
//   M and I work with the D chain.
// - More than 32 * R rows: the pair's row bands run one after another as
//   items, each handing its last row (M, D, I a column) to the next through
//   a per-pair global scratch that stays in L2; a band that hands on takes
//   at least 32 steps, so its lane 31 has stored a column before the next
//   band's lane 0 loads it (a __syncwarp a step orders the two).
// - Only columns 1..l2 and the strips holding rows <= l1 are computed; the
//   borders come from their closed form (D[x,0] = lgo + (x-1) lge,
//   I[0,y] = lgo + (y-1) lge, M[0,0] = 0, NEG elsewhere). The corner's lane
//   picks its row once a pair, outside the row loop.
//
// Numerics: the build passes --fmad=false and this file uses the precise
// expf / logf; every LSE takes the JAX package's order (the max, the
// exps summed left to right, the log), with 1.0f in the maximum's slot,
// which is the value expf(0) gives, so the kernel equals the plain version
// whenever the card's expf / logf equal PyTorch's. NEG = -1e30 arithmetic
// rounds back to NEG (NEG + log 3 == NEG in f32), as in JAX.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace clique_hmm {

constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

// DP rows a lane owns in a launch of n1 - 1 reference rows: 8 or 12,
// whichever pads the rows to fewer 32-lane bands, 8 at a tie
__host__ __device__ inline int strip_rows(int n1) {
  const int rows = n1 - 1;
  return (rows + 255) / 256 * 256 <= (rows + 383) / 384 * 384 ? 8 : 12;
}

// the CTAs an SM that __launch_bounds__ asks ptxas to fit at strip height R
__host__ __device__ constexpr int min_ctas(int rows) {
  return rows <= 8 ? 6 : 5;
}

// lm, lx, lw: log emissions (match, mismatch, wildcard); lgo, lge: gap
// open / extend; t_mm = log1p(-2 exp(lgo)), t_gc = log1p(-exp(lge))
struct Terms {
  float lm, lx, lw, lgo, lge, t_mm, t_gc;
};

// m + log(exp(a - m) + exp(b - m) + exp(c - m)), summed left to right,
// with the maximum's exp as 1.0f: (ea + eb) + 1 when c is the maximum,
// else (1 + x) + y with x, y the other two in order (1 + x == x + 1)
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  const bool cmax = c == m;
  const float eu = expf((cmax || a != m ? a : b) - m);
  const float ev = expf((cmax ? b : c) - m);
  return m + logf(((cmax ? eu : 1.0f) + (cmax ? ev : eu)) +
                  (cmax ? 1.0f : ev));
}

// m + log(exp(a - m) + exp(b - m)): one of the two is 1.0f
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(1.0f + expf(fminf(a, b) - m));
}

// the gap border lgo + (k - 1) lge of row or column k >= 1, as one fused
// multiply-add: XLA contracts it so on the CPU, and the plain version
// rounds it so
__device__ __forceinline__ float border(const Terms& t, int k) {
  return __fmaf_rn(static_cast<float>(k) - 1.0f, t.lge, t.lgo);
}

// One cell from its emission e, diagonal (dm, di, dd), up (pm, pd) and
// left (lm_, li) neighbours (hmm.py:98-102)
__device__ __forceinline__ void cell(const Terms& t, float e, float dm,
                                     float di, float dd, float pm, float pd,
                                     float lm_, float li, float* m, float* i,
                                     float* d) {
  *m = e + lse3(dm + t.t_mm, di + t.t_gc, dd + t.t_gc);
  *d = lse2(pm + t.lgo, pd + t.lge);
  *i = lse2(lm_ + t.lgo, li + t.lge);
}

// The value of a pair with no interior cell: NaN for lengths outside the
// rows, else the corner as a border cell (or the origin)
__device__ inline float edge_value(const Terms& t, int l1, int l2, int n1,
                                   int n2) {
  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) return nanf("");
  const float cm = (l1 == 0 && l2 == 0) ? 0.0f : kNeg;
  const float ci = l2 > 0 ? border(t, l2) : kNeg;
  const float cd = l1 > 0 ? border(t, l1) : kNeg;
  return lse3(cm, ci, cd);
}

namespace {

template <int R>
__global__ void __launch_bounds__(kThreads, min_ctas(R))
hmm_forward_kernel(const uint8_t* __restrict__ refs, int ref_stride,
                   const uint8_t* __restrict__ reads, int read_stride,
                   const int* __restrict__ ref_lens,
                   const int* __restrict__ read_lens, const Terms t,
                   float* scratch, float* out, int B, int n1, int n2) {
  constexpr int kBand = 32 * R;      // rows a warp covers at once
  constexpr int kWords = R / 4;      // packed reference bytes of a strip
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kWarpsPerCta;
  // this lane's place in the warp's sequence of items: pair b, row band
  // `band` of nbands, column y of ncols; lane k starts k steps late
  int b = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5) - nwarps;
  int l1 = 0, l2 = 0, band = 0, nbands = 0, ncols = 0, x0 = 0;
  int y = -lane;
  bool done = false, active = false;
  float M[R], I[R], D[R];
  uint32_t rw[kWords];
  uint32_t rwild = 0;        // bit r: row r's reference byte is a wildcard
#pragma unroll
  for (int r = 0; r < R; ++r) {
    M[r] = kNeg;
    I[r] = kNeg;
    D[r] = kNeg;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) rw[w] = 0;
  // the row above the strip at the previous column (the diagonal inputs of
  // the strip's first row)
  float um = kNeg, ui = kNeg, ud = kNeg;
  int ry = 0;                // the read byte of this lane's column
  int ry_next = 0;           // lane 0: the next column's, loaded ahead
  const uint8_t* read = reads;
  float* scr = nullptr;

  for (;;) {
    // the row above the strip at column y and column y's read byte: lane
    // k - 1's, from the previous step (taken before this lane moves on to
    // a new item, whose state replaces the one lane k + 1 still needs)
    float vm = __shfl_up_sync(kFull, M[R - 1], 1);
    float vi = __shfl_up_sync(kFull, I[R - 1], 1);
    float vd = __shfl_up_sync(kFull, D[R - 1], 1);
    const int ry_up = __shfl_up_sync(kFull, ry, 1);
    if (++y > ncols && !done) {
      // the next item: the pair's next band, or the warp's next pair with
      // an interior cell (lane 0 writes the value of those without)
      if (band + 1 < nbands) {
        ++band;
      } else {
        for (;;) {
          b += nwarps;
          if (b >= B) {
            done = true;
            break;
          }
          l1 = ref_lens[b];
          l2 = read_lens[b];
          if (l1 >= 1 && l1 <= n1 - 1 && l2 >= 1 && l2 <= n2 - 1) break;
          if (lane == 0) out[b] = edge_value(t, l1, l2, n1, n2);
        }
        band = 0;
        nbands = (l1 + kBand - 1) / kBand;
        read = reads + static_cast<size_t>(b) * read_stride;
        if (scratch != nullptr)
          scr = scratch + static_cast<size_t>(b) * 6 * n2;
      }
      active = false;
      if (!done) {
        ncols = band + 1 < nbands ? max(l2, 32) : l2;
        y = 1;
        x0 = band * kBand + lane * R + 1;
        active = x0 <= l1;
        const uint8_t* ref = refs + static_cast<size_t>(b) * ref_stride;
        rwild = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) rw[w] = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int x = x0 + r;
          const bool real = x <= l1;
          const uint32_t rb = real ? ref[x - 1] : 0u;
          rw[r >> 2] |= rb << (8 * (r & 3));
          rwild |= static_cast<uint32_t>(real && (rb == 78 || rb < 58)) << r;
          // column 0: only D is a border there
          M[r] = kNeg;
          I[r] = kNeg;
          D[r] = real ? border(t, x) : kNeg;
        }
        um = x0 == 1 ? 0.0f : kNeg;
        ui = kNeg;
        ud = x0 == 1 ? kNeg : border(t, x0 - 1);
        if (lane == 0) ry_next = read[0];
      }
    }
    if (__all_sync(kFull, done)) break;

    const bool in = active && y >= 1 && y <= l2;
    if (lane == 0) {
      ry = ry_next;
      if (in) {
        // row 0 (the I border), or the previous band's last row
        if (band == 0) {
          vm = kNeg;
          vi = border(t, y);
          vd = kNeg;
        } else {
          const float* scr_in = scr + ((band + 1) & 1) * 3 * n2 + 3 * y;
          vm = __ldcg(scr_in);
          vd = __ldcg(scr_in + 1);
          vi = __ldcg(scr_in + 2);
        }
      }
    } else {
      ry = ry_up;
    }
    if (in) {
      // an N read base emits the wildcard probability whatever the row
      const float e_eq = ry == 78 ? t.lw : t.lm;
      const float e_ne = ry == 78 ? t.lw : t.lx;
      const uint32_t ry4 = static_cast<uint32_t>(ry) * 0x01010101u;
      uint32_t eq[kWords];       // 0xff in each byte equal to the read's
#pragma unroll
      for (int w = 0; w < kWords; ++w) eq[w] = __vcmpeq4(rw[w], ry4);
      float dm = um, di = ui, dd = ud;   // (x - 1, y - 1) of row x0
      float pm = vm, pd = vd;            // (x - 1, y) of row x0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float lm_ = M[r], li = I[r], ld = D[r];   // (x, y - 1)
        const bool same = (eq[r >> 2] >> (8 * (r & 3))) & 1u;
        const float e = ((rwild >> r) & 1u) ? t.lw : (same ? e_eq : e_ne);
        float nm, ni, nd;
        cell(t, e, dm, di, dd, pm, pd, lm_, li, &nm, &ni, &nd);
        M[r] = nm;
        I[r] = ni;
        D[r] = nd;
        dm = lm_;
        di = li;
        dd = ld;
        pm = nm;
        pd = nd;
      }
      if (y == l2) {
        const int cr = l1 - x0;    // the corner's row in this strip
        if (cr >= 0 && cr < R) {
          float cm = M[0], ci = I[0], cd = D[0];
#pragma unroll
          for (int r = 1; r < R; ++r) {
            if (r == cr) {
              cm = M[r];
              ci = I[r];
              cd = D[r];
            }
          }
          out[b] = lse3(cm, ci, cd);
        }
      }
      if (lane == 31 && band + 1 < nbands) {
        float* scr_out = scr + (band & 1) * 3 * n2 + 3 * y;
        __stcg(scr_out, M[R - 1]);
        __stcg(scr_out + 1, D[R - 1]);
        __stcg(scr_out + 2, I[R - 1]);
      }
    }
    um = vm;
    ui = vi;
    ud = vd;
    if (lane == 0 && !done && y < l2) ry_next = read[y];
    __syncwarp();              // a hand-on store before the loads after it
  }
}

template <int R>
int launch(const uint8_t* refs, int ref_stride, const uint8_t* reads,
           int read_stride, const int* ref_lens, const int* read_lens,
           const Terms& t, float* scratch, float* out, int B, int n1, int n2,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hmm_forward_kernel<R>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long want = (static_cast<long long>(B) + kWarpsPerCta - 1) /
                         kWarpsPerCta;
  const int blocks = static_cast<int>(
      want < 1LL * sms * per_sm ? want : 1LL * sms * per_sm);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  hmm_forward_kernel<R><<<blocks, kThreads, 0, stream>>>(
      refs, ref_stride, reads, read_stride, ref_lens, read_lens, t, scratch,
      out, B, n1, n2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clique_hmm

// One cell and nothing else: never launched for work, compiled (with
// external linkage, so that it is kept) so that its SASS gives the MUFU and
// FP32-pipe instructions of a cell (chip_smoke.py)
extern "C" __global__ void clique_hmm_cell_probe(const float* in,
                                                 const clique_hmm::Terms t,
                                                 float* out) {
  float m, i, d;
  clique_hmm::cell(t, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                   &m, &i, &d);
  out[0] = m;
  out[1] = i;
  out[2] = d;
}

// A floor on a cell's instructions, for the bound only (never launched, and
// not the function): the cell with each LSE's maximum known to be its last
// operand, so that no compare or select picks the slot of the 1.0f. It
// keeps the 4 expf, the 3 logf, the maxes and the adds.
extern "C" __global__ void clique_hmm_cell_floor_probe(
    const float* in, const clique_hmm::Terms t, float* out) {
  const float a = in[1] + t.t_mm, b = in[2] + t.t_gc, c = in[3] + t.t_gc;
  const float m3 = fmaxf(a, fmaxf(b, c));
  out[0] = in[0] + (m3 + logf((expf(a - m3) + expf(b - m3)) + 1.0f));
  const float pa = in[4] + t.lgo, pb = in[5] + t.lge;
  const float m2 = fmaxf(pa, pb);
  out[2] = m2 + logf(1.0f + expf(pa - m2));
  const float la = in[6] + t.lgo, lb = in[7] + t.lge;
  const float m1 = fmaxf(la, lb);
  out[1] = m1 + logf(1.0f + expf(la - m1));
}

// DP rows a lane owns in a launch of n1 - 1 reference rows (8 or 12)
extern "C" int clique_hmm_forward_strip_rows(int n1) {
  return clique_hmm::strip_rows(n1);
}

// Floats of row-band scratch one pair needs: 2 * 3 * n2 when the rows
// exceed one warp's band (n1 - 1 > 32 * strip_rows(n1)), else 0.
extern "C" long long clique_hmm_forward_scratch_floats(int n1, int n2) {
  return n1 - 1 > 32 * clique_hmm::strip_rows(n1) ? 6LL * n2 : 0;
}

// Launch the forward recurrence on `stream`. refs [B, ref_stride] u8 and
// reads [B, read_stride] u8, row-padded, with n1 - 1 <= ref_stride and
// n2 - 1 <= read_stride; lens [B] i32; the seven terms of hmm.py's
// hmm_terms by value; scratch [B, clique_hmm_forward_scratch_floats] f32
// when that is not 0, else null; out [B] f32 (NaN for a pair whose lengths
// lie outside the rows). Returns the CUDA error of the launch.
extern "C" int clique_hmm_forward(const void* refs, int ref_stride,
                                  const void* reads, int read_stride,
                                  const void* ref_lens, const void* read_lens,
                                  float lm, float lx, float lw, float lgo,
                                  float lge, float t_mm, float t_gc,
                                  void* scratch, void* out, int B, int n1,
                                  int n2, void* stream) {
  using namespace clique_hmm;
  if (B <= 0 || n1 < 1 || n2 < 1 || ref_stride < n1 - 1 ||
      read_stride < n2 - 1)
    return cudaErrorInvalidValue;
  if ((clique_hmm_forward_scratch_floats(n1, n2) != 0) != (scratch != nullptr))
    return cudaErrorInvalidValue;
  const Terms t{lm, lx, lw, lgo, lge, t_mm, t_gc};
  const auto* rf = static_cast<const uint8_t*>(refs);
  const auto* rd = static_cast<const uint8_t*>(reads);
  const auto* ll1 = static_cast<const int*>(ref_lens);
  const auto* ll2 = static_cast<const int*>(read_lens);
  auto* scr = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return strip_rows(n1) == 8
             ? launch<8>(rf, ref_stride, rd, read_stride, ll1, ll2, t, scr, o,
                         B, n1, n2, s)
             : launch<12>(rf, ref_stride, rd, read_stride, ll1, ll2, t, scr,
                          o, B, n1, n2, s);
}
