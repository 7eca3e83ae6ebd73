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
// two-way log-sum-exps, 7 expf and 3 logf, all of them precise (no fast
// math): about 10 MUFU instructions and on the order of 100 FP32-pipe
// instructions a cell (chip_smoke.py reads the counts from this file's
// SASS through clique_hmm_cell_probe). The inputs are a few hundred bytes
// a pair against ~6 x 10^4 cells, so it is compute-bound, by the FP32
// pipe before the MUFU.
//
// What the design does about it (dp_align.cu's structure):
// - One warp a pair, kWarpsPerCta warps a CTA, no CTA barrier. Lane k owns
//   a strip of kStripRows = 12 consecutive DP rows (reference positions)
//   and keeps the strip's M, I and D for the current column, its reference
//   bytes and their wildcard bits in registers.
// - The warp sweeps the read's columns in a wavefront: at step t lane k
//   computes column y = t - k + 1, top to bottom. The row above its strip
//   at column y is lane k - 1's last row, handed over by __shfl_up_sync
//   one step after lane k - 1 computed it; the diagonal is that row at the
//   previous step. There is no traceback: three floats a cell in
//   registers, and the corner's lane writes the pair's value once.
// - More than 32 * 12 = 384 rows: the warp runs row bands of 384 one after
//   another, each handing its last row (M, D, I a column) to the next
//   through a per-pair global scratch that stays in L2.
// - Only columns 1..l2 and the strips holding rows <= l1 are computed;
//   the borders come from their closed form (D[x,0] = lgo + (x-1) lge,
//   I[0,y] = lgo + (y-1) lge, M[0,0] = 0, NEG elsewhere).
//
// Numerics: the build passes --fmad=false and this file uses the precise
// expf / logf; every LSE takes the JAX package's order (the max, the
// exps summed left to right, the log), so the kernel differs from the
// plain version only by the 1-2 ulp of CUDA's expf and logf. NEG = -1e30
// arithmetic rounds back to NEG (NEG + log 3 == NEG in f32), as in JAX.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_common.cuh"

namespace clique_hmm {

using clique_dp::kBandRows;
using clique_dp::kFull;
using clique_dp::kStripRows;

constexpr int kWarpsPerCta = 4;
constexpr float kNeg = -1e30f;

// lm, lx, lw: log emissions (match, mismatch, wildcard); lgo, lge: gap
// open / extend; t_mm = log1p(-2 exp(lgo)), t_gc = log1p(-exp(lge))
struct Terms {
  float lm, lx, lw, lgo, lge, t_mm, t_gc;
};

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(expf(a - m) + expf(b - m));
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

namespace {

__global__ void __launch_bounds__(kWarpsPerCta * 32)
hmm_forward_kernel(const uint8_t* refs, int ref_stride, const uint8_t* reads,
                   int read_stride, const int* ref_lens, const int* read_lens,
                   const Terms t, float* scratch, float* out, int B, int n1,
                   int n2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerCta + warp;
  if (b >= B) return;                  // whole warps only: no CTA barrier
  const int l1 = ref_lens[b];
  const int l2 = read_lens[b];
  if (l1 < 0 || l1 > n1 - 1 || l2 < 0 || l2 > n2 - 1) {
    if (lane == 0) out[b] = nanf("");  // lengths outside the rows
    return;
  }
  if (l1 == 0 || l2 == 0) {
    // the corner is a border cell (or the origin)
    if (lane == 0) {
      const float cm = (l1 == 0 && l2 == 0) ? 0.0f : kNeg;
      const float ci = l2 > 0 ? border(t, l2) : kNeg;
      const float cd = l1 > 0 ? border(t, l1) : kNeg;
      out[b] = lse3(cm, ci, cd);
    }
    return;
  }
  const uint8_t* ref = refs + static_cast<size_t>(b) * ref_stride;
  const uint8_t* read = reads + static_cast<size_t>(b) * read_stride;
  float* scr = scratch != nullptr
                   ? scratch + static_cast<size_t>(b) * 6 * n2
                   : nullptr;
  const int nbands = (l1 + kBandRows - 1) / kBandRows;
  for (int band = 0; band < nbands; ++band) {
    const int x0 = band * kBandRows + lane * kStripRows + 1;
    const bool active = x0 <= l1;
    // lanes of this band that hold a row <= l1
    const int nact =
        min(32, (l1 - band * kBandRows + kStripRows - 1) / kStripRows);
    float M[kStripRows], I[kStripRows], D[kStripRows];
    int rb[kStripRows];
    uint32_t rwild = 0;        // bit r: row r's reference byte is a wildcard
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      const int x = x0 + r;
      const bool real = x <= l1;
      rb[r] = real ? static_cast<int>(ref[x - 1]) : 0;
      rwild |= static_cast<uint32_t>(real && (rb[r] == 78 || rb[r] < 58))
               << r;
      // column 0: only D is a border there
      M[r] = kNeg;
      I[r] = kNeg;
      D[r] = real ? border(t, x) : kNeg;
    }
    // the row above the strip at the previous column (the diagonal inputs
    // of the strip's first row): column 0 to begin with
    float um = x0 == 1 ? 0.0f : kNeg;
    float ui = kNeg;
    float ud = x0 == 1 ? kNeg : border(t, x0 - 1);
    const float* scr_in =
        scr != nullptr ? scr + ((band + 1) & 1) * 3 * n2 : nullptr;
    float* scr_out = scr != nullptr ? scr + (band & 1) * 3 * n2 : nullptr;
    const bool hand_on = lane == 31 && band + 1 < nbands;

    const int steps = l2 + nact - 1;
    int ry_next = (active && lane == 0) ? read[0] : 0;
    for (int s = 0; s < steps; ++s) {
      const int y = s - lane + 1;
      // the row above the strip at column y: lane k - 1's last row,
      // computed at the previous step; lane 0 takes row 0 (the I border)
      // or the previous band's last row
      float vm = __shfl_up_sync(kFull, M[kStripRows - 1], 1);
      float vi = __shfl_up_sync(kFull, I[kStripRows - 1], 1);
      float vd = __shfl_up_sync(kFull, D[kStripRows - 1], 1);
      const bool in = active && y >= 1 && y <= l2;
      const int ry = ry_next;
      if (active && y + 1 >= 1 && y + 1 <= l2) ry_next = read[y];
      if (!in) continue;
      if (lane == 0) {
        if (band == 0) {
          vm = kNeg;
          vi = border(t, y);
          vd = kNeg;
        } else {
          vm = __ldcg(scr_in + 3 * y);
          vd = __ldcg(scr_in + 3 * y + 1);
          vi = __ldcg(scr_in + 3 * y + 2);
        }
      }
      // an N read base emits the wildcard probability whatever the row
      const float e_eq = ry == 78 ? t.lw : t.lm;
      const float e_ne = ry == 78 ? t.lw : t.lx;
      float dm = um, di = ui, dd = ud;   // (x - 1, y - 1) of row x0
      float pm = vm, pd = vd;            // (x - 1, y) of row x0
#pragma unroll
      for (int r = 0; r < kStripRows; ++r) {
        const float lm_ = M[r], li = I[r], ld = D[r];   // (x, y - 1)
        const float e =
            ((rwild >> r) & 1u) ? t.lw : (rb[r] == ry ? e_eq : e_ne);
        float nm, ni, nd;
        cell(t, e, dm, di, dd, pm, pd, lm_, li, &nm, &ni, &nd);
        if (y == l2 && x0 + r == l1) out[b] = lse3(nm, ni, nd);
        M[r] = nm;
        I[r] = ni;
        D[r] = nd;
        dm = lm_;
        di = li;
        dd = ld;
        pm = nm;
        pd = nd;
      }
      if (hand_on) {
        __stcg(scr_out + 3 * y, M[kStripRows - 1]);
        __stcg(scr_out + 3 * y + 1, D[kStripRows - 1]);
        __stcg(scr_out + 3 * y + 2, I[kStripRows - 1]);
      }
      um = vm;
      ui = vi;
      ud = vd;
    }
    __syncwarp();              // the hand-on row is visible to the next band
  }
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

// Floats of row-band scratch one pair needs: 2 * 3 * n2 when the rows
// exceed one warp's band (n1 - 1 > 384), else 0.
extern "C" long long clique_hmm_forward_scratch_floats(int n1, int n2) {
  return n1 - 1 > clique_dp::kBandRows ? 6LL * n2 : 0;
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
  const int blocks = (B + kWarpsPerCta - 1) / kWarpsPerCta;
  hmm_forward_kernel<<<blocks, kWarpsPerCta * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(refs), ref_stride,
      static_cast<const uint8_t*>(reads), read_stride,
      static_cast<const int*>(ref_lens), static_cast<const int*>(read_lens), t,
      static_cast<float*>(scratch), static_cast<float*>(out), B, n1, n2);
  return cudaGetLastError();
}
