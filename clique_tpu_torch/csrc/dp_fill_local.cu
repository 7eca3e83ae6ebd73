// Waterman-Eggert (local) 3-plane affine DP fill for Hopper (sm_90a).
//
// Replaces: the local branch of clique_tpu/align/batch.py::
// align_batch_device (:221-374, local=True): the m plane floored at 0
// (max(0, diag + ms, ms)), the gap planes extended with the unscaled gap
// extension, the per-plane zero flags of every cell's output value and the
// running 3D argmax. The kernel and its design are in dp_fill.cuh; this
// file launches it.

#include "dp_fill.cuh"

// Bytes of ring one CTA keeps in global memory: 0 when the ring fits in
// shared memory, else 36 * n1 (the caller allocates B times that).
extern "C" int clique_dp_fill_ring_bytes(int n1, int n2) {
  return clique_dp::fill_ring_bytes(n1, n2);
}

// Dynamic shared memory one fill CTA needs (the ring when it is there, and
// the read bytes).
extern "C" int clique_dp_fill_smem_bytes(int n1, int n2) {
  return clique_dp::fill_smem_bytes(n1, n2);
}

// Launch the local fill on `stream`: the full band, tie order
// up > left > diag. refs [R, ref_stride] u8 with R == 1 (uniform reference,
// ref_stride passed as 0) or R == B; reads [B, read_stride] u8; lens [B]
// i32; params [6] f32 (match, mismatch, special, gap_open, gap_extend,
// final_gap_multiplier); ring [B, 9 * n1] f32 when
// clique_dp_fill_ring_bytes is not 0, else null; special: 0 none,
// 1 ref_n_only, 2 both. Outputs tb and zflags [B, n1 + n2 - 1, n1] u8 (bit z of a
// zero-flag byte set where plane z holds 0.0), best [B, 4] f32 (the argmax
// value, then the M/D/I values at the argmax cell) and best_xd [B, 2] i32
// (its x and its diagonal). Returns the CUDA error of the launch (0 on
// success).
extern "C" int clique_dp_fill_local(const void* refs, int ref_stride,
                                    const void* reads, int read_stride,
                                    const void* ref_lens,
                                    const void* read_lens,
                                    const void* params, void* tb,
                                    void* zflags, void* best, void* best_xd,
                                    void* ring, int B, int n1, int n2,
                                    int special, void* stream) {
  using namespace clique_dp;
  FillArgs a{};
  a.refs = static_cast<const uint8_t*>(refs);
  a.ref_stride = ref_stride;
  a.reads = static_cast<const uint8_t*>(reads);
  a.read_stride = read_stride;
  a.ref_lens = static_cast<const int*>(ref_lens);
  a.read_lens = static_cast<const int*>(read_lens);
  a.params = static_cast<const float*>(params);
  a.tb = static_cast<uint8_t*>(tb);
  a.zflags = static_cast<uint8_t*>(zflags);
  a.best = static_cast<float*>(best);
  a.best_xd = static_cast<int*>(best_xd);
  a.ring = static_cast<float*>(ring);
  a.n1 = n1;
  a.n2 = n2;
  a.special = special;
  return launch_fill(a, B, stream);
}
