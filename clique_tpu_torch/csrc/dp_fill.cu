// Global 3-plane affine DP fill for Hopper (sm_90a): the full band or a
// partial band, tie order up > left > diag or keep-last, the special-byte
// rules "both", "ref_n_only" and "none". The kernel, what it replaces and
// its design are in dp_fill.cuh.

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

// Launch the global fill on `stream`. refs [R, ref_stride] u8 with R == 1
// (uniform reference, ref_stride passed as 0) or R == B; reads
// [B, read_stride] u8; lens [B] i32; params [6] f32 (match, mismatch,
// special, gap_open, gap_extend, final_gap_multiplier); bandwidth [B] i32
// and centers [B, n1] i32 for a partial band, both null for the full band;
// ring [B, 9 * n1] f32 when clique_dp_fill_ring_bytes is not 0, else null.
// special: 0 none, 1 ref_n_only, 2 both; tie_last: 0 up > left > diag,
// 1 keep-last. Outputs tb [B, n1 + n2 - 1, n1] u8 and corner [B, 3] f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int clique_dp_fill(const void* refs, int ref_stride,
                              const void* reads, int read_stride,
                              const void* ref_lens, const void* read_lens,
                              const void* params, const void* bandwidth,
                              const void* centers, void* tb, void* corner,
                              void* ring, int B, int n1, int n2, int special,
                              int tie_last, void* stream) {
  using namespace clique_dp;
  FillArgs a{};
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
  a.corner = static_cast<float*>(corner);
  a.ring = static_cast<float*>(ring);
  a.n1 = n1;
  a.n2 = n2;
  a.special = special;
  return tie_last ? launch_fill<false, true>(a, B, stream)
                  : launch_fill<false, false>(a, B, stream);
}
