"""Wavefront (WFA) kernels on PyTorch + CUDA: the gap-affine and dual-affine
("convex") wavefront fills with and without an op store, and the backtrace
walk over that store.

Counterpart of the device functions of clique_tpu/align/wavefront.py that
`align --engine wfa|convex` runs:

- `wfa_align` replaces wfa_affine_tb_batch (:726) and
  wfa_affine2p_tb_batch (:878), and wfa_walk_device (:1156) fused after
  them: per pair the penalty, the [smax+1, B, K] u8 op store and the
  walk's forward op skeleton with its end row; and after the walk, the
  CIGAR the host helper wfa_replay_cigar (wavefront.py:1243) rebuilds from
  that skeleton, as run-length words (`runs`);
- `wfa_score` replaces the score-only wfa_affine_batch (:319) and
  wfa_affine2p_batch (:615) of the exhaustive-search screen, and under the
  "linear" model wfa_linear_batch (:232) and with it wfa_edit_batch
  (:166), edit distance being the gap-linear penalty at x = e = 1;
- `wfa_mid` replaces wfa_affine_mid_batch (:442), the bialign engine's
  midpoint fill: per pair the penalty and the on-path split cell.

`wfa_align` and `wfa_score` take `model` "affine" (penalties x, o, e) or
"affine2p" (also o2, e2); `wfa_score` also takes "linear" (x, and e an
indel base: the M plane alone, the kernel's G = 0); `wfa_mid` is
gap-affine only. Each runs its hand-written kernel of csrc/wfa_align.cu on
CUDA tensors, its plain PyTorch version below on CPU tensors
(wfa_fill_reference, wfa_walk_reference, wfa_runs_reference,
wfa_linear_reference, wfa_mid_reference); any other device raises.
`wfa_align_launches`, `wfa_score_launches` (the affine models),
`wfa_linear_launches` (wfa_score under "linear") and
`wfa_mid_launches` count kernel launches and nothing else. `wfa_plan` lays a launch out on the
card (each plane's ring rows, the CTAs a pair, where the rings live); the
kernel checks what it is given.

The plain versions are the JAX functions step for step: one batched
[B, K] update a score step, ring buffers of `hist` rows, the loop running
while s < smax and a lane is not done. Greedy extension compares bytes (a
run-length table over offsets replaces the JAX package's packed bitmaps,
a workaround for the TPU's slow gathers; the runs are the same): a
position matches where h < l1 and 0 <= h - k < l2, and under `wildcards`
a byte below 58 or 'N' on either side matches anything.

The op byte of a (score step, pair, diagonal): affine, bits 0-1 the M
source (0 none, 1 mismatch, 2 I, 3 D), bit 2 I from extend, bit 3 D from
extend; affine2p, bits 0-2 the M source (0 none, 1 mismatch, 2 I1, 3 D1,
4 I2, 5 D2), bits 3-6 I1, D1, I2, D2 from extend. Rows past a lane's
penalty hold whatever the fill left there (the kernel stops a pair at its
own penalty, the batched plain version at the batch's last one): only
rows up to each lane's penalty are defined.

A run word: count << 2 | op, op 0 M, 1 I, 2 D (RUN_OPS). A lane's row of
`runs` holds its CIGAR's runs in order, then a 0; a censored or unwalked
lane's row starts with the 0. The kernel marks a lane whose replay does
not end at (l1, l2) with h << 2 | 3, v << 2 | 3 (where it ended), then
the 0; the plain version raises there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from clique_tpu_torch.align.dp_kernels import (_check, _device_of,
                                               _launch_stream, _raise_on)

NEG = -(1 << 30)
# the models of the op store and the walk (wfa_align); wfa_score also
# takes "linear"
MODELS = ("affine", "affine2p")
# the midpoint payload's encoding, h * MID_ENC + v (lengths below 32,768)
MID_ENC = 1 << 16
# a run word's op (count << 2 | op), and the op of the two words that mark
# a replay that did not end at (l1, l2)
RUN_OPS = ("M", "I", "D")
RUN_FAULT = 3

wfa_align_launches = 0
wfa_score_launches = 0
wfa_linear_launches = 0
wfa_mid_launches = 0
# launches whose rings did not fit the shared memory of a cluster of 8 CTAs
# and lived in a global workspace instead (csrc/wfa_align.cu)
wfa_global_ring_launches = 0
# wfa_score launches on the warp path (one warp a pair)
wfa_score_warp_launches = 0

# csrc/wfa_align.cu's limits: an H100 block's shared memory, the threads of
# a wfa_mid CTA and of the others', the cluster sizes, its control words
# and the workspace's pair counter; the L2 a persistent grid's workspaces
# share, and the SMs of an H100 SXM
SMEM_LIMIT = 232448
MID_THREADS = 1024
MAX_THREADS = 512
CLUSTER_SIZES = (1, 2, 4, 8)
CTRL_INTS = 8
COUNTER_INTS = 4
L2_BYTES = 50 << 20
SMS = 132
# wfa_score's warp path (kWarpMaxK, kWarpPairs): the widest band one warp
# takes, four diagonals a lane, and the pairs (warps) of a CTA at most
WARP_MAX_K = 128
WARP_PAIRS = 4


def reset_counts() -> None:
    global wfa_align_launches, wfa_score_launches, wfa_mid_launches
    global wfa_global_ring_launches, wfa_score_warp_launches
    global wfa_linear_launches
    wfa_align_launches = 0
    wfa_score_launches = 0
    wfa_linear_launches = 0
    wfa_mid_launches = 0
    wfa_global_ring_launches = 0
    wfa_score_warp_launches = 0


def exact_kband(smax: int, opens_extends) -> int:
    """Largest |diagonal| any path with penalty <= smax can touch
    (clique_tpu/align/wavefront.py:60-73): reaching diagonal k costs at
    least min_i(o_i + e_i * |k|)."""
    kb = 0
    for o, e in opens_extends:
        if smax > o:
            kb = max(kb, (smax - o) // max(e, 1))
    return kb


def gap_classes(model: str, o: int, e: int, o2: int, e2: int):
    """The (open, extend) pairs of a penalty model; gap-linear's one class
    opens for nothing."""
    if model == "linear":
        return ((0, e),)
    if model not in MODELS:
        raise ValueError(f"unknown WFA penalties model: {model}")
    return ((o, e),) if model == "affine" else ((o, e), (o2, e2))


def kmax_of(model: str, n1: int, n2: int, smax: int, o: int, e: int,
            o2: int, e2: int, kband: Optional[int] = None) -> int:
    """The fill's diagonal half-width: K = 2 * kmax + 1 diagonals
    (gap-linear: min(n1 + n2, smax, smax // e), wfa_linear_batch's)."""
    kmax = min(n1 + n2, smax, exact_kband(smax, gap_classes(model, o, e,
                                                            o2, e2)))
    if kband is not None:
        kmax = min(kmax, kband)
    return kmax


def hist_of(model: str, x: int, o: int, e: int, o2: int, e2: int) -> int:
    """Rows of each ring buffer: the longest lookback plus one."""
    back = [x] + [v for oe in gap_classes(model, o, e, o2, e2)
                  for v in (oe[0] + oe[1], oe[1])]
    return max(back) + 1


def steps_of(model: str, x: int, e: int, e2: int,
             adaptive: bool = False) -> int:
    """Score steps the kernel runs between two barriers: 2 where no plane
    is read fewer than 2 steps back (x and every extend >= 2) and no trim
    runs between the steps, else 1."""
    least = min([x, e] + ([e2] if model == "affine2p" else []))
    return 2 if least >= 2 and not adaptive else 1


def ring_heights(model: str, x: int, o: int, e: int, o2: int, e2: int,
                 steps: int = 1):
    """Rows of each ring plane of the kernel: (M, I and D of class 1[, I
    and D of class 2]). M is read x and o_g + e_g steps back, I_g and D_g
    e_g steps back; each keeps its longest lookback plus `steps` rows (a
    barrier interval's steps never write a row that one of them reads).
    Gap-linear has the M plane alone, read x and e steps back: (M,)."""
    classes = gap_classes(model, o, e, o2, e2)
    hm = max([x] + [og + eg for og, eg in classes]) + steps
    if model == "linear":
        return (hm,)
    return (hm, *(eg + steps for _og, eg in classes))


def seq_bytes(n: int) -> int:
    """Shared-memory bytes of a sequence row (whole words, one spare)."""
    return ((n + 3) // 4 + 1) * 4


def warp_slice(n1: int, n2: int, rows: int, K: int) -> int:
    """Shared-memory bytes of one pair on wfa_score's warp path: both
    sequences and the rings of all K diagonals (int values), no control
    words, in 16-byte steps."""
    return -(-(seq_bytes(n1) + seq_bytes(n2) + 4 * rows * (K + 2)) // 16) \
        * 16


class WfaPlan(NamedTuple):
    """How csrc/wfa_align.cu lays one launch out on the card."""
    steps: int         # score steps between two barriers
    heights: tuple     # ring rows: M (and PM), I and D of each class (PI, PD)
    rows: int          # rows of the M, I, D planes
    C: int             # CTAs a pair: a thread-block cluster when > 1
    cw: int            # diagonals a CTA (CTA r: r * cw .. r * cw + cw - 1)
    value_bytes: int   # bytes of a ring value: 4, or 2 (wfa_mid's int16)
    smem: int          # shared-memory bytes of a CTA
    grid: int          # > 0: a persistent grid of at most grid CTAs
    ring_global: bool  # the rings in the global workspace
    ws_ints: int       # ints of one CTA's global workspace
    threads: int       # threads a CTA
    wp: int = 0        # > 0: wfa_score's warp path, wp pairs (warps) a CTA


@functools.lru_cache(maxsize=256)
def wfa_plan(kind: str, model: str, n1: int, n2: int, B: int, smax: int,
             kmax: int, x: int, o: int, e: int, o2: int, e2: int,
             adaptive: bool = False, sms: int = SMS,
             cluster: Optional[int] = None,
             warp: Optional[bool] = None) -> WfaPlan:
    """The layout of a wfa_align ("align"), wfa_score ("score") or wfa_mid
    ("mid") launch over B pairs of [n1] / [n2] rows at smax, K = 2 * kmax
    + 1 diagonals. A CTA holds both sequences, its control words, then the
    rows of its diagonals in every ring plane (each plane its own height),
    or after the fill the walk's ops. wfa_align and wfa_score take the
    least cluster size C whose CTAs each fit SMEM_LIMIT, doubled while a
    CTA would still hold more than MAX_THREADS diagonals and the pairs'
    CTAs, B * 2C, stay within half the card's `sms` (past that, clusters
    of 2 and 4 measured slower than one CTA a pair). Past a cluster of 8
    the rings live in a global workspace. wfa_mid runs a persistent grid:
    its int16 M, I and D rings in shared memory where one CTA holds them
    (else in the workspace), its payload planes in the workspace. A
    persistent grid has at most as many CTAs as L2_BYTES holds the
    workspaces of (at most B; the launch caps it at what the card holds at
    once). Where every lookback is 2 or more and the trim is off, two
    score steps run between barriers and each plane keeps one row more.
    `cluster` forces C (0: the global workspace). Gap-linear ("linear",
    o = 0) is wfa_score's only. wfa_score takes the warp
    path where the band fits a warp, K <= WARP_MAX_K (at most four
    diagonals a lane), and one pair's slice (its rows and rings) fits:
    WARP_PAIRS pairs a CTA, fewer where their slices would pass
    SMEM_LIMIT, never more than B. `warp` forces it on (True, raising
    where it does not apply) or off (False); a forced `cluster` keeps the
    CTA path. Raises ValueError for a lookback below 1 (x or an extend of
    0), which the kernel's rings cannot hold."""
    if min(x, e) < 1 or (model == "affine2p" and e2 < 1):
        raise ValueError("the kernels need x and every extend >= 1")
    if model == "linear" and (kind != "score" or o != 0):
        raise ValueError("the gap-linear model is wfa_score's, with o = 0")
    steps = steps_of(model, x, e, e2, adaptive)
    heights = ring_heights(model, x, o, e, o2, e2, steps)
    rows = heights[0] + 2 * sum(heights[1:])
    K = 2 * kmax + 1
    vb = 2 if kind == "mid" else 4
    base = seq_bytes(n1) + seq_bytes(n2) + 4 * CTRL_INTS
    walk = (smax + 4) // 4 * 4 if kind == "align" else 0

    def threads(cw):
        return min(MID_THREADS if kind == "mid" else MAX_THREADS,
                   max(32, -(-cw // 32) * 32))

    def smem(C):
        cw = -(-K // C)
        return base + max(-(-vb * rows * (cw + 2) // 4) * 4, walk)

    def persistent(ring_global):
        ws = rows * (K + 2) * ((kind == "mid") + ring_global)
        grid = max(1, min(B, L2_BYTES // (4 * ws)))
        return WfaPlan(steps, heights, rows, 1, K, vb,
                       base + walk if ring_global else smem(1), grid,
                       ring_global, ws, threads(K))

    if kind == "mid":
        if cluster not in (None, 0, 1):
            raise ValueError("wfa_mid runs one CTA a pair")
        return persistent(cluster == 0 or smem(1) > SMEM_LIMIT)
    if warp or (warp is None and cluster is None):
        one = warp_slice(n1, n2, rows, K)
        if kind == "score" and K <= WARP_MAX_K and one <= SMEM_LIMIT:
            wp = WARP_PAIRS
            while wp > 1 and wp * one > SMEM_LIMIT:
                wp //= 2
            wp = min(wp, max(1, B))
            return WfaPlan(steps, heights, rows, 1, K, vb, wp * one, 0,
                           False, 0, 32 * wp, wp)
        if warp:
            raise ValueError(f"{kind}: the warp path takes wfa_score "
                             f"launches of K <= {WARP_MAX_K} whose rings "
                             f"fit, not K = {K}")
    if cluster is None:
        C = next((c for c in CLUSTER_SIZES if smem(c) <= SMEM_LIMIT), 0)
        while C and C < CLUSTER_SIZES[-1] and -(-K // C) > MAX_THREADS \
                and B * 2 * C <= sms // 2:
            C *= 2
    else:
        C = cluster
        if C and (C not in CLUSTER_SIZES or smem(C) > SMEM_LIMIT):
            raise ValueError(f"{kind}: a cluster of {C} cannot hold these "
                             f"rings")
    if C == 0:
        return persistent(True)
    cw = -(-K // C)
    return WfaPlan(steps, heights, rows, C, cw, vb, smem(C), 0, False, 0,
                   threads(cw))


def _check_inputs(refs, reads, ref_lens, read_lens, model, smax, x, o, e,
                  o2, e2):
    dev = _device_of(reads)
    _check(refs, "refs", torch.uint8, 2, dev)
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(ref_lens, "ref_lens", torch.int32, 1, dev)
    _check(read_lens, "read_lens", torch.int32, 1, dev)
    B = reads.shape[0]
    if refs.shape[0] != B or ref_lens.shape[0] != B or \
            read_lens.shape[0] != B:
        raise ValueError("refs, reads and their lengths need one row per "
                         "pair")
    gap_classes(model, o, e, o2, e2)
    if refs.shape[1] < 1 or reads.shape[1] < 1:
        raise ValueError("refs and reads must be at least one byte wide")
    if smax < 0:
        raise ValueError("smax must be >= 0")
    if min(x, o, e, o2, e2) < 0:
        raise ValueError("penalties must be >= 0")
    return dev, B


# elements of one slice of diagonals while a run table is built: bounds
# the build's temporaries (the cummin's int64 indices among them)
RUN_TABLE_SLICE = 1 << 25


def _run_table(refs, reads, ks, l1, l2, wildcards):
    """[B, K, H+1] i32: the greedy match run from each offset h of each
    diagonal (H = refs.shape[1]; column H is 0). Built a slice of
    diagonals at a time, into the table."""
    B, n1w = refs.shape
    run = torch.empty((B, len(ks), n1w + 1), dtype=torch.int32,
                      device=refs.device)
    step = max(1, RUN_TABLE_SLICE // max(1, B * (n1w + 1)))
    for i in range(0, len(ks), step):
        run[:, i:i + step] = _run_slice(refs, reads, ks[i:i + step], l1, l2,
                                        wildcards)
    return run


def _run_slice(refs, reads, ks, l1, l2, wildcards):
    B, n1w = refs.shape
    n2w = reads.shape[1]
    dev = refs.device
    h = torch.arange(n1w + 1, dtype=torch.int32, device=dev)
    v = h[None, :] - ks[:, None]                              # [K, H+1]
    rh = refs[:, h.clamp(max=n1w - 1).long()][:, None, :]
    rv = reads[:, v.clamp(0, n2w - 1).long()]
    eq = rh == rv
    if wildcards:
        eq = eq | (rh < 58) | (rh == 78) | (rv < 58) | (rv == 78)
    eq = eq & (h[None, None, :] < l1[:, :, None]) & (v[None] >= 0) & \
        (v[None] < l2[:, :, None])
    # run[h] = (first mismatch at or after h) - h
    hh = h.expand_as(eq)
    stop = torch.where(eq, torch.full_like(hh, n1w + 1), hh)
    first = torch.flip(torch.cummin(torch.flip(stop, (2,)), 2).values, (2,))
    return first - hh


def _shift_r(w):
    """W[k-1] (the deletion direction), NEG at the first diagonal."""
    return torch.nn.functional.pad(w[:, :-1], (1, 0), value=NEG)


def _shift_l(w):
    """W[k+1] (the insertion direction), NEG at the last diagonal."""
    return torch.nn.functional.pad(w[:, 1:], (0, 1), value=NEG)


def _plus1(w):
    return torch.where(w > NEG, w + 1, NEG)


def _check_lengths(refs, reads, ref_lens, read_lens):
    n1w, n2w = refs.shape[1], reads.shape[1]
    if bool(((ref_lens < 0) | (ref_lens > n1w) | (read_lens < 0)
             | (read_lens > n2w)).any()):
        raise ValueError("a length lies outside [0, width]")
    return n1w, n2w


class _Diagonals:
    """The K = 2 * Kmax + 1 diagonals of a batch's fills and the per-step
    masks of the JAX functions: `clamp` to the DP rectangle, `diag_valid`
    at a score step, greedy `extend` through the run table, `done` on the
    target diagonal."""

    def __init__(self, refs, reads, ref_lens, read_lens, Kmax, wildcards):
        K = 2 * Kmax + 1
        self.n1w = refs.shape[1]
        self.ks = torch.arange(K, dtype=torch.int32,
                               device=refs.device) - Kmax
        self.l1 = ref_lens[:, None]
        self.l2 = read_lens[:, None]
        k_target = (self.l1 - self.l2)[:, 0]
        self.target_ok = k_target.abs() <= Kmax
        self.tgt = (k_target.clamp(-Kmax, Kmax) + Kmax).long()[:, None]
        self.run = _run_table(refs, reads, self.ks, self.l1, self.l2,
                              wildcards)

    def clamp(self, offs):
        ks, l1, l2 = self.ks[None, :], self.l1, self.l2
        v = offs - ks
        ok = (offs <= l1) & (v <= l2) & (v >= 0) & (ks >= -l2) & (ks <= l1)
        return torch.where(ok, offs, NEG)

    def diag_valid(self, s):
        ks = self.ks[None, :]
        return (ks.abs() <= s) & (ks >= -self.l2) & (ks <= self.l1)

    def extend(self, offs, valid):
        ok = valid & (offs > NEG) & (offs >= 0)
        idx = offs.clamp(0, self.n1w).long()
        return torch.where(
            ok, offs + self.run.gather(2, idx[:, :, None])[:, :, 0], offs)

    def at_target(self, t):
        """[B] values of t [B, K] on each pair's (clipped) target
        diagonal."""
        return t.gather(1, self.tgt)[:, 0]

    def done(self, m):
        return self.target_ok & (self.at_target(m) >= self.l1[:, 0])


def wfa_fill_reference(refs, reads, ref_lens, read_lens, *, smax: int,
                       model: str = "affine", x: int = 4, o: int = 6,
                       e: int = 2, o2: int = 24, e2: int = 1,
                       wildcards: bool = False, kband: Optional[int] = None,
                       adaptive: Optional[int] = None,
                       traceback: bool = True):
    """The plain wavefront fill: penalty [B] i32 (smax + 1 censored) and,
    with traceback, the op store [smax+1, B, K] u8 (else None). Semantics
    of wfa_affine{,2p}_tb_batch and, without traceback and adaptive, of
    wfa_affine{,2p}_batch. refs [B, n1] and reads [B, n2] u8 row-padded,
    lengths [B] i32 in [0, n1] / [0, n2]. The gap-linear model's plain
    version is wfa_linear_reference."""
    if model not in MODELS:
        raise ValueError(f"unknown WFA penalties model for the op store: "
                         f"{model!r} (the gap-linear one's plain version "
                         f"is wfa_linear_reference)")
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, model, smax, x,
                           o, e, o2, e2)
    n1w, n2w = _check_lengths(refs, reads, ref_lens, read_lens)
    classes = gap_classes(model, o, e, o2, e2)
    G = len(classes)
    Kmax = kmax_of(model, n1w, n2w, smax, o, e, o2, e2, kband)
    K = 2 * Kmax + 1
    hist = hist_of(model, x, o, e, o2, e2)
    i32 = torch.int32
    w = _Diagonals(refs, reads, ref_lens, read_lens, Kmax, wildcards)
    ks, clamp, diag_valid, extend, done = (w.ks, w.clamp, w.diag_valid,
                                           w.extend, w.done)

    neg = torch.full((B, K), NEG, dtype=i32, device=dev)
    m0 = torch.where((ks == 0)[None, :].expand(B, K), 0, neg)
    m0 = extend(m0, diag_valid(0))
    M = [neg] * hist
    M[0] = m0
    I = [[neg] * hist for _ in range(G)]
    D = [[neg] * hist for _ in range(G)]
    ops = torch.zeros((smax + 1, B, K), dtype=torch.uint8, device=dev) \
        if traceback else None
    result = torch.where(done(m0), 0, -1).to(i32)
    s = 0

    def get(ring, s1, back):
        return ring[(s1 - back) % hist] if s1 - back >= 0 else neg

    while s < smax and not bool((result >= 0).all()):
        s1 = s + 1
        vld = diag_valid(s1)
        new_i, new_d, i_ext, d_ext = [], [], [], []
        for g, (og, eg) in enumerate(classes):
            m_oe = get(M, s1, og + eg)
            d_open, d_e = _shift_r(m_oe), _shift_r(get(D[g], s1, eg))
            i_open, i_e = _shift_l(m_oe), _shift_l(get(I[g], s1, eg))
            new_d.append(_plus1(torch.maximum(d_open, d_e)))
            d_ext.append(d_e > d_open)            # a tie opens
            new_i.append(torch.maximum(i_open, i_e))
            i_ext.append(i_e > i_open)
        mism = _plus1(get(M, s1, x))
        if G == 1:
            # affine: M from the raw gaps, then every plane clamped
            new_m = torch.maximum(mism, torch.maximum(new_i[0], new_d[0]))
            m_src = torch.where(mism == new_m, 1,
                                torch.where(new_i[0] == new_m, 2, 3))
            new_i = [clamp(torch.where(vld, new_i[0], NEG))]
            new_d = [clamp(torch.where(vld, new_d[0], NEG))]
        else:
            # affine2p: the gaps clamped first, M from the clamped gaps
            new_i = [clamp(torch.where(vld, t, NEG)) for t in new_i]
            new_d = [clamp(torch.where(vld, t, NEG)) for t in new_d]
            new_m = torch.maximum(
                mism, torch.maximum(torch.maximum(new_i[0], new_d[0]),
                                    torch.maximum(new_i[1], new_d[1])))
            m_src = torch.where(
                mism == new_m, 1, torch.where(
                    new_i[0] == new_m, 2, torch.where(
                        new_d[0] == new_m, 3, torch.where(
                            new_i[1] == new_m, 4, 5))))
        m_src = torch.where(new_m <= NEG, 0, m_src)
        new_m = extend(clamp(torch.where(vld, new_m, NEG)), vld)
        if adaptive is not None:
            # wf-adaptive trim: drop diagonals whose antidiagonal progress
            # 2h - k lags the lane's best by more than the margin
            has_m = new_m > NEG
            prog = 2 * torch.where(has_m, new_m, 0) - ks[None, :]
            best = torch.where(has_m, prog, NEG).amax(1, keepdim=True)
            kill = has_m & (prog < best - adaptive)
            new_m = torch.where(kill, NEG, new_m)
            new_i = [torch.where(kill, NEG, t) for t in new_i]
            new_d = [torch.where(kill, NEG, t) for t in new_d]
        if traceback:
            shift = 2 if G == 1 else 3
            byte = m_src.to(torch.uint8)
            for g in range(G):
                byte = byte | (i_ext[g].to(torch.uint8) << (shift + 2 * g)) \
                    | (d_ext[g].to(torch.uint8) << (shift + 2 * g + 1))
            ops[s1] = byte
        idx = s1 % hist
        M[idx] = new_m
        for g in range(G):
            I[g][idx] = new_i[g]
            D[g][idx] = new_d[g]
        result = torch.where((result < 0) & done(new_m), s1, result).to(i32)
        s = s1
    pen = torch.where(result < 0, smax + 1, result).to(i32)
    return pen, ops


def wfa_linear_reference(refs, reads, ref_lens, read_lens, *, smax: int,
                         x: int = 4, e: int = 2, wildcards: bool = False,
                         kband: Optional[int] = None):
    """The plain gap-linear wavefront fill, step for step wfa_linear_batch
    (wavefront.py:232-316): mismatch x, e an indel base, no gap open, the
    M plane alone (M[s] from M[s - x] on k and M[s - e] on k -/+ 1).
    Returns the penalty [B] i32 (smax + 1 censored); edit distance is x =
    e = 1 without wildcards (wfa_edit_batch's). Inputs as
    wfa_fill_reference's."""
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, "linear", smax,
                           x, 0, e, 0, 0)
    n1w, n2w = _check_lengths(refs, reads, ref_lens, read_lens)
    Kmax = kmax_of("linear", n1w, n2w, smax, 0, e, 0, 0, kband)
    K = 2 * Kmax + 1
    hist = hist_of("linear", x, 0, e, 0, 0)
    i32 = torch.int32
    w = _Diagonals(refs, reads, ref_lens, read_lens, Kmax, wildcards)
    ks, clamp, diag_valid, extend, done = (w.ks, w.clamp, w.diag_valid,
                                           w.extend, w.done)
    neg = torch.full((B, K), NEG, dtype=i32, device=dev)
    m0 = torch.where((ks == 0)[None, :].expand(B, K), 0, neg)
    m0 = extend(m0, diag_valid(0))
    M = [neg] * hist
    M[0] = m0
    result = torch.where(done(m0), 0, -1).to(i32)
    s = 0

    def get(s1, back):
        return M[(s1 - back) % hist] if s1 - back >= 0 else neg

    while s < smax and not bool((result >= 0).all()):
        s1 = s + 1
        m_e = get(s1, e)
        new = torch.maximum(_plus1(get(s1, x)),
                            torch.maximum(_plus1(_shift_r(m_e)),
                                          _shift_l(m_e)))
        vld = diag_valid(s1)
        new = extend(clamp(torch.where(vld, new, NEG)), vld)
        M[s1 % hist] = new
        result = torch.where((result < 0) & done(new), s1, result).to(i32)
        s = s1
    return torch.where(result < 0, smax + 1, result).to(i32)


def wfa_mid_reference(refs, reads, ref_lens, read_lens, *, smax: int,
                      x: int = 4, o: int = 6, e: int = 2,
                      wildcards: bool = False):
    """The plain gap-affine midpoint fill of the bialign engine, step for
    step wfa_affine_mid_batch (wavefront.py:442-609): the penalty [B] i32
    (smax + 1 censored) and the split payload [B] i32, h * MID_ENC + v of
    the last M-state cell with h + v <= (l1 + l2) // 2 on the optimal path
    (-1 censored). Beside the M, I and D rings it keeps payload rings PM,
    PI and PD that follow the traceback's choices (mismatch > I > D on the
    raw gaps; a gap extends only where extend > open); `pay_update` moves
    an M payload across a step's greedy extension. Inputs as
    wfa_fill_reference's."""
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, "affine", smax,
                           x, o, e, 0, 0)
    n1w, n2w = _check_lengths(refs, reads, ref_lens, read_lens)
    Kmax = kmax_of("affine", n1w, n2w, smax, o, e, 0, 0)
    K = 2 * Kmax + 1
    hist = hist_of("affine", x, o, e, 0, 0)
    i32 = torch.int32
    w = _Diagonals(refs, reads, ref_lens, read_lens, Kmax, wildcards)
    ks, clamp, diag_valid, extend, done = (w.ks[None, :], w.clamp,
                                           w.diag_valid, w.extend, w.done)
    mid = (w.l1 + w.l2) // 2                   # [B, 1] split anti-diagonal

    def pay_update(h_base, h_ext, pay_inh):
        # the last cell of the run h_base..h_ext at/before the mid
        # anti-diagonal (>> floors, as jnp's)
        cand = torch.minimum(torch.maximum((mid + ks) >> 1, h_base), h_ext)
        on_mid = (h_base > NEG) & (2 * cand - ks <= mid)
        return torch.where(on_mid, cand * MID_ENC + (cand - ks), pay_inh)

    neg = torch.full((B, K), NEG, dtype=i32, device=dev)
    neg_pay = torch.full((B, K), -1, dtype=i32, device=dev)
    m0_base = torch.where((ks == 0).expand(B, K), 0, neg)
    m0 = extend(m0_base, diag_valid(0))
    p0 = pay_update(m0_base, m0, neg_pay)
    M, I, D = [neg] * hist, [neg] * hist, [neg] * hist
    PM, PI, PD = [neg_pay] * hist, [neg_pay] * hist, [neg_pay] * hist
    M[0], PM[0] = m0, p0
    init_done = done(m0)
    result = torch.where(init_done, 0, -1).to(i32)
    out_pay = torch.where(init_done, w.at_target(p0), -1).to(i32)
    s = 0

    def get(ring, s1, back, empty):
        return ring[(s1 - back) % hist] if s1 - back >= 0 else empty

    def shift_r(t, fill):
        return torch.nn.functional.pad(t[:, :-1], (1, 0), value=fill)

    def shift_l(t, fill):
        return torch.nn.functional.pad(t[:, 1:], (0, 1), value=fill)

    while s < smax and not bool((result >= 0).all()):
        s1 = s + 1
        m_oe, p_oe = get(M, s1, o + e, neg), get(PM, s1, o + e, neg_pay)
        d_open, d_ext = shift_r(m_oe, NEG), shift_r(get(D, s1, e, neg), NEG)
        new_d = _plus1(torch.maximum(d_open, d_ext))
        pay_d = torch.where(d_ext > d_open,           # a tie opens
                            shift_r(get(PD, s1, e, neg_pay), -1),
                            shift_r(p_oe, -1))
        i_open, i_ext = shift_l(m_oe, NEG), shift_l(get(I, s1, e, neg), NEG)
        new_i = torch.maximum(i_open, i_ext)
        pay_i = torch.where(i_ext > i_open,
                            shift_l(get(PI, s1, e, neg_pay), -1),
                            shift_l(p_oe, -1))
        mism = _plus1(get(M, s1, x, neg))
        new_m = torch.maximum(mism, torch.maximum(new_i, new_d))
        pay_m = torch.where(mism == new_m, get(PM, s1, x, neg_pay),
                            torch.where(new_i == new_m, pay_i, pay_d))
        vld = diag_valid(s1)
        h_base = clamp(torch.where(vld, new_m, NEG))
        new_i = clamp(torch.where(vld, new_i, NEG))
        new_d = clamp(torch.where(vld, new_d, NEG))
        new_m = extend(h_base, vld)
        pay_m = pay_update(h_base, new_m, pay_m)
        idx = s1 % hist
        M[idx], I[idx], D[idx] = new_m, new_i, new_d
        PM[idx], PI[idx], PD[idx] = pay_m, pay_i, pay_d
        newly = (result < 0) & done(new_m)
        out_pay = torch.where(newly, w.at_target(pay_m), out_pay)
        result = torch.where(newly, s1, result).to(i32)
        s = s1
    censored = result < 0
    return (torch.where(censored, smax + 1, result).to(i32),
            torch.where(censored, -1, out_pay).to(i32))


def _walk_gaps(model, x, o, e, o2, e2):
    """(state, diagonal step, extend bit, open + extend cost, extend cost,
    open op, extend op) of each gap state of the walk."""
    if model == "affine2p":
        return ((1, +1, 3, o + e, e), (2, -1, 4, o + e, e),
                (3, +1, 5, o2 + e2, e2), (4, -1, 6, o2 + e2, e2))
    return ((1, +1, 2, o + e, e), (2, -1, 3, o + e, e))


def wfa_walk_reference(ops, scores, k_targets, *, model: str, x: int, o: int,
                       e: int, o2: int = 0, e2: int = 0):
    """The plain backtrace walk (wfa_walk_device, wavefront.py:1156-1236):
    one reverse pass over the op store's rows, each lane acting at the row
    its score pointer is on, at most one op a row (an M -> gap switch and
    the gap's first step share the row). Returns (ops_fwd [B, S+1] u8, the
    op characters in forward order, 0-padded; fin [B] i32: -1 where the
    walk reached row 0 in M, -2 for a censored lane)."""
    S1, B, K = ops.shape
    dev = ops.device
    kmax = (K - 1) // 2
    i32 = torch.int32
    scores = scores.to(i32)
    alive = (scores >= 0) & (scores < S1)
    s = torch.where(alive, scores, -2)
    k = torch.where(alive, k_targets.to(i32), 0).clamp(-kmax, kmax)
    state = torch.zeros(B, dtype=i32, device=dev)
    m_mask = 7 if model == "affine2p" else 3
    gaps = _walk_gaps(model, x, o, e, o2, e2)
    rows_out = torch.zeros((B, S1), dtype=torch.uint8, device=dev)
    for row in range(S1 - 1, -1, -1):
        kk = (k + kmax).long()
        inside = (kk >= 0) & (kk < K)
        byte = torch.where(inside, ops[row].gather(
            1, kk.clamp(0, K - 1)[:, None])[:, 0].to(i32), 0)
        in_m = (s == row) & (state == 0)
        finish = in_m & (row == 0)
        m_src = byte & m_mask
        mm = in_m & ~finish & (m_src == 1)
        op = torch.where(mm, 88, 0).to(i32)                  # 'X'
        s = torch.where(mm, s - x, s)
        s = torch.where(finish, -1, s)
        sw = in_m & ~finish & (m_src >= 2)
        state = torch.where(sw, m_src - 1, state)
        in_g = (s == row) & (state > 0)
        for st, dk, shift, oe_cost, e_cost in gaps:
            g = in_g & (state == st)
            ext = (byte >> shift) & 1
            op = torch.where(g, torch.where(ext == 1, 105 if dk > 0 else 100,
                                            73 if dk > 0 else 68), op)
            s = torch.where(g, s - torch.where(ext == 1, e_cost, oe_cost), s)
            k = torch.where(g, k + dk, k)
            state = torch.where(g & (ext == 0), 0, state)
        rows_out[:, row] = op.to(torch.uint8)
    # forward path order = ascending rows; left-compact the emitted ops
    order = torch.argsort((rows_out == 0).to(i32), dim=1, stable=True)
    return rows_out.gather(1, order), s.to(i32)


def runs_width(model: str, smax: int, x: int, e: int, e2: int) -> int:
    """Words of a lane's row of `runs`. Each skeleton op takes at least
    min(x, e[, e2]) off a converged walk's penalty (<= smax), so a lane has
    at most n = smax // that ops and its CIGAR at most 2n + 1 runs; one
    word more for the 0 and one so that a replay fault's three words
    always fit."""
    least = min([x, e] + ([e2] if model == "affine2p" else []))
    return 2 * (smax // max(least, 1)) + 3


def run_words(cigar) -> list:
    """The run words of a [(count, op)] CIGAR."""
    return [n << 2 | RUN_OPS.index(op) for n, op in cigar]


def wfa_runs_reference(refs, reads, ref_lens, read_lens, ops_fwd, fin, *,
                       width: int, wildcards: bool = False):
    """The plain version of wfa_align's runs: [B, width] i32, each walked
    lane's skeleton (ops_fwd, fin -1) replayed by the host helper
    wfa_replay_cigar over its bytes; 0s where fin is not -1 (censored or
    unwalked lanes). A replay that does not end at (l1, l2) raises
    wfa_replay_cigar's ValueError."""
    import numpy as np

    from clique_tpu_torch.align.wavefront import (WfaAligner,
                                                  wfa_replay_cigar)

    B = ops_fwd.shape[0]
    out = np.zeros((B, width), dtype=np.int32)
    walked = fin.cpu().numpy() == -1
    skeletons = WfaAligner._decode_walk(ops_fwd.cpu().numpy(),
                                        np.where(walked, -1, -2), B)
    a_np, b_np = refs.cpu().numpy(), reads.cpu().numpy()
    la, lb = ref_lens.tolist(), read_lens.tolist()
    for j, skeleton in enumerate(skeletons):
        if skeleton is None:
            continue
        a, b = a_np[j, :la[j]].tobytes(), b_np[j, :lb[j]].tobytes()
        words = run_words(wfa_replay_cigar(a, b, skeleton,
                                           wildcards=wildcards))
        if len(words) >= width:
            raise ValueError(f"lane {j}: {len(words)} runs do not fit a "
                             f"row of {width}")
        out[j, :len(words)] = words
    return torch.from_numpy(out).to(ops_fwd.device)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_on(dev, kind, model, n1, n2, B, smax, kmax, x, o, e, o2, e2,
             adaptive=False):
    return wfa_plan(kind, model, n1, n2, B, smax, kmax, x, o, e, o2, e2,
                    adaptive, sms=_sms(dev.index if dev.index is not None
                                       else torch.cuda.current_device()))


def _workspace(plan, dev):
    """A persistent grid's workspace (its pair counter, then each CTA's
    ints), else None."""
    if not plan.grid:
        return None
    return torch.empty(COUNTER_INTS + plan.grid * plan.ws_ints,
                       dtype=torch.int32, device=dev)


def _layout_args(plan):
    """The kernel's layout arguments: steps, ring rows (hm, he1, he2; 0 for
    a plane the model has not), C, grid, ring_global."""
    hm, *he = plan.heights
    he = list(he) + [0] * (2 - len(he))
    return (plan.steps, hm, he[0], he[1], plan.C, plan.grid,
            int(plan.ring_global))


def _launch(refs, reads, ref_lens, read_lens, model, smax, x, o, e, o2, e2,
            wildcards, kband, adaptive, traceback, stream):
    """Allocate the outputs, launch csrc/wfa_align.cu's wfa_align (with
    traceback) or wfa_score and return (pen, ops, ops_fwd, fin, runs), the
    last four None without traceback. Counts a launch where it makes
    one."""
    global wfa_align_launches, wfa_score_launches, wfa_global_ring_launches
    global wfa_score_warp_launches, wfa_linear_launches
    from clique_tpu_torch import _build

    dev = reads.device
    B, n1w = refs.shape
    n2w = reads.shape[1]
    G = {"linear": 0, "affine": 1, "affine2p": 2}[model]
    if G == 0:
        o = 0          # gap-linear: no gap open
    Kmax = kmax_of(model, n1w, n2w, smax, o, e, o2, e2, kband)
    K = 2 * Kmax + 1
    o2_, e2_ = (o2, e2) if G == 2 else (0, 0)
    plan = _plan_on(dev, "align" if traceback else "score", model, n1w, n2w,
                    B, smax, Kmax, x, o, e, o2_, e2_,
                    traceback and adaptive is not None)
    lib = _build.load()
    s = _launch_stream(stream, dev, (refs, reads, ref_lens, read_lens))
    with torch.cuda.stream(s):
        pen = torch.empty(B, dtype=torch.int32, device=dev)
        ops = ops_fwd = fin = runs = None
        if traceback:
            width = runs_width(model, smax, x, e, e2_)
            ops = torch.empty((smax + 1, B, K), dtype=torch.uint8,
                              device=dev)
            ops_fwd = torch.empty((B, smax + 1), dtype=torch.uint8,
                                  device=dev)
            fin = torch.empty(B, dtype=torch.int32, device=dev)
            runs = torch.empty((B, width), dtype=torch.int32, device=dev)
        ring = _workspace(plan, dev) if B else None
    if B == 0:
        return pen, ops, ops_fwd, fin, runs
    steps, hm, he1, he2, C, grid, ring_global = _layout_args(plan)
    head = (refs.data_ptr(), n1w, reads.data_ptr(), n2w, ref_lens.data_ptr(),
            read_lens.data_ptr(), B, G, smax, Kmax, x, o, e, o2_, e2_,
            int(bool(wildcards)))
    ring_ptr = ring.data_ptr() if ring is not None else None
    with torch.cuda.device(dev):
        if traceback:
            err = lib.clique_wfa_align(
                *head, -1 if adaptive is None else int(adaptive), steps, hm,
                he1, he2, C, grid, ring_global, plan.ws_ints, ring_ptr,
                pen.data_ptr(), ops.data_ptr(), ops_fwd.data_ptr(),
                fin.data_ptr(), runs.data_ptr(), width, s.cuda_stream)
        else:
            err = lib.clique_wfa_score(
                *head, steps, hm, he1, he2, C, plan.wp, grid, ring_global,
                plan.ws_ints, ring_ptr, pen.data_ptr(), s.cuda_stream)
    _raise_on(err, "wfa_align" if traceback else "wfa_score")
    if traceback:
        wfa_align_launches += 1
    elif G == 0:
        wfa_linear_launches += 1
    else:
        wfa_score_launches += 1
        wfa_score_warp_launches += plan.wp > 0
    if plan.ring_global:
        wfa_global_ring_launches += 1
    return pen, ops, ops_fwd, fin, runs


def wfa_align(refs, reads, ref_lens, read_lens, *, smax: int,
              model: str = "affine", x: int = 4, o: int = 6, e: int = 2,
              o2: int = 24, e2: int = 1, wildcards: bool = False,
              kband: Optional[int] = None, adaptive: Optional[int] = None,
              stream=None) -> Tuple[torch.Tensor, ...]:
    """Wavefront fill with its op store and the backtrace walk, fused:
    refs [B, n1] u8, reads [B, n2] u8 (row-padded), lengths [B] i32 ->
    (penalty [B] i32, smax + 1 censored; op store [smax+1, B, K] u8;
    ops_fwd [B, smax+1] u8; fin [B] i32; runs [B, runs_width(...)] i32),
    as wfa_fill_reference followed by wfa_walk_reference with k_targets =
    ref_lens - read_lens and wfa_runs_reference over that walk. On CUDA
    tensors the kernel replays each walked skeleton itself, a warp a pair;
    on the CPU the runs come from the host replay. The kernel marks a pair
    whose lengths lie outside the rows with penalty -1, fin -3 and no runs
    (the plain version raises ValueError)."""
    if model not in MODELS:
        raise ValueError(f"unknown WFA penalties model for the op store: "
                         f"{model!r} (the gap-linear model is "
                         f"wfa_score's)")
    dev, _B = _check_inputs(refs, reads, ref_lens, read_lens, model, smax, x,
                            o, e, o2, e2)
    if dev.type == "cpu":
        pen, ops = wfa_fill_reference(
            refs, reads, ref_lens, read_lens, smax=smax, model=model, x=x,
            o=o, e=e, o2=o2, e2=e2, wildcards=wildcards, kband=kband,
            adaptive=adaptive)
        ops_fwd, fin = wfa_walk_reference(
            ops, pen, ref_lens - read_lens, model=model, x=x, o=o, e=e,
            o2=o2, e2=e2)
        runs = wfa_runs_reference(
            refs, reads, ref_lens, read_lens, ops_fwd, fin,
            width=runs_width(model, smax, x, e, e2), wildcards=wildcards)
        return pen, ops, ops_fwd, fin, runs
    return _launch(refs, reads, ref_lens, read_lens, model, smax, x, o, e,
                   o2, e2, wildcards, kband, adaptive, True, stream)


def wfa_score(refs, reads, ref_lens, read_lens, *, smax: int,
              model: str = "affine", x: int = 4, o: int = 6, e: int = 2,
              o2: int = 24, e2: int = 1, wildcards: bool = False,
              kband: Optional[int] = None, stream=None) -> torch.Tensor:
    """Score-only wavefront fill: penalty [B] i32 (smax + 1 censored), the
    semantics of wfa_affine_batch / wfa_affine2p_batch, and under model
    "linear" (x, e; o, o2 and e2 unused) of wfa_linear_batch; inputs as
    wfa_align's."""
    dev, _B = _check_inputs(refs, reads, ref_lens, read_lens, model, smax, x,
                            o, e, o2, e2)
    if dev.type == "cpu":
        if model == "linear":
            return wfa_linear_reference(
                refs, reads, ref_lens, read_lens, smax=smax, x=x, e=e,
                wildcards=wildcards, kband=kband)
        return wfa_fill_reference(
            refs, reads, ref_lens, read_lens, smax=smax, model=model, x=x,
            o=o, e=e, o2=o2, e2=e2, wildcards=wildcards, kband=kband,
            traceback=False)[0]
    return _launch(refs, reads, ref_lens, read_lens, model, smax, x, o, e,
                   o2, e2, wildcards, kband, None, False, stream)[0]


def wfa_mid(refs, reads, ref_lens, read_lens, *, smax: int, x: int = 4,
            o: int = 6, e: int = 2, wildcards: bool = False,
            stream=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gap-affine midpoint fill of the bialign engine: (penalty [B] i32,
    smax + 1 censored; payload [B] i32, h * MID_ENC + v of the split cell,
    -1 censored), the semantics of wfa_affine_mid_batch; inputs as
    wfa_align's. On CUDA tensors csrc/wfa_align.cu's wfa_mid kernel (a
    pair whose lengths lie outside its rows gets -1 and -1; the plain
    version raises ValueError)."""
    global wfa_mid_launches, wfa_global_ring_launches
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, "affine", smax,
                           x, o, e, 0, 0)
    if dev.type == "cpu":
        return wfa_mid_reference(refs, reads, ref_lens, read_lens, smax=smax,
                                 x=x, o=o, e=e, wildcards=wildcards)
    from clique_tpu_torch import _build

    n1w, n2w = refs.shape[1], reads.shape[1]
    Kmax = kmax_of("affine", n1w, n2w, smax, o, e, 0, 0)
    plan = _plan_on(dev, "mid", "affine", n1w, n2w, B, smax, Kmax, x, o, e,
                    0, 0)
    lib = _build.load()
    s = _launch_stream(stream, dev, (refs, reads, ref_lens, read_lens))
    with torch.cuda.stream(s):
        pen = torch.empty(B, dtype=torch.int32, device=dev)
        pay = torch.empty(B, dtype=torch.int32, device=dev)
        ring = _workspace(plan, dev) if B else None
    if B == 0:
        return pen, pay
    with torch.cuda.device(dev):
        err = lib.clique_wfa_mid(
            refs.data_ptr(), n1w, reads.data_ptr(), n2w, ref_lens.data_ptr(),
            read_lens.data_ptr(), B, smax, Kmax, x, o, e,
            int(bool(wildcards)), plan.steps, *plan.heights, plan.grid,
            int(plan.ring_global), plan.ws_ints,
            ring.data_ptr() if ring is not None else None, pen.data_ptr(),
            pay.data_ptr(), s.cuda_stream)
    _raise_on(err, "wfa_mid")
    wfa_mid_launches += 1
    if plan.ring_global:
        wfa_global_ring_launches += 1
    return pen, pay
