"""The wavefront engines on PyTorch + CUDA: `align --engine wfa` (gap-affine)
and `--engine convex` (dual-affine) through WfaAligner, and the score-only
screen of the exhaustive reference search.

Counterpart of clique_tpu/align/wavefront.py. The device work is
align/wfa_kernels.py's (hand-written kernels in csrc/wfa_align.cu on a
CUDA device, their plain PyTorch versions on the CPU); this module keeps
the host side:

- copies of the JAX module's host helpers (`_wild`, `wfa_replay_cigar`,
  `cigar_penalty`, `affine_penalty_golden`, `cigar_penalty_2p`,
  `affine2p_penalty_golden`, `cigar_to_aligned`; `exact_kband` lives in
  wfa_kernels) and its host walkers `wfa_backtrace_ops{,_2p}` (the tests' oracle for the
  walk), each with its body as in the JAX module;
- `WfaAligner`, the JAX class with an explicit device: the same length
  buckets, penalty-aware ceilings, chunk caps, waves, 2x escalation and
  fallbacks, so every pair takes the same route and gets the same CIGAR
  and score. Each chunk is one `wfa_align` launch whose walk and CIGAR
  replay run on the card after the fill; only the penalties, end rows and
  run words come back to the host (`_decode_runs` makes the CIGAR lists;
  on the CPU the plain version's runs come from `wfa_replay_cigar`);
- the bialign engine, `wfa_bialign_affine_pairs` over `_mid_split_batch`
  (one `wfa_mid` launch a rung of a split level), for the pairs whose op
  store would pass the memory budget, as in the JAX class;
- `wfa_screen_candidates` on `wfa_score`, and `wfa_affine_align_pairs`;
- `wfa_linear_batch`, `wfa_edit_batch` and `wfa_edit_distances`, the
  gap-linear penalty and edit distance (its x = e = 1 case, no
  wildcards), each one `wfa_score` launch under the "linear" model, which
  no verb calls.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from clique_tpu_torch.align import wfa_kernels
from clique_tpu_torch.align.wfa_kernels import MID_ENC, RUN_FAULT, RUN_OPS
from clique_tpu_torch.utils.trace import span


def _wild(c: int) -> bool:
    return c < 58 or c == 78


def wfa_replay_cigar(a: bytes, b: bytes, skeleton,
                     wildcards: bool = False):
    """Rebuild the full CIGAR from an op skeleton by replaying greedy
    match extension (deterministic, identical to the kernel's extension).
    Returns [(count, op)] with 'M' covering matches+mismatches
    (wavefront.py:1243-1309)."""
    h = v = 0
    l1, l2 = len(a), len(b)
    a_arr = np.frombuffer(a, dtype=np.uint8)
    b_arr = np.frombuffer(b, dtype=np.uint8)
    stop_a = (a_arr >= 58) & (a_arr != 78) if wildcards else None
    stop_b = (b_arr >= 58) & (b_arr != 78) if wildcards else None

    def run_len(h, v):
        n = min(l1 - h, l2 - v)
        if n <= 0:
            return 0
        stop = a_arr[h:h + n] != b_arr[v:v + n]
        if wildcards:
            stop &= stop_a[h:h + n] & stop_b[v:v + n]
        i = int(stop.argmax())
        return i if stop[i] else n

    raw: list = []

    def emit(op, n=1):
        if n <= 0:
            return
        if raw and raw[-1][1] == op:
            raw[-1] = (raw[-1][0] + n, op)
        else:
            raw.append((n, op))

    for op in skeleton:
        if op in ("X", "I", "D"):
            # M state: greedy extension happened before this op in the
            # forward pass (lowercase gap-extends have no matches before
            # them — they continue an open gap)
            run = run_len(h, v)
            h += run
            v += run
            emit("M", run)
        if op == "X":
            emit("M", 1)
            h += 1
            v += 1
        elif op in ("I", "i"):
            emit("I", 1)
            v += 1
        elif op in ("D", "d"):
            emit("D", 1)
            h += 1
    run = run_len(h, v)
    h += run
    v += run
    emit("M", run)
    if h != l1 or v != l2:
        raise ValueError(
            f"wfa replay did not consume both sequences: ({h},{v}) vs "
            f"({l1},{l2})")
    return raw


def cigar_penalty(cigar, a: bytes, b: bytes, *, x: int, o: int, e: int,
                  wildcards: bool = False) -> int:
    """Affine penalty of a CIGAR over a pair (match 0, mismatch x, gap
    o + n*e) — the checkable invariant for traceback tests."""
    h = v = 0
    p = 0
    for n, op in cigar:
        if op == "M":
            for _ in range(n):
                if not (a[h] == b[v] or
                        (wildcards and (_wild(a[h]) or _wild(b[v])))):
                    p += x
                h += 1
                v += 1
        elif op == "I":
            p += o + n * e
            v += n
        elif op == "D":
            p += o + n * e
            h += n
    return p


def affine_penalty_golden(a: bytes, b: bytes, *, x: int, o: int,
                          e: int, wildcards: bool = False) -> int:
    """O(nm) min-penalty gap-affine DP (numpy, host): the independent
    golden for the WFA kernels (match 0 / mismatch x / gap o + n*e,
    Gotoh three-plane)."""
    n1, n2 = len(a), len(b)
    INF = 1 << 29
    av = np.frombuffer(a, dtype=np.uint8).astype(np.int32)
    bv = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
    sub = (av[:, None] != bv[None, :]).astype(np.int64) * x
    if wildcards:
        wild = ((av[:, None] < 58) | (av[:, None] == 78) |
                (bv[None, :] < 58) | (bv[None, :] == 78))
        sub = np.where(wild, 0, sub)
    M = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    M[0, 0] = 0
    for j in range(1, n2 + 1):
        I[0, j] = o + j * e
        M[0, j] = I[0, j]
    for i in range(1, n1 + 1):
        D[i, 0] = o + i * e
        M[i, 0] = D[i, 0]
    for i in range(1, n1 + 1):
        for j in range(1, n2 + 1):
            I[i, j] = min(M[i, j - 1] + o + e, I[i, j - 1] + e)
            D[i, j] = min(M[i - 1, j] + o + e, D[i - 1, j] + e)
            M[i, j] = min(M[i - 1, j - 1] + sub[i - 1, j - 1],
                          I[i, j], D[i, j])
    return int(M[n1, n2])


def cigar_penalty_2p(cigar, a: bytes, b: bytes, *, x: int, o1: int,
                     e1: int, o2: int, e2: int,
                     wildcards: bool = False) -> int:
    """Dual-affine penalty of a CIGAR (match 0, mismatch x, gap of length n
    costs min(o1 + n*e1, o2 + n*e2)) — the checkable invariant for the
    convex traceback tests."""
    h = v = 0
    p = 0
    for n, op in cigar:
        if op == "M":
            for _ in range(n):
                if not (a[h] == b[v] or
                        (wildcards and (_wild(a[h]) or _wild(b[v])))):
                    p += x
                h += 1
                v += 1
        elif op == "I":
            p += min(o1 + n * e1, o2 + n * e2)
            v += n
        elif op == "D":
            p += min(o1 + n * e1, o2 + n * e2)
            h += n
    return p


def affine2p_penalty_golden(a: bytes, b: bytes, *, x: int, o1: int,
                            e1: int, o2: int, e2: int,
                            wildcards: bool = False) -> int:
    """O(nm) min-penalty dual-affine DP (numpy, host): the independent
    golden for the affine2p WFA kernels — Gotoh with five planes
    (M, I1, D1, I2, D2), gap cost min over the two affine classes."""
    n1, n2 = len(a), len(b)
    INF = 1 << 29
    av = np.frombuffer(a, dtype=np.uint8).astype(np.int32)
    bv = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
    sub = (av[:, None] != bv[None, :]).astype(np.int64) * x
    if wildcards:
        wild = ((av[:, None] < 58) | (av[:, None] == 78) |
                (bv[None, :] < 58) | (bv[None, :] == 78))
        sub = np.where(wild, 0, sub)
    M = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I1 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D1 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    I2 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    D2 = np.full((n1 + 1, n2 + 1), INF, dtype=np.int64)
    M[0, 0] = 0
    for j in range(1, n2 + 1):
        I1[0, j] = o1 + j * e1
        I2[0, j] = o2 + j * e2
        M[0, j] = min(I1[0, j], I2[0, j])
    for i in range(1, n1 + 1):
        D1[i, 0] = o1 + i * e1
        D2[i, 0] = o2 + i * e2
        M[i, 0] = min(D1[i, 0], D2[i, 0])
    for i in range(1, n1 + 1):
        for j in range(1, n2 + 1):
            I1[i, j] = min(M[i, j - 1] + o1 + e1, I1[i, j - 1] + e1)
            D1[i, j] = min(M[i - 1, j] + o1 + e1, D1[i - 1, j] + e1)
            I2[i, j] = min(M[i, j - 1] + o2 + e2, I2[i, j - 1] + e2)
            D2[i, j] = min(M[i - 1, j] + o2 + e2, D2[i - 1, j] + e2)
            M[i, j] = min(M[i - 1, j - 1] + sub[i - 1, j - 1],
                          I1[i, j], D1[i, j], I2[i, j], D2[i, j])
    return int(M[n1, n2])


def cigar_to_aligned(a: bytes, b: bytes, cigar) -> Tuple[bytes, bytes]:
    """Expand a [(count, op)] CIGAR over (a, b) into the gapped aligned
    pair (a_aligned, b_aligned); gaps are '-'."""
    out_a = bytearray()
    out_b = bytearray()
    h = v = 0
    for n, op in cigar:
        if op == "M":
            out_a += a[h:h + n]
            out_b += b[v:v + n]
            h += n
            v += n
        elif op == "I":
            out_a += b"-" * n
            out_b += b[v:v + n]
            v += n
        elif op == "D":
            out_a += a[h:h + n]
            out_b += b"-" * n
            h += n
    return bytes(out_a), bytes(out_b)


def wfa_backtrace_ops_2p(ops: np.ndarray, scores: np.ndarray,
                         k_targets: np.ndarray, *, x: int, o1: int,
                         e1: int, o2: int, e2: int) -> list:
    """Host lockstep backtrace for the dual-affine op store. Walks 5 states
    (M, I1, D1, I2, D2); gap class only changes the score decrement — the
    emitted skeleton ops stay {'X','I','i','D','d'} so wfa_replay_cigar
    works unchanged. Returns per-lane forward-order op lists (None for
    censored lanes)."""
    S1, B, K = ops.shape
    smax = (K - 1) // 2
    alive = (scores >= 0) & (scores < S1)
    s = np.where(alive, scores, 0).astype(np.int64)
    k = np.where(alive, k_targets, 0).astype(np.int64)
    state = np.zeros(B, dtype=np.int8)  # 0=M 1=I1 2=D1 3=I2 4=D2
    done = ~alive
    rev_ops: list = [[] for _ in range(B)]
    # (state id, op char, diag step, ext-bit shift, o, e)
    GAPS = ((1, "I", +1, 3, o1, e1), (2, "D", -1, 4, o1, e1),
            (3, "I", +1, 5, o2, e2), (4, "D", -1, 6, o2, e2))
    guard = 0
    while not done.all():
        guard += 1
        if guard > 4 * S1 + 8:
            raise RuntimeError("wfa affine2p backtrace failed to converge")
        byte = ops[s, np.arange(B), k + smax]
        m_src = byte & 7

        in_m = (state == 0) & ~done
        finish = in_m & (s == 0)
        done |= finish
        act_m = in_m & ~finish
        mm = act_m & (m_src == 1)
        for idx in np.nonzero(mm)[0]:
            rev_ops[idx].append("X")
        s = np.where(mm, s - x, s)
        for st in (2, 3, 4, 5):
            state = np.where(act_m & (m_src == st), st - 1, state)

        # lanes that just switched out of M wait for the next pass (the
        # byte re-read at the same (s, k) is correct)
        claimed = in_m
        for st, opch, dk, shift, o, e in GAPS:
            in_g = (state == st) & ~done & ~claimed
            claimed = claimed | in_g
            if not in_g.any():
                continue
            g_ext = (byte >> shift) & 1
            for idx in np.nonzero(in_g)[0]:
                rev_ops[idx].append(opch.lower() if g_ext[idx] else opch)
            s = np.where(in_g, s - np.where(g_ext == 1, e, o + e), s)
            k = np.where(in_g, k + dk, k)
            state = np.where(in_g & (g_ext == 0), 0, state)
    return [list(reversed(r)) if a else None
            for r, a in zip(rev_ops, alive)]


def wfa_backtrace_ops(ops: np.ndarray, scores: np.ndarray,
                      k_targets: np.ndarray, *, x: int, o: int,
                      e: int) -> list:
    """Host lockstep backtrace over the packed affine op store: walk every
    lane's op skeleton (non-match ops only; matches are re-derived by
    replay). ops is [S+1, B, K] u8, scores the penalties, k_targets =
    l1 - l2. Returns per-lane lists of ops in FORWARD order from
    {'X','I','i','D','d'} (None for censored lanes)."""
    S1, B, K = ops.shape
    smax = (K - 1) // 2
    alive = (scores >= 0) & (scores < S1)  # censored lanes excluded
    s = np.where(alive, scores, 0).astype(np.int64)
    k = np.where(alive, k_targets, 0).astype(np.int64)
    state = np.zeros(B, dtype=np.int8)  # 0=M 1=I 2=D
    done = ~alive
    rev_ops: list = [[] for _ in range(B)]
    guard = 0
    while not done.all():
        guard += 1
        if guard > 4 * S1 + 8:
            raise RuntimeError("wfa backtrace failed to converge")
        byte = ops[s, np.arange(B), k + smax]
        m_src = byte & 3
        i_ext = (byte >> 2) & 1
        d_ext = (byte >> 3) & 1

        in_m = (state == 0) & ~done
        finish = in_m & (s == 0)
        done |= finish
        act_m = in_m & ~finish
        # M from mismatch
        mm = act_m & (m_src == 1)
        for idx in np.nonzero(mm)[0]:
            rev_ops[idx].append("X")
        s = np.where(mm, s - x, s)
        state = np.where(act_m & (m_src == 2), 1, state)
        state = np.where(act_m & (m_src == 3), 2, state)

        # lanes that JUST switched to I/D this iteration (in_m) wait for
        # the next pass: their byte was read at the same (s, k), and the
        # re-read is correct
        in_i = (state == 1) & ~done & ~in_m
        for idx in np.nonzero(in_i)[0]:
            # lowercase = gap-extend step, uppercase = gap OPEN (the first
            # op of the gap in forward order)
            rev_ops[idx].append("i" if i_ext[idx] else "I")
        i_to_m = in_i & (i_ext == 0)
        s = np.where(in_i, s - np.where(i_ext == 1, e, o + e), s)
        k = np.where(in_i, k + 1, k)
        state = np.where(i_to_m, 0, state)

        in_d = (state == 2) & ~done & ~in_m & ~in_i
        for idx in np.nonzero(in_d)[0]:
            rev_ops[idx].append("d" if d_ext[idx] else "D")
        d_to_m = in_d & (d_ext == 0)
        s = np.where(in_d, s - np.where(d_ext == 1, e, o + e), s)
        k = np.where(in_d, k - 1, k)
        state = np.where(d_to_m, 0, state)
    return [list(reversed(r)) if a else None
            for r, a in zip(rev_ops, alive)]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _pad_pairs(refs, reads, B: int, L: int):
    """[B, L] u8 rows and [B] i32 lengths of the pairs, zero-padded."""
    a = np.zeros((B, L), dtype=np.uint8)
    b = np.zeros((B, L), dtype=np.uint8)
    la = np.zeros(B, dtype=np.int32)
    lb = np.zeros(B, dtype=np.int32)
    for j, (r, d) in enumerate(zip(refs, reads)):
        a[j, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        b[j, :len(d)] = np.frombuffer(d, dtype=np.uint8)
        la[j], lb[j] = len(r), len(d)
    return a, b, la, lb


def _ceil_pow2(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _decode_runs(runs_np, fin_np, lens) -> list:
    """The CIGARs [(count, op)] of the first len(lens) lanes of a
    wfa_align launch from its run words and end rows (None where
    censored), lens their (l1, l2). Raises RuntimeError where a walk did
    not converge, and wfa_replay_cigar's ValueError where a replay did not
    end at (l1, l2). One pass of numpy over the rows, then one list of
    (count, op) pairs cut into the lanes' CIGARs: no loop over ops."""
    n = len(lens)
    fins = fin_np[:n].tolist()
    rows = runs_np[:n]
    # each walked lane's words up to its 0; none of the others'
    ends = np.where(fin_np[:n] == -1, (rows == 0).argmax(1), 0)
    for b, f in enumerate(fins):
        if f not in (-1, -2):
            raise RuntimeError(f"wfa device walk failed to converge (lane "
                               f"{b}, fin={f})")
        if ends[b] and rows[b, 0] & 3 == RUN_FAULT:
            raise ValueError(
                f"wfa replay did not consume both sequences: "
                f"({rows[b, 0] >> 2},{rows[b, 1] >> 2}) vs "
                f"({lens[b][0]},{lens[b][1]})")
    flat = rows[np.arange(rows.shape[1])[None, :] < ends[:, None]]
    runs = list(zip((flat >> 2).tolist(),
                    map(RUN_OPS.__getitem__, (flat & 3).tolist())))
    out, lo = [], 0
    for f, k in zip(fins, ends.tolist()):
        out.append(runs[lo:lo + k] if f == -1 else None)
        lo += k
    return out


def _tally_cigars(stats, dev, n: int) -> None:
    """Count n CIGARs that came from wfa_align's runs on `stats`: built on
    the card where dev is a CUDA device, else by the plain replay."""
    if stats is None:
        return
    if dev.type == "cuda":
        stats.cigars_from_card += n
    else:
        stats.cigars_replayed += n


class _Launch:
    """One dispatched wfa_align chunk: its penalties, run words and end
    rows on their way to the host, and the event that says they are
    there."""

    def __init__(self, pen, runs, fin, stream):
        if stream is None:
            self.host = (pen.numpy(), runs.numpy(), fin.numpy())
            self.event = None
            return
        with torch.cuda.stream(stream):
            host = []
            for t in (pen, runs, fin):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        self.host = host

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.host = tuple(t.numpy() for t in self.host)
            self.event = None
        return self.host


class WfaAligner:
    """Pipeline-facing batched WFA engine with traceback
    (clique_tpu/align/wavefront.py:1652-2135), on one device.

    Drop-in for BatchAligner.align_pairs: align_pairs(refs, reads) ->
    [(ref_aligned, read_aligned, cigar, score)]. Pairs are batched by
    padded length and run with a small score ceiling; censored pairs retry
    at 2x the ceiling, and pairs still censored past 2*L fall back to the
    exact DP (dp_fallback). The reported score is the NEGATED WFA penalty.
    model="affine2p" is the dual-affine ("convex") penalty set: gap cost
    min(o + n*e, o2 + n*e2); its pairs past the ceiling rerun at a
    guaranteed-sufficient one.

    On a CUDA device every chunk goes out on one explicit stream: its H2D
    copies, the wfa_align kernel (fill, then the walk and the CIGAR's
    replay on the card) and non-blocking copies of the penalties, run
    words and end rows into pinned host memory, followed by an event. On a
    CPU device the plain versions run at dispatch.

    `cigars_from_card` and `cigars_replayed` count the CIGARs of its rung,
    rerun, fallback and bialign leaf lanes by where they were built: on
    the card, or by the plain version's host replay."""

    def __init__(self, x: int = 4, o: int = 6, e: int = 2,
                 batch_size: int = 512, length_quantum: int = 128,
                 wildcards: bool = True, s0: Optional[int] = None,
                 dp_fallback=None, model: str = "affine",
                 o2: int = 24, e2: int = 1, kband: Optional[int] = None,
                 adaptive: Optional[int] = None, device="cuda"):
        if model not in ("affine", "affine2p"):
            raise ValueError(f"unknown WFA penalties model: {model}")
        self.model = model
        self.x, self.o, self.e = x, o, e
        self.o2, self.e2 = o2, e2
        self.batch_size = batch_size
        self.quantum = length_quantum
        self.wildcards = wildcards
        self.s0 = s0
        # optional heuristic diagonal band for the first round; censored
        # pairs retry without it. None = exact band only (default).
        self.kband = kband
        # optional wf-adaptive trim margin for the first round; censored
        # pairs retry untrimmed. CLIQUE_WFA_ADAPTIVE sets one globally.
        if adaptive is None:
            env_a = os.environ.get("CLIQUE_WFA_ADAPTIVE")
            adaptive = int(env_a) if env_a else None
        self.adaptive = adaptive
        self.dp_fallback = dp_fallback  # BatchAligner or None
        self.device = _device(device)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
        self.pairs_aligned = 0
        self.cells_filled = 0           # DP-equivalent n*m cells
        self.device_seconds = 0.0
        self.post_seconds = 0.0
        self.fallbacks = 0
        self.bialign_pairs = 0          # pairs finished by the bialign engine
        self.dispatches = 0             # wfa_align launches (or plain runs)
        self.rung_lanes = 0             # lanes launched on the rung ladder
        self.rung_lanes_censored = 0    # of them, lanes censored there
        self.mid_levels = 0             # the bialign engine's split levels
        self.leaf_pairs = 0             # segments sent to its leaf chunks
        self.cigars_from_card = 0       # CIGARs built by wfa_align's replay
        self.cigars_replayed = 0        # CIGARs of the plain host replay

    def _kmax(self, L: int, smax: int, kband: Optional[int]) -> int:
        """The kernel's diagonal half-width for [B, L] rows at smax."""
        return wfa_kernels.kmax_of(self.model, L, L, smax, self.o, self.e,
                                   self.o2, self.e2, kband)

    def _dispatch(self, a, b, la, lb, *, L, smax, kband=None,
                  adaptive=None) -> _Launch:
        """One wfa_align launch over padded [B, L] rows."""
        dev = self.device
        self.dispatches += 1
        host = (a, b, la, lb)
        if self.stream is None:
            out = wfa_kernels.wfa_align(
                *(torch.from_numpy(t) for t in host), smax=smax,
                model=self.model, x=self.x, o=self.o, e=self.e, o2=self.o2,
                e2=self.e2, wildcards=self.wildcards, kband=kband,
                adaptive=adaptive)
            return _Launch(out[0], out[4], out[3], None)
        with torch.cuda.stream(self.stream):
            args = [torch.from_numpy(t).to(dev, non_blocking=True)
                    for t in host]
            pen, _ops, _fwd, fin, runs = wfa_kernels.wfa_align(
                *args, smax=smax, model=self.model, x=self.x, o=self.o,
                e=self.e, o2=self.o2, e2=self.e2, wildcards=self.wildcards,
                kband=kband, adaptive=adaptive, stream=self.stream)
            return _Launch(pen, runs, fin, self.stream)

    @staticmethod
    def _decode_walk(ops_np, fin_np, n: int) -> list:
        """The first n lanes' skeleton lists from a walk's (ops_fwd, fin)
        (None where censored): the plain replay's input
        (wfa_kernels.wfa_runs_reference)."""
        out = []
        for b in range(n):
            if fin_np[b] == -2:
                out.append(None)
                continue
            if fin_np[b] != -1:
                raise RuntimeError(
                    f"wfa device walk failed to converge (lane {b}, "
                    f"fin={fin_np[b]})")
            row = ops_np[b]
            out.append([chr(c) for c in row[row != 0]])
        return out

    def _bucket_len(self, n: int) -> int:
        q = self.quantum
        return max(q, -(-n // q) * q)

    def _budget(self) -> int:
        # the JAX package's op-store budgets (512 MiB affine, 2 GiB
        # affine2p), kept as they are: they decide which pairs escalate,
        # fall back or go to bialign, so they decide output bytes
        default = (2 << 30) if self.model == "affine2p" else (512 << 20)
        return int(os.environ.get("CLIQUE_WFA_MEM_BUDGET", str(default)))

    def _chunk_bytes(self, B: int, L: int, smax: int,
                     kband: Optional[int] = None) -> int:
        """The JAX package's estimate of one chunk's device footprint: the
        [smax+1, B, K] op store plus its packed bitmap/wordrun tables
        (8 bytes per 32 offsets) and the [B, K, H] bool intermediate of
        their build (wavefront.py:1808-1817)."""
        K = 2 * self._kmax(L, smax, kband) + 1
        W = (L + 33) // 32
        return B * K * ((smax + 1) + 8 * W + (L + 2))

    def _mem_cap(self, L: int, smax: int,
                 kband: Optional[int] = None) -> int:
        """Largest power-of-2 lane count whose chunk footprint fits the
        budget; floors at 32 lanes."""
        budget = self._budget()
        b = 32
        while self._chunk_bytes(b * 2, L, smax, kband) <= budget:
            b *= 2
        return b

    def align_pairs(self, refs, reads):
        """Per retry round, every chunk of every length bucket of a wave is
        dispatched before any result is waited for; then each chunk's run
        words are decoded into CIGARs on the host.

        Spans: `wfa.align_pairs` the call; inside it `wfa.round` a wave of a
        rung round's dispatches, `wfa.wait` a chunk's wait for its results,
        `wfa.walk` its run words' decode (`wfa.decode`) and its lanes'
        results (`wfa.replay`), and `wfa.bialign` the bialign engine's
        run."""
        with span("wfa.align_pairs"):
            return self._align_pairs(refs, reads)

    def _align_pairs(self, refs, reads):
        results = [None] * len(refs)
        t0 = time.time()
        fallback: list = []
        bialign_pool: list = []  # affine pairs routed to the O(s)-memory
        #                          bialign engine (op store over budget)
        buckets: dict = {}
        for k in range(len(refs)):
            L = self._bucket_len(max(len(refs[k]), len(reads[k])))
            buckets.setdefault(L, []).append(k)
        work = []                # (L, smax, idxs, kband, adaptive)
        for L in sorted(buckets):
            if L + 1 >= (1 << 15):
                # ultra-long pairs go to the exact DP
                fallback.extend(buckets[L])
                continue
            if self.s0 is not None:
                idxs = sorted(buckets[L], key=lambda k:
                              abs(len(refs[k]) - len(reads[k])))
                work.append((L, self.s0, idxs, self.kband, self.adaptive))
                continue
            # penalty-aware initial ceilings: a pair's length gap d
            # lower-bounds its penalty, so such a lane starts on the
            # smallest rung of the base*2^n ladder above bound + base/4
            base = max(64, L // 4)
            rungs: dict = {}
            for k in buckets[L]:
                d = abs(len(refs[k]) - len(reads[k]))
                bound = 0 if d == 0 else min(
                    self.o + self.e * d, self.o2 + self.e2 * d) \
                    if self.model == "affine2p" else self.o + self.e * d
                s = base
                while s < bound + base // 4:
                    s *= 2
                rungs.setdefault(s, []).append(k)
            for s, idxs in sorted(rungs.items()):
                if self.model == "affine" and \
                        self._chunk_bytes(32, L, s, self.kband) > \
                        self._budget():
                    # even a floor chunk's op store is over the budget:
                    # these pairs go to the bialign engine
                    bialign_pool.extend(idxs)
                    continue
                idxs.sort(key=lambda k: abs(len(refs[k]) - len(reads[k])))
                work.append((L, s, idxs, self.kband, self.adaptive))
        wave_budget = 2 * self._budget()
        while work:
            # this round's chunks, run in waves whose summed footprint
            # stays inside 2x the budget (a floor chunk over the budget
            # runs alone)
            chunks = []
            for (L, smax, idxs, kband, adaptive) in work:
                cap = min(self.batch_size, self._mem_cap(L, smax, kband))
                for lo in range(0, len(idxs), cap):
                    chunks.append((L, smax, idxs[lo:lo + cap], kband,
                                   adaptive, cap))
            censored: dict = {}        # (L, smax) -> [indices]
            pos = 0
            while pos < len(chunks):
                disp = []
                used = 0
                with span("wfa.round"):
                    while pos < len(chunks):
                        L, smax, chunk, kband, adaptive, cap = chunks[pos]
                        nbytes = self._chunk_bytes(cap, L, smax, kband)
                        if disp and used + nbytes > wave_budget:
                            break
                        used += nbytes
                        pos += 1
                        a, b, la, lb = _pad_pairs(
                            [refs[k] for k in chunk],
                            [reads[k] for k in chunk], len(chunk), L)
                        disp.append((chunk, L, smax, self._dispatch(
                            a, b, la, lb, L=L, smax=smax, kband=kband,
                            adaptive=adaptive)))
                        self.rung_lanes += len(chunk)
                for (chunk, L, smax, launch) in disp:
                    with span("wfa.wait"):
                        sc, runs_np, fin_np = launch.wait()
                    with span("wfa.walk"):
                        self._walk_chunk(chunk, sc, runs_np, fin_np, refs,
                                         reads, results,
                                         censored.setdefault((L, smax), []))
                del disp
            # next round: censored pairs retry at 2x the ceiling, without
            # the heuristic band and trim
            work = []
            for (L, smax), idxs in censored.items():
                if not idxs:
                    continue
                if smax > 2 * L:
                    fallback.extend(idxs)
                elif self.model == "affine" and \
                        self._chunk_bytes(32, L, smax * 2, None) > \
                        self._budget():
                    # escalation would pass the op-store budget: these
                    # finish on the bialign engine
                    bialign_pool.extend(idxs)
                else:
                    work.append((L, smax * 2, idxs, None, None))
        if bialign_pool:
            self._bialign_fill(bialign_pool, refs, reads, results)
        self.device_seconds += time.time() - t0
        self.pairs_aligned += len(refs)
        if fallback:
            self._dp_fallback_fill(fallback, refs, reads, results)
        return results

    def _walk_chunk(self, chunk, sc, runs_np, fin_np, refs, reads, results,
                    miss):
        """A rung chunk's results: its lanes' CIGARs decoded from their run
        words, then each walked lane's result into `results`; censored
        lanes appended to `miss`."""
        with span("wfa.decode"):
            cigars = _decode_runs(runs_np, fin_np,
                                  [(len(refs[k]), len(reads[k]))
                                   for k in chunk])
        with span("wfa.replay"):
            for j, k in enumerate(chunk):
                cig = cigars[j]
                if cig is None:
                    miss.append(k)
                    self.rung_lanes_censored += 1
                    continue
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(sc[j]))
                self.cells_filled += len(refs[k]) * len(reads[k])
            _tally_cigars(self, self.device,
                          sum(c is not None for c in cigars))

    def _bialign_fill(self, idxs, refs, reads, results):
        """The pairs idxs on the bialign engine (wavefront.py:2031-2039,
        :2117-2125): score the negated penalty."""
        with span("wfa.bialign"):
            outs = wfa_bialign_affine_pairs(
                [refs[k] for k in idxs], [reads[k] for k in idxs], x=self.x,
                o=self.o, e=self.e, wildcards=self.wildcards,
                device=self.device, stats=self)
            for k, (pen, cig) in zip(idxs, outs):
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(pen))
                self.cells_filled += len(refs[k]) * len(reads[k])
        self.bialign_pairs += len(idxs)

    def _dp_fallback_fill(self, remaining, refs, reads, results):
        """Pairs beyond the WFA score cap. affine2p pairs rerun the affine2p
        kernel at a guaranteed-sufficient ceiling (quantized to 1024)
        where its op store fits the budget; the rest go to the exact-DP
        fallback."""
        self.fallbacks += len(remaining)
        if self.model == "affine2p":
            long_pairs = []
            rerun_buckets: dict = {}
            for k in remaining:
                L = self._bucket_len(max(len(refs[k]), len(reads[k])))
                if L + 1 >= (1 << 15):
                    long_pairs.append(k)
                    continue
                rerun_buckets.setdefault(L, []).append(k)
            for L, idxs in rerun_buckets.items():
                smax = max(
                    min(2 * self.o + self.e * 2
                        * max(len(refs[k]), len(reads[k])),
                        2 * self.o2 + self.e2 * 2
                        * max(len(refs[k]), len(reads[k])))
                    for k in idxs) + 1
                smax = -(-smax // 1024) * 1024   # quantize the ceiling
                if self._chunk_bytes(32, L, smax) > self._budget():
                    long_pairs.extend(idxs)
                    continue
                for c0 in range(0, len(idxs), 32):
                    chunk = idxs[c0:c0 + 32]
                    a, b, la, lb = _pad_pairs(
                        [refs[k] for k in chunk], [reads[k] for k in chunk],
                        32, L)
                    sc, runs_np, fin_np = self._dispatch(
                        a, b, la, lb, L=L, smax=smax).wait()
                    cigars = _decode_runs(runs_np, fin_np,
                                          [(len(refs[k]), len(reads[k]))
                                           for k in chunk])
                    _tally_cigars(self, self.device, len(chunk))
                    for j, (k, cig) in enumerate(zip(chunk, cigars)):
                        ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                        results[k] = (ra, da, cig, -float(sc[j]))
                        self.cells_filled += len(refs[k]) * len(reads[k])
            remaining = long_pairs
            if not remaining:
                return
        if self.dp_fallback is not None:
            out = self.dp_fallback.align_pairs(
                [refs[k] for k in remaining], [reads[k] for k in remaining])
            for k, r in zip(remaining, out):
                results[k] = r
        elif self.model == "affine" and all(
                _bialign_len_ok(max(len(refs[k]), len(reads[k])))
                for k in remaining):
            # no exact-DP engine attached: the bialign engine finishes
            # these without the full-bound op store of the direct kernel
            self._bialign_fill(remaining, refs, reads, results)
        else:
            for k in remaining:
                (pen, cig), = wfa_affine_align_pairs(
                    [refs[k]], [reads[k]], x=self.x, o=self.o, e=self.e,
                    wildcards=self.wildcards, device=self.device)
                _tally_cigars(self, self.device, 1)
                ra, da = cigar_to_aligned(refs[k], reads[k], cig)
                results[k] = (ra, da, cig, -float(pen))
                self.cells_filled += len(refs[k]) * len(reads[k])


def _bialign_len_ok(n: int) -> bool:
    """True when a pair of max raw length n fits the bialign split
    encoding: _mid_split_batch quantizes lengths up to a 128 multiple and
    rejects a quantized length >= MID_ENC // 2 (wavefront.py:430-439)."""
    return -(-max(n, 1) // 128) * 128 < MID_ENC // 2


def _mid_split_batch(pairs, *, x: int, o: int, e: int, wildcards: bool,
                     s0: Optional[int] = None, device="cuda"):
    """wfa_mid over (a, b) byte pairs with the 2x score-ceiling ladder
    (only censored pairs re-run), wavefront.py:1375-1428. Returns
    [(penalty, h, v)] per pair; (smax + 1, -1, -1) if censored at the hard
    bound (which cannot happen: 2 * (o + e * L) covers any pair). Each
    rung is one launch over the pending pairs, unpadded."""
    P = len(pairs)
    out = [None] * P
    pending = list(range(P))
    L = max(64, max(max(len(a), len(b)) for a, b in pairs))
    q = 128
    L = max(q, -(-L // q) * q)
    if L >= MID_ENC // 2:
        raise ValueError(f"bialign split encoding caps lengths at "
                         f"{MID_ENC // 2 - 1}; got {L}")
    hard = 2 * (o + e * L) + 1  # delete-all + insert-all upper bound
    if s0 is None:
        # lower-bound rung: the length gap alone costs o + e*d
        dmax = max(abs(len(a) - len(b)) for a, b in pairs)
        s0 = 64
        while s0 <= o + e * dmax:
            s0 *= 2
    smax = min(s0, hard)
    dev = _device(device)
    while pending:
        with span("wfa.mid"):
            host = _pad_pairs([pairs[i][0] for i in pending],
                              [pairs[i][1] for i in pending], len(pending),
                              L)
            pen, pay = wfa_kernels.wfa_mid(
                *(torch.from_numpy(t).to(dev) for t in host), smax=smax,
                x=x, o=o, e=e, wildcards=wildcards)
        with span("wfa.mid_wait"):
            pen, pay = pen.cpu().numpy(), pay.cpu().numpy()
        still = []
        for i, idx in enumerate(pending):
            if pen[i] <= smax and pay[i] >= 0:
                out[idx] = (int(pen[i]), int(pay[i]) // MID_ENC,
                            int(pay[i]) % MID_ENC)
            elif smax >= hard:
                out[idx] = (smax + 1, -1, -1)
            else:
                still.append(idx)
        pending = still
        smax = min(smax * 2, hard)
    return out


def wfa_bialign_affine_pairs(pairs_a, pairs_b, *, x: int = 4, o: int = 6,
                             e: int = 2, wildcards: bool = False,
                             leaf: int = 512, s0: Optional[int] = None,
                             device="cuda", stats=None):
    """O(s)-memory batched gap-affine alignment with traceback, the JAX
    package's bialign engine (wavefront.py:1431-1527; WFA2-lib's
    wavefront_bialign.o). Each level runs one midpoint sweep
    (_mid_split_batch) over every segment still longer than `leaf`, splits
    each at its on-path M-state cell and recurses; segments at or under
    `leaf` run the direct traceback kernel (wfa_affine_align_pairs) in
    chunks of 64. A segment whose split is degenerate (the path crosses
    the middle anti-diagonal inside an edge gap) runs the direct kernel
    at its full length.

    Returns [(penalty, cigar)] per pair: cigars merge adjacent runs, and
    the penalty is the top-level midpoint fill's optimum. `stats`, where
    given, counts the split levels on its `mid_levels`, the segments sent
    to leaf chunks on its `leaf_pairs` and their CIGARs on its
    `cigars_from_card` or `cigars_replayed` (_tally_cigars). Spans:
    `wfa.mid` a level's rung launch and `wfa.mid_wait` its copy back
    (_mid_split_batch), `wfa.leaves` a leaf chunk."""
    n = len(pairs_a)
    results: list = [None] * n
    top_pen = [None] * n
    # segment worklist: (pair idx, order path, a, b, forced_leaf)
    segs = [(i, (), bytes(a), bytes(b), False)
            for i, (a, b) in enumerate(zip(pairs_a, pairs_b))]
    leaves: list = []
    while segs:
        split_jobs = []
        nxt: list = []
        for seg in segs:
            i, path, a, b, forced = seg
            if not a or not b:
                leaves.append(seg)
            elif forced or max(len(a), len(b)) <= leaf:
                leaves.append(seg)
            else:
                split_jobs.append(seg)
        if not split_jobs:
            break
        if stats is not None:
            stats.mid_levels += 1
        outs = _mid_split_batch([(s[2], s[3]) for s in split_jobs],
                                x=x, o=o, e=e, wildcards=wildcards, s0=s0,
                                device=device)
        for (i, path, a, b, _f), (pen, h, v) in zip(split_jobs, outs):
            if not path and h >= 0:
                top_pen[i] = pen
            if h < 0:
                leaves.append((i, path, a, b, True))
            elif (h, v) in ((0, 0), (len(a), len(b))):
                # path crosses mid inside an edge gap: no shrink possible
                leaves.append((i, path, a, b, True))
            else:
                nxt.append((i, path + (0,), a[:h], b[:v], False))
                nxt.append((i, path + (1,), a[h:], b[v:], False))
        segs = nxt

    # resolve leaves: gap-only segments directly, the rest batched tb
    pieces: dict = {}
    tb_jobs = []
    for i, path, a, b, _f in leaves:
        if not a and not b:
            pieces[(i, path)] = []
        elif not a:
            pieces[(i, path)] = [(len(b), "I")]
        elif not b:
            pieces[(i, path)] = [(len(a), "D")]
        else:
            tb_jobs.append((i, path, a, b))
    # chunked leaf batches: the direct kernel's op store is O(smax*B*K)
    for lo in range(0, len(tb_jobs), 64):
        sl_jobs = tb_jobs[lo:lo + 64]
        with span("wfa.leaves"):
            outs = wfa_affine_align_pairs([j[2] for j in sl_jobs],
                                          [j[3] for j in sl_jobs],
                                          x=x, o=o, e=e, wildcards=wildcards,
                                          device=device)
        if stats is not None:
            stats.leaf_pairs += len(sl_jobs)
            _tally_cigars(stats, _device(device), len(sl_jobs))
        for (i, path, a, b), (pen, cig) in zip(sl_jobs, outs):
            if cig is None:  # unreachable: full-bound smax never censors
                raise RuntimeError("bialign leaf censored at full bound")
            pieces[(i, path)] = cig

    by_pair: dict = {}
    for (i, p), cig in pieces.items():
        by_pair.setdefault(i, []).append((p, cig))
    for i in range(n):
        merged: list = []
        for _p, cig in sorted(by_pair.get(i, [])):
            for run_ in cig:
                if merged and merged[-1][1] == run_[1]:
                    merged[-1] = (merged[-1][0] + run_[0], run_[1])
                else:
                    merged.append(run_)
        pen = top_pen[i]
        if pen is None:  # pair went straight to a leaf (short/empty)
            pen = cigar_penalty(merged, pairs_a[i], pairs_b[i],
                                x=x, o=o, e=e, wildcards=wildcards)
        results[i] = (pen, merged)
    return results


def wfa_affine_align_pairs(pairs_a, pairs_b, *, x: int = 4, o: int = 6,
                           e: int = 2, smax=None, wildcards: bool = False,
                           pad_to: int = 64, device="cuda"):
    """Batched gap-affine WFA with traceback over byte pairs
    (wavefront.py:1334-1372): [(penalty, cigar)] per pair, cigar None
    where the pair was censored at smax (penalty smax + 1). One wfa_align
    launch; its penalties, end rows and run words come back in pinned
    memory behind one event."""
    if not pairs_a:
        return []
    L = max(pad_to, max(max(len(a) for a in pairs_a),
                        max(len(b) for b in pairs_b)))
    P = len(pairs_a)
    a, b, la, lb = _pad_pairs(pairs_a, pairs_b, _ceil_pow2(P), L)
    if smax is None:
        smax = x + o + e * L  # worst case bound: all-gap then mismatches
    dev = _device(device)
    pen, _ops, _fwd, fin, runs = wfa_kernels.wfa_align(
        *(torch.from_numpy(t).to(dev) for t in (a, b, la, lb)), smax=smax,
        model="affine", x=x, o=o, e=e, wildcards=wildcards)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    pen, runs, fin = _Launch(pen, runs, fin, stream).wait()
    cigars = _decode_runs(runs, fin, [(len(pa), len(pb))
                                      for pa, pb in zip(pairs_a, pairs_b)])
    return list(zip(pen[:P].tolist(), cigars))


def wfa_screen_candidates(refs, reads, *, x: int = 4, o: int = 6,
                          e: int = 2, smax: Optional[int] = None,
                          pad_to: int = 64, model: str = "affine",
                          o2: int = 24, e2: int = 1,
                          device="cuda") -> np.ndarray:
    """Score-only candidate screen for exhaustive reference search
    (wavefront.py:2136-2173): the WFA penalty of each (ref, read) pair,
    censored at smax (censored pairs return smax + 1 and rank last), in
    one wfa_score launch of exactly the P pairs (the JAX function pads P
    to a power of two for XLA's compile reuse; the kernel needs no such
    pad). model="affine2p" screens under the dual-affine penalties."""
    if not refs:
        return np.zeros(0, dtype=np.int32)
    P = len(refs)
    L = max(pad_to, max(max(len(r) for r in refs),
                        max(len(d) for d in reads)))
    if smax is None:
        smax = max(64, L // 2)
    a, b, la, lb = _pad_pairs(refs, reads, P, L)
    dev = _device(device)
    pen = wfa_kernels.wfa_score(
        *(torch.from_numpy(t).to(dev) for t in (a, b, la, lb)), smax=smax,
        model=model, x=x, o=o, e=e, o2=o2, e2=e2, wildcards=True)
    return pen.cpu().numpy()


# --- gap-linear penalties and edit distance ----------------------------------

def _pair_tensors(refs, reads, ref_lens, read_lens, dev):
    """The four inputs as contiguous tensors on `dev` (numpy arrays or
    tensors): u8 rows, i32 lengths."""
    out = []
    for t, dtype in ((refs, torch.uint8), (reads, torch.uint8),
                     (ref_lens, torch.int32), (read_lens, torch.int32)):
        t = t if torch.is_tensor(t) else torch.from_numpy(np.asarray(t))
        out.append(t.to(device=dev, dtype=dtype).contiguous())
    return out


def wfa_linear_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                     smax: int, x: int = 4, e: int = 2,
                     wildcards: bool = False, kband: Optional[int] = None,
                     device="cuda") -> torch.Tensor:
    """Batched gap-LINEAR WFA (WFA2-lib's wavefront_compute_linear.o,
    wavefront.py:232-316): penalties mismatch=x, per-base indel=e, no
    gap-open term. refs [B, n1], reads [B, n2] u8 row-padded, lengths [B]
    i32 (numpy arrays or tensors). Returns the minimal penalty [B] i32 on
    `device` (smax + 1 censored). One wfa_score launch under the "linear"
    model (the kernel's G = 0) on a CUDA device, its plain version on the
    CPU; diagonals |k| <= min(n1 + n2, smax, smax // e, kband)."""
    dev = _device(device)
    args = _pair_tensors(refs, reads, ref_lens, read_lens, dev)
    kb = n1 + n2 if kband is None else min(kband, n1 + n2)
    return wfa_kernels.wfa_score(*args, smax=smax, model="linear", x=x, e=e,
                                 wildcards=wildcards, kband=kb)


def wfa_edit_batch(refs, reads, ref_lens, read_lens, *, n1: int, n2: int,
                   smax: int, device="cuda") -> torch.Tensor:
    """Batched WFA edit distance (wavefront.py:166-229): [B] i32 on
    `device` (smax + 1 if censored), diagonals |k| <= min(n1 + n2, smax).
    The gap-linear fill at x = e = 1 without wildcards: its clamp's
    v >= 0 and k-range terms, which wfa_edit_batch's leaner loop leaves
    out, hold for every finite offset anyway."""
    return wfa_linear_batch(refs, reads, ref_lens, read_lens, n1=n1, n2=n2,
                            smax=smax, x=1, e=1, device=device)


def wfa_edit_distances(pairs_a, pairs_b, smax=None, pad_to: int = 64,
                       device="cuda") -> np.ndarray:
    """Host wrapper: exact edit distances via the wavefront kernel
    (wavefront.py:2178-2199), i32 [P]. Rows of L = max(pad_to, longest)
    bytes; smax defaults to 2 * L. One launch of exactly the P pairs (the
    JAX function pads P to a power of two for XLA's compile reuse)."""
    if not pairs_a:
        return np.zeros(0, dtype=np.int32)
    L = max(pad_to, max(max(len(a) for a in pairs_a),
                        max(len(b) for b in pairs_b)))
    a, b, la, lb = _pad_pairs(pairs_a, pairs_b, len(pairs_a), L)
    if smax is None:
        smax = 2 * L
    return wfa_edit_batch(a, b, la, lb, n1=L, n2=L, smax=smax,
                          device=device).cpu().numpy()
