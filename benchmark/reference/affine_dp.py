"""Plain global affine DP with traceback, batched over pairs in plain
PyTorch: the semantics the program's `dp_align` must reproduce exactly.

Three planes over (reference x, read y): 0 = match/mismatch, 1 = deletion
(consumes the reference), 2 = insertion (consumes the read).

    M[x,y] = max3(D[x-1,y-1] + s, I[x-1,y-1] + s, M[x-1,y-1] + s)
    D[x,y] = max3(D[x-1,y] + e', I[x-1,y] + o + e', M[x-1,y] + o + e')
    I[x,y] = max3(D[x,y-1] + o + e', I[x,y-1] + e', M[x,y-1] + o + e')

max3(up, left, diag) takes `up` only on strictly greater than both,
then `left` on strictly greater than `diag`, else `diag`; e' is the gap
extension times the terminal-gap multiplier on the pair's last row or
column. Borders: (0, 0) = (0, NEG, NEG); row or column k >= 1 holds NEG
in M and (o + k e) * multiplier in D and I. The walk starts at (l1, l2)
in the best plane (later planes win ties), follows each plane's stored
choice, and finishes with the leftover D or I bases. The rules are those
of the upstream aligner (rust_cmd alignment_matrix.rs:618-683, :941-1086).

Scores are dyadic, so float32 is exact here; `dtype` lets a control
compute the same recurrence in a lower precision.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

NEG = -100000.0
GAP = ord("-")

# (match, mismatch, special, gap open, gap extend, terminal-gap multiplier)
SCORINGS = {
    "aligner_default": (10.0, -9.0, 9.0, -20.0, -2.0, 1.0),
    "rust_bio_compat": (1.0, -1.0, 1.0, -5.0, -1.0, 1.0),
}


class Alignment(NamedTuple):
    score: float
    cigar: str
    ref_aligned: bytes
    read_aligned: bytes


def _rows(seqs: Sequence[bytes], device):
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.long)
    mat = np.zeros((len(seqs), max(1, int(lens.max()))), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(mat).to(device), lens.to(device)


def _max3(up, left, diag):
    up_wins = (up > left) & (up > diag)
    left_wins = ~(up > left) & (left > diag)
    val = torch.where(up_wins, up, torch.where(left_wins, left, diag))
    d = torch.where(up_wins, 1, torch.where(left_wins, 2, 0))
    return val, d.to(torch.uint8)


def _cigar(ops: np.ndarray) -> str:
    if not len(ops):
        return ""
    edges = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate(([0], edges))
    ends = np.concatenate((edges, [len(ops)]))
    return "".join(f"{e - s}{'MDI'[ops[s]]}" for s, e in zip(starts, ends))


def align_block(refs: Sequence[bytes], reads: Sequence[bytes], scoring,
                special_mode: str, device, dtype=torch.float32
                ) -> List[Alignment]:
    """Global alignments of refs[i] against reads[i]; special_mode is
    "ref_n_only" (a reference N scores `special`) or "both" (N or a byte
    below '0' + 10 on either side does)."""
    m_s, mm_s, sp_s, go, ge, fgm = scoring
    B = len(refs)
    R, l1 = _rows(refs, device)
    Q, l2 = _rows(reads, device)
    n1 = R.shape[1] + 1
    n2 = Q.shape[1] + 1
    xs = torch.arange(n1, device=device)
    rx = torch.nn.functional.pad(R.long(), (1, 0))              # [B, n1]
    Qp = torch.nn.functional.pad(Q.long(), (0, 1))
    L1, L2 = l1[:, None], l2[:, None]
    lane = (xs >= 1) & (xs <= L1)
    if special_mode == "ref_n_only":
        spec_x = rx == 78
    else:
        spec_x = (rx == 78) | (rx < 58)

    consts = {v: torch.tensor(v, dtype=dtype, device=device)
              for v in (m_s, mm_s, sp_s, go, ge, ge * fgm, 0.0)}

    def t(v):
        return consts[v]

    neg = torch.full((B, n1), NEG, dtype=dtype, device=device)
    border_row = ((go + xs.to(torch.float64) * ge) * fgm).to(dtype)  # [n1]
    pm = pd = pi = neg
    p2m = p2d = p2i = neg
    D = n1 + n2 - 1
    tb = torch.zeros((D, B, n1), dtype=torch.uint8, device=device)
    corner = torch.zeros((B, 3), dtype=dtype, device=device)
    cdiag = l1 + l2
    corner_steps = set(cdiag.tolist())

    def shift(v):
        return torch.nn.functional.pad(v[:, :-1], (1, 0), value=NEG)

    for d in range(D):
        y = d - xs                                               # [n1]
        ry = Qp[:, (y - 1).clamp(0, n2 - 1)]
        special = spec_x | ((ry == 78) | (ry < 58)) \
            if special_mode != "ref_n_only" else spec_x
        s = torch.where(special, t(sp_s), torch.where(rx == ry, t(m_s),
                                                      t(mm_s)))
        last = (xs == L1) | (y == L2)
        lge = torch.where(last, t(ge * fgm), t(ge))
        x1 = lge + t(go)
        m_val, m_dir = _max3(shift(p2d) + s, shift(p2i) + s, shift(p2m) + s)
        d_val, d_dir = _max3(shift(pd) + lge, shift(pi) + x1, shift(pm) + x1)
        i_val, i_dir = _max3(pd + x1, pi + lge, pm + x1)
        inside = lane & (y >= 1) & (y <= L2)
        y_border = lane & (y == 0)
        x_border = (xs == 0) & (y >= 1) & (y <= L2)
        origin = (xs == 0) & (y == 0)
        yb = border_row.expand(B, n1)
        xb = ((go + y.clamp(min=0).to(torch.float64) * ge) * fgm).to(dtype)
        m_out = torch.where(inside, m_val,
                            torch.where(origin, t(0.0), neg))
        d_out = torch.where(inside, d_val, torch.where(
            y_border, yb, torch.where(x_border, xb.expand(B, n1), neg)))
        i_out = torch.where(inside, i_val, torch.where(
            y_border, yb, torch.where(x_border, xb.expand(B, n1), neg)))
        tb[d] = torch.where(inside, m_dir | (d_dir << 2) | (i_dir << 4), 0)
        if d in corner_steps:
            on = cdiag == d
            c = torch.stack([v.gather(1, L1)[:, 0]
                             for v in (m_out, d_out, i_out)], 1)
            corner = torch.where(on[:, None], c, corner)
        p2m, p2d, p2i = pm, pd, pi
        pm, pd, pi = m_out, d_out, i_out

    # the starting plane: the largest, later planes winning ties
    z = torch.zeros(B, dtype=torch.long, device=device)
    best = corner[:, 0]
    for zz in (1, 2):
        take = corner[:, zz] >= best
        best = torch.where(take, corner[:, zz], best)
        z = torch.where(take, zz, z)
    score = best

    # the walk, from the corner back; ops written from the end
    T = n1 + n2
    ops = torch.full((B, T), 255, dtype=torch.uint8, device=device)
    x, yy = l1.clone(), l2.clone()
    ar = torch.arange(B, device=device)
    for k in range(T - 1, T - 1 - max(corner_steps), -1):
        inner = (x > 0) & (yy > 0)
        tail_d = ~inner & (x > 0)
        tail_i = ~inner & ~(x > 0) & (yy > 0)
        op = torch.where(inner, z, torch.where(tail_d, 1, 2))
        live = inner | tail_d | tail_i
        ops[:, k] = torch.where(live, op, 255).to(torch.uint8)
        dirs = tb[(x + yy).clamp(max=D - 1), ar, x.clamp(max=n1 - 1)].long()
        nz = (dirs >> (2 * z)) & 3
        z = torch.where(inner, nz, z)
        x = x - (live & (op != 2)).long()
        yy = yy - (live & (op != 1)).long()
    # the gapped rows, gathered on the device: each op consumes a reference
    # base unless it is an insertion and a read base unless a deletion
    live = ops != 255
    take_r = live & (ops != 2)
    take_q = live & (ops != 1)
    ri = (torch.cumsum(take_r.long(), 1) - 1).clamp(min=0)
    qi = (torch.cumsum(take_q.long(), 1) - 1).clamp(min=0)
    ra = torch.where(take_r, R.long().gather(1, ri.clamp(max=R.shape[1] - 1)),
                     GAP).to(torch.uint8)
    qa = torch.where(take_q, Q.long().gather(1, qi.clamp(max=Q.shape[1] - 1)),
                     GAP).to(torch.uint8)
    ops_h, ra_h, qa_h = (v.cpu().numpy() for v in (ops, ra, qa))
    score_h = score.double().cpu().numpy()
    n_ops = live.sum(1).cpu().numpy()
    # CIGAR runs over every row at once: a run starts where the op changes
    flat = ops_h[live.cpu().numpy()]
    row = np.repeat(np.arange(B), n_ops)
    start = np.flatnonzero(np.concatenate(
        ([True], (flat[1:] != flat[:-1]) | (row[1:] != row[:-1]))))
    lens = np.diff(np.concatenate((start, [len(flat)])))
    cig = [[] for _ in range(B)]
    for r, n, op in zip(row[start].tolist(), lens.tolist(),
                        flat[start].tolist()):
        cig[r].append(f"{n}{'MDI'[op]}")
    return [Alignment(float(score_h[i]), "".join(cig[i]),
                      ra_h[i, T - n_ops[i]:].tobytes(),
                      qa_h[i, T - n_ops[i]:].tobytes()) for i in range(B)]


def align(refs: Sequence[bytes], reads: Sequence[bytes], scoring: str,
          special_mode: str, device, dtype=torch.float32, block: int = 4096
          ) -> List[Alignment]:
    """align_block over blocks of `block` pairs."""
    sc = SCORINGS[scoring]
    out: List[Alignment] = []
    for s in range(0, len(refs), block):
        out.extend(align_block(refs[s:s + block], reads[s:s + block], sc,
                               special_mode, device, dtype))
    return out


def extract(al: Alignment, symbol: int) -> Tuple[int, bytes]:
    """The read's bytes in the columns where the reference holds `symbol`
    (a wildcard digit): (how many columns, the bytes, gaps included)."""
    ra = np.frombuffer(al.ref_aligned, np.uint8)
    qa = np.frombuffer(al.read_aligned, np.uint8)
    sel = ra == symbol
    return int(sel.sum()), qa[sel].tobytes()
