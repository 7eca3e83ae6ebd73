"""Plain pair-HMM forward log-likelihoods, batched over (reference, read)
pairs in plain PyTorch: what the program's `hmm_forward` must compute.

A 3-state pair-HMM (Match / Insert / Delete) in log space:

    M[x,y] = e(x,y) + LSE(M[x-1,y-1] + t_mm, I[x-1,y-1] + t_gc,
                          D[x-1,y-1] + t_gc)
    D[x,y] = LSE(M[x-1,y] + t_go, D[x-1,y] + t_ge)
    I[x,y] = LSE(M[x,y-1] + t_go, I[x,y-1] + t_ge)

with t_go = log p_open, t_ge = log p_extend, t_mm = log(1 - 2 p_open),
t_gc = log(1 - p_extend); M[0,0] = 0, D[x,0] = t_go + (x - 1) t_ge and
I[0,y] = t_go + (y - 1) t_ge on the borders, -inf elsewhere outside the
pair. A reference N or wildcard (a byte below '0' + 10), or a read N,
emits log 1/4; other bases emit log p_match or log((1 - p_match) / 3).
A pair's log-likelihood is LSE(M, I, D) at its (l1, l2) corner.

The model and its default parameters are the upstream router's (the JAX
package's align/hmm.py, ONT-flavoured: p_match 0.92, p_open 0.025,
p_extend 0.35). The reference runs in float64 from the probabilities;
`dtype` lets a control run the same recurrence in a lower precision.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

NEG = -1e30
DEFAULT = {"match": 0.92, "gap_open": 0.025, "gap_extend": 0.35}


def _rows(seqs: Sequence[bytes], device):
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.long)
    mat = np.zeros((len(seqs), max(1, int(lens.max()))), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(mat).to(device), lens.to(device)


def _lse(*vals):
    m = vals[0]
    for v in vals[1:]:
        m = torch.maximum(m, v)
    return m + torch.log(sum(torch.exp(v - m) for v in vals))


def forward_block(refs: Sequence[bytes], reads: Sequence[bytes], device,
                  dtype=torch.float64, params=DEFAULT) -> torch.Tensor:
    """[B] log-likelihoods of refs[i] against reads[i], in `dtype`."""
    R, l1 = _rows(refs, device)
    Q, l2 = _rows(reads, device)
    return forward_rows(R, l1, Q, l2, dtype, params)


def forward_rows(R: torch.Tensor, l1: torch.Tensor, Q: torch.Tensor,
                 l2: torch.Tensor, dtype=torch.float64, params=DEFAULT
                 ) -> torch.Tensor:
    """forward_block over byte rows already on a device: R [B, >= l1] and
    Q [B, >= l2] u8, zero-padded, with their lengths l1, l2 [B]."""
    device = R.device
    B = R.shape[0]
    l1, l2 = l1.long(), l2.long()
    n1, n2 = R.shape[1] + 1, Q.shape[1] + 1
    p = params
    lm, lx, lw = (math.log(p["match"]), math.log((1 - p["match"]) / 3),
                  math.log(0.25))
    go, ge = math.log(p["gap_open"]), math.log(p["gap_extend"])
    t_mm, t_gc = math.log1p(-2 * p["gap_open"]), math.log1p(-p["gap_extend"])

    consts = {v: torch.tensor(v, dtype=dtype, device=device)
              for v in (lm, lx, lw, go, ge, t_mm, t_gc, 0.0)}

    def c(v):
        return consts[v]

    xs = torch.arange(n1, device=device)
    rx = torch.nn.functional.pad(R.long(), (1, 0))
    Qp = torch.nn.functional.pad(Q.long(), (0, 1))
    L1, L2 = l1[:, None], l2[:, None]
    lane = (xs >= 1) & (xs <= L1)
    wild_x = (rx == 78) | (rx < 58)
    neg = torch.full((B, n1), NEG, dtype=dtype, device=device)
    d_border = (go + (xs - 1).to(torch.float64) * ge).to(dtype)
    pm = pd = pi = p2m = p2d = p2i = neg
    final = torch.full((B,), NEG, dtype=dtype, device=device)
    cdiag = l1 + l2
    corner_steps = set(cdiag.tolist())

    def shift(v):
        return torch.nn.functional.pad(v[:, :-1], (1, 0), value=NEG)

    for d in range(n1 + n2 - 1):
        y = d - xs
        ry = Qp[:, (y - 1).clamp(0, n2 - 1)]
        e = torch.where(wild_x | (ry == 78), c(lw),
                        torch.where(rx == ry, c(lm), c(lx)))
        m_val = e + _lse(shift(p2m) + c(t_mm), shift(p2i) + c(t_gc),
                         shift(p2d) + c(t_gc))
        d_val = _lse(shift(pm) + c(go), shift(pd) + c(ge))
        i_val = _lse(pm + c(go), pi + c(ge))
        inside = lane & (y >= 1) & (y <= L2)
        m_out = torch.where(inside, m_val, neg)
        if d == 0:
            m_out = torch.where(xs == 0, c(0.0), m_out)
        d_out = torch.where(lane & (y == 0), d_border.expand(B, n1),
                            torch.where(inside, d_val, neg))
        i_border = (go + (y - 1).clamp(min=0).to(torch.float64) * ge
                    ).to(dtype)
        i_out = torch.where((xs == 0) & (y >= 1) & (y <= L2),
                            i_border.expand(B, n1),
                            torch.where(inside, i_val, neg))
        if d in corner_steps:
            on = cdiag == d
            vals = [v.gather(1, L1)[:, 0] for v in (m_out, i_out, d_out)]
            final = torch.where(on, _lse(*vals), final)
        p2m, p2d, p2i = pm, pd, pi
        pm, pd, pi = m_out, d_out, i_out
    return final


def forward(refs: Sequence[bytes], reads: Sequence[bytes], device,
            dtype=torch.float64, block: int = 16384) -> np.ndarray:
    """forward_block over blocks of `block` pairs, as float64 numpy."""
    out = [forward_block(refs[s:s + block], reads[s:s + block], device,
                         dtype).double().cpu().numpy()
           for s in range(0, len(refs), block)]
    return np.concatenate(out) if out else np.zeros(0)
