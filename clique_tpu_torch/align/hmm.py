"""Pair-HMM read routing on PyTorch + CUDA: the forward algorithm over a
panel of references.

Counterpart of clique_tpu/align/hmm.py. A 3-state pair-HMM (Match /
Insert / Delete) over (reference, read), in log space:

    M[x,y] = e_m(x,y) + LSE(M[x-1,y-1]+t_mm, I[x-1,y-1]+t_gc, D[x-1,y-1]+t_gc)
    D[x,y] = LSE(M[x-1,y]+t_go, D[x-1,y]+t_ge)
    I[x,y] = LSE(M[x,y-1]+t_go, I[x,y-1]+t_ge)

with t_mm = log1p(-2 exp(lgo)), t_go = lgo, t_ge = lge and
t_gc = log1p(-exp(lge)). Reference digits and symbols (bytes below '0'
+ 10) and N on either side emit log 1/4; real bases emit log match_p or
log((1 - match_p) / 3). The log-likelihood of a pair is LSE(M, I, D) at
its (l1, l2) corner; routing takes the first best reference of a read.

- `hmm_forward_batch_reference` is the plain PyTorch version: the JAX
  package's anti-diagonal scan (hmm.py:39-134) step for step, with its
  order of operations in every LSE, so on the CPU it gives the JAX
  package's values.
- `hmm_forward_batch` launches the hand-written kernel
  (csrc/hmm_forward.cu) on CUDA tensors and runs the plain version on CPU
  tensors; any other device raises. `hmm_forward_launches` counts kernel
  launches and nothing else.
- `HmmRouter.route` scores every (read, candidate reference) pair of a
  call in one launch, each pair at its own lengths (the JAX package's
  128-base length quantum, power-of-two batch and 1,024-pair chunks were
  shapes for the TPU's compiler and are gone).

The transition terms are computed once, on the host, in float32, from the
six parameters, and both versions take them from there.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from clique_tpu_torch.align.dp_kernels import (_check, _device_of,
                                               _launch_stream, _raise_on)
from clique_tpu_torch.utils.trace import span

NEG = -1e30

hmm_forward_launches = 0


def reset_counts() -> None:
    global hmm_forward_launches
    hmm_forward_launches = 0


def default_hmm_params(match_p: float = 0.92, gap_open_p: float = 0.025,
                       gap_extend_p: float = 0.35) -> np.ndarray:
    """ONT-flavored emission/transition log-probabilities, float32:
    log_match, log_mismatch, log_wild, log_gap_open, log_gap_extend,
    log_close (clique_tpu/align/hmm.py:137-147)."""
    return np.array([
        math.log(match_p),
        math.log((1.0 - match_p) / 3.0),
        math.log(0.25),
        math.log(gap_open_p),
        math.log(gap_extend_p),
        math.log1p(-gap_extend_p),
    ], dtype=np.float32)


def hmm_terms(params: torch.Tensor) -> torch.Tensor:
    """[6] f32 parameters -> [7] f32 on the CPU: lm, lx, lw, lgo, lge,
    t_mm = log1p(-2 exp(lgo)), t_gc = log1p(-exp(lge)). params[5] (the
    close probability) is unused, as in the JAX package."""
    p = params.detach().to("cpu", torch.float32)
    lgo, lge = p[3], p[4]
    t_mm = torch.log1p(-2.0 * torch.exp(lgo))
    t_gc = torch.log1p(-torch.exp(lge))
    return torch.stack([p[0], p[1], p[2], lgo, lge, t_mm, t_gc])


def _check_inputs(refs, reads, ref_lens, read_lens, params):
    dev = _device_of(reads)
    _check(refs, "refs", torch.uint8, 2, dev)
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(ref_lens, "ref_lens", torch.int32, 1, dev)
    _check(read_lens, "read_lens", torch.int32, 1, dev)
    if not isinstance(params, torch.Tensor) or params.dtype != torch.float32 \
            or params.shape != (6,):
        raise ValueError("params must be a float32 tensor of 6 entries")
    B = refs.shape[0]
    if reads.shape[0] != B or ref_lens.shape[0] != B \
            or read_lens.shape[0] != B:
        raise ValueError("refs, reads, ref_lens and read_lens need one row "
                         "per pair")
    return dev, B


def _lse3(a, b, c):
    m = torch.maximum(a, torch.maximum(b, c))
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _lse2(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _border(lgo, lge, k):
    """The gap border lgo + (k - 1) lge of row or column k as one fused
    multiply-add, as XLA contracts it on the CPU (and the kernel's
    __fmaf_rn): the f32 product is exact in float64, the sum rounds there
    and then to f32."""
    return (lgo.double() + (k - 1.0).double() * lge.double()).float()


def hmm_forward_batch_reference(refs, reads, ref_lens, read_lens, params
                                ) -> torch.Tensor:
    """Plain PyTorch forward log-likelihood of each pair: refs [B, >= l1]
    u8, reads [B, >= l2] u8 (row-padded), ref_lens / read_lens [B] i32,
    params [6] f32 (on any device: the terms are computed on the host)
    -> [B] f32, on the tensors' device. Lengths outside the rows raise
    ValueError."""
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, params)
    n1 = refs.shape[1] + 1
    n2 = reads.shape[1] + 1
    if B and (int(ref_lens.min()) < 0 or int(ref_lens.max()) > n1 - 1
              or int(read_lens.min()) < 0
              or int(read_lens.max()) > n2 - 1):
        raise ValueError(f"lengths must lie in [0, {n1 - 1}] x "
                         f"[0, {n2 - 1}]")
    f32 = torch.float32
    lm, lx, lw, lgo, lge, t_mm, t_gc = hmm_terms(params).to(dev).unbind()
    neg_s = torch.tensor(NEG, dtype=f32, device=dev)
    zero_s = torch.tensor(0.0, dtype=f32, device=dev)
    xs = torch.arange(n1, device=dev)
    xf = xs.to(f32)
    l1 = ref_lens.long()[:, None]
    l2 = read_lens.long()[:, None]
    # rx[x] = refs[x - 1], 0 on lane 0; a zero column keeps the gather below
    # in range when the reads are 0 wide
    rx = torch.nn.functional.pad(refs[:, :n1 - 1].long(), (1, 0))
    reads_l = torch.nn.functional.pad(reads[:, :n2 - 1].long(), (0, 1))
    lane_ok = (xs >= 1) & (xs <= l1)                     # [B, n1]
    d_border = _border(lgo, lge, xf)                     # D[x, 0]

    def shift(v):
        return torch.nn.functional.pad(v[:, :-1], (1, 0), value=NEG)

    neg = torch.full((B, n1), NEG, dtype=f32, device=dev)
    pm = pi = pd = p2m = p2i = p2d = neg
    final = torch.full((B,), NEG, dtype=f32, device=dev)
    corner = (ref_lens + read_lens).long()
    corner_steps = set(corner.tolist())
    for d in range(n1 + n2 - 1):
        y = d - xs                                       # [n1]
        ry = reads_l[:, (y - 1).clamp(0, max(n2 - 2, 0))]
        wild = (rx == 78) | (rx < 58) | (ry == 78)
        e_m = torch.where(wild, lw, torch.where(rx == ry, lm, lx))
        m_val = e_m + _lse3(shift(p2m) + t_mm, shift(p2i) + t_gc,
                            shift(p2d) + t_gc)
        d_val = _lse2(shift(pm) + lgo, shift(pd) + lge)
        i_val = _lse2(pm + lgo, pi + lge)
        inside = lane_ok & (y >= 1) & (y <= l2)
        m_out = torch.where(inside, m_val, neg_s)
        if d == 0:
            m_out = torch.where(xs == 0, zero_s, m_out)
        d_out = torch.where(lane_ok & (y == 0), d_border,
                            torch.where(inside, d_val, neg_s))
        i_out = torch.where((xs == 0) & (y >= 1) & (y <= l2),
                            _border(lgo, lge, y.to(f32)),
                            torch.where(inside, i_val, neg_s))
        if d in corner_steps:
            on = corner == d
            c_m, c_i, c_d = (v.gather(1, l1)[:, 0]
                             for v in (m_out, i_out, d_out))
            final = torch.where(on, _lse3(c_m, c_i, c_d), final)
        p2m, p2i, p2d = pm, pi, pd
        pm, pi, pd = m_out, i_out, d_out
    return final


def hmm_forward_batch(refs, reads, ref_lens, read_lens, params, *,
                      stream=None) -> torch.Tensor:
    """Forward log-likelihood of each (reference, read) pair, [B] f32: the
    kernel on CUDA tensors, the plain version on CPU tensors. Inputs as
    hmm_forward_batch_reference. The kernel cannot raise on a length
    outside the rows without a sync, so it writes NaN for that pair."""
    global hmm_forward_launches
    dev, B = _check_inputs(refs, reads, ref_lens, read_lens, params)
    if dev.type == "cpu":
        return hmm_forward_batch_reference(refs, reads, ref_lens, read_lens,
                                           params)

    from clique_tpu_torch import _build

    lib = _build.load()
    n1 = refs.shape[1] + 1
    n2 = reads.shape[1] + 1
    terms = [ctypes.c_float(v) for v in hmm_terms(params).tolist()]
    s = _launch_stream(stream, dev, [refs, reads, ref_lens, read_lens])
    scratch_floats = lib.clique_hmm_forward_scratch_floats(n1, n2)
    with torch.cuda.stream(s):
        out = torch.empty(B, dtype=torch.float32, device=dev)
        scratch = torch.empty((B, scratch_floats), dtype=torch.float32,
                              device=dev) if scratch_floats else None
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.clique_hmm_forward(
            refs.data_ptr(), refs.shape[1], reads.data_ptr(), reads.shape[1],
            ref_lens.data_ptr(), read_lens.data_ptr(), *terms,
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), B, n1, n2, s.cuda_stream)
    _raise_on(err, "hmm_forward")
    hmm_forward_launches += 1
    return out


def _byte_rows(seqs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Row-padded u8 matrix (at least one column) and i32 lengths."""
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32,
                       count=len(seqs))
    mat = np.zeros((len(seqs), max(1, int(lens.max(initial=0)))), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    return mat, lens


class HmmRouter:
    """Route reads to the best reference in a panel by forward LL
    (clique_tpu/align/hmm.py:150-204). device: where the forward
    recurrence runs ("cuda", "cuda:N" or "cpu"); stream: the CUDA stream
    its calls go out on (None: one of its own).

    A route call can be put in flight: `launch(reads)` prepares it and
    enqueues its forward pass on the router's stream, with the LLs' copy
    to pinned host memory behind it, and returns; `pair_lls` (or
    `route`) on that same `reads` list later waits on that call's event
    alone, so the host can launch the next call and work while this one
    runs. Without a launch, `pair_lls` does the whole call in place.
    `calls` counts the forward passes, `calls_overlapped` those launched
    while an earlier call's LLs were still uncollected."""

    def __init__(self, references: Sequence[bytes],
                 params: Optional[np.ndarray] = None, device="cuda",
                 stream: Optional[torch.cuda.Stream] = None):
        self.references = list(references)
        self.params = params if params is not None else default_hmm_params()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        refs, lens = _byte_rows(self.references)
        self._refs = torch.from_numpy(refs).to(self.device)
        self._ref_lens = torch.from_numpy(lens).to(self.device)
        self._params = torch.as_tensor(np.asarray(self.params, np.float32))
        self.stream = None
        if self.device.type == "cuda":
            self.stream = stream if stream is not None \
                else torch.cuda.Stream(self.device)
            # the panel's rows were written on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # (reads, candidates, call) of the launched calls not collected yet
        self._inflight: List[tuple] = []
        self.calls = 0
        self.calls_overlapped = 0

    def launch(self, reads: Sequence[bytes],
               candidates: Optional[List[List[int]]] = None) -> None:
        """Prepare the call on `reads` and enqueue its forward pass without
        waiting for it; `pair_lls(reads, candidates)` with the same list
        collects it. A launch error raises here."""
        with span("router.route"):
            call = self._start(reads, candidates)
        self._inflight.append((reads, candidates, call))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.stream is None:
            return t
        # pinned: a copy from pageable memory would hold the host until the
        # stream's earlier work (the call in flight) is done
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start(self, reads, candidates):
        """Enqueue one call: (read index, reference index, the LLs on the
        host, the event after their copy or None)."""
        n = len(reads)
        R = len(self.references)
        if candidates is None:
            read_idx = np.repeat(np.arange(n), R)
            ref_idx = np.tile(np.arange(R), n)
        else:
            counts = [len(candidates[i]) for i in range(n)]
            read_idx = np.repeat(np.arange(n), counts)
            ref_idx = np.fromiter((r for i in range(n) for r in candidates[i]),
                                  dtype=np.int64, count=sum(counts))
        if not len(read_idx):
            return read_idx, ref_idx, torch.zeros(0), None
        read_mat, read_lens = _byte_rows(reads)
        self.calls_overlapped += bool(self._inflight)
        self.calls += 1
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            ri, qi, reads_d, lens_d = (self._to_device(a) for a in (
                ref_idx, read_idx, read_mat, read_lens))
            ll = hmm_forward_batch(
                self._refs.index_select(0, ri).contiguous(),
                reads_d.index_select(0, qi).contiguous(),
                self._ref_lens.index_select(0, ri).contiguous(),
                lens_d.index_select(0, qi).contiguous(),
                self._params, stream=self.stream)
            if self.stream is None:
                return read_idx, ref_idx, ll, None
            host = torch.empty(ll.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(ll, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return read_idx, ref_idx, host, event

    def pair_lls(self, reads: Sequence[bytes],
                 candidates: Optional[List[List[int]]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(read index, reference index, LL) of every (read, candidate
        reference) pair, read by read in candidate order (the whole panel
        without candidates), scored in one hmm_forward_batch call: the one
        `launch` put in flight for this `reads` list, else one made here."""
        for k, (r, c, call) in enumerate(self._inflight):
            if r is reads and c is candidates:
                del self._inflight[k]
                break
        else:
            call = self._start(reads, candidates)
        read_idx, ref_idx, host, event = call
        # the host waits here for this call's forward pass and copy
        with span("router.wait"):
            if event is not None:
                event.synchronize()
        return read_idx, ref_idx, host.numpy()

    def route(self, reads: Sequence[bytes],
              candidates: Optional[List[List[int]]] = None
              ) -> List[Tuple[int, float]]:
        """Returns per-read (best_reference_id, log_likelihood), (-1, -inf)
        for a read with no candidate. candidates restricts the panel per
        read (e.g. from a kmer prefilter). Of equal LLs the first
        reference in candidate order wins, as in the JAX package."""
        n = len(reads)
        out: List[Tuple[int, float]] = [(-1, float("-inf"))] * n
        with span("router.route"):
            read_idx, ref_idx, ll = self.pair_lls(reads, candidates)
            # the first pair of a read (in candidate order) whose LL is the
            # read's largest: the JAX loop's strict `ll > best` from -inf
            llm = np.where(np.isnan(ll), -np.inf, ll)
            best = np.full(n, -np.inf, dtype=np.float32)
            np.maximum.at(best, read_idx, llm)
            hit = np.flatnonzero((llm == best[read_idx]) & (llm > -np.inf))
            won, first = np.unique(read_idx[hit], return_index=True)
            for i, j in zip(won.tolist(), hit[first].tolist()):
                out[i] = (int(ref_idx[j]), float(ll[j]))
        return out
