"""Tag distances for collapse's correction: hand-written CUDA kernels with
their plain PyTorch versions, and the host candidate generation.

Counterpart of clique_tpu/collapse/distance.py, which imports jax:

- `match_hits` (csrc/tag_distance.cu::clique_match_hits) replaces
  `_match_count_kernel` (distance.py:240-252) together with hamming_hits's
  radius test (:295-296): every (tag, allowlist entry) pair whose Hamming
  distance L - min(matches, 255) is at most max_distance, as (u, k)
  indices sorted by (u, k). Equal bytes count whatever they are, so
  '-' == '-' and 'N' == 'N' are matches as in
  FastaString::hamming_distance (known_list.rs:51-60). The kernel never
  forms the [U, K] count matrix; `match_count_reference` is that matrix's
  plain version.
- `edit_distance` (csrc/tag_distance.cu::clique_edit_distance) replaces
  `_edit_distance_kernel` (distance.py:36-91): Levenshtein distance per row
  pair, exact byte equality, bytes beyond la/lb ignored, u8 capped at 255,
  rows of any width.
- `edit_hits` (csrc/tag_distance.cu::clique_edit_hits) replaces the same
  kernel where degenerate correction calls it, together with that
  correction's pair preparation (clique_tpu/collapse/correct.py:273-399:
  pair enumeration, the count-ratio pre-filter, `dists <= max_distance`):
  from one tag matrix of many groups, every pair of one group whose counts
  differ and pass max >= ratio * min and whose Levenshtein distance over
  the group's width is at most max_distance, as (h, j) indices with h the
  higher count, sorted by (h, j). Tags of at most EDIT_HITS_MAX_LEN bytes.

On CUDA tensors each wrapper checks its inputs, allocates its outputs and
scratch with torch.empty, launches its kernel on the current stream and
raises if the launch fails. On CPU tensors it runs the plain PyTorch
version (`match_hits_reference`, `edit_distance_reference`,
`edit_hits_reference`). Any other device raises. `match_hits_launches`,
`edit_distance_launches` and `edit_hits_launches` count kernel launches
and nothing else.

The host functions below them are jax-free copies of the JAX module's,
without its power-of-two pad-up of U, K and P (an XLA compile-reuse
device): the Myers bit-parallel Levenshtein, the pigeonhole candidate
generation, and the dispatchers `hamming_hits`, `edit_distance_rows` and
`edit_distance_pairs`, which take the torch device the kernels run on.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from clique_tpu_torch.align.dp_kernels import (_check, _device_of,
                                               _launch_stream, _raise_on)

# row pairs from which edit_distance_rows / edit_distance_pairs on the CPU
# run edit_distance instead of the host Myers code (the JAX package's
# default, clique_tpu/collapse/distance.py:94-102). On a CUDA device every
# call runs edit_distance: with its transfers it beat the host Myers code
# at every P measured at L = 32, from 1 pair to 2,097,152, on an NVIDIA
# H100 80GB HBM3 at 700 W (profile_port.py edit)
DEVICE_MIN_PAIRS = 2_000_000
# widest row the host Myers code takes (one uint64 bit vector per pair)
MYERS_MAX_LEN = 64
# pairs per step of edit_distance_reference (bounds its temporaries)
REFERENCE_CHUNK = 1 << 18
# row widths in 32-bit words that match_hits's register kernel is built
# for (kHitTagWords in csrc/tag_distance.cu); wider rows take its wide
# kernel
HIT_ROW_WORDS = (1, 2, 4, 8)
# widest tag edit_hits takes (one uint64 bit vector a pattern), and the
# code-row widths in 32-bit words its kernels are built for
EDIT_HITS_MAX_LEN = 64
EDIT_HIT_ROW_WORDS = (4, 8, 16)

match_hits_launches = 0
edit_distance_launches = 0
edit_hits_launches = 0


def reset_counts() -> None:
    global match_hits_launches, edit_distance_launches, edit_hits_launches
    match_hits_launches = 0
    edit_distance_launches = 0
    edit_hits_launches = 0


def resolve_device(device) -> torch.device:
    """The torch device tag correction runs on: "cuda", "cuda:N" or "cpu".
    A CUDA device without a usable GPU raises here, before any work, so a
    run asked to use the card never silently runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} was asked for, but no "
                               "CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


# --- plain PyTorch versions --------------------------------------------------

def match_count_reference(tags, allow):
    """tags u8 [U, L], allow u8 [K, L] -> u8 [U, K]: per pair the number of
    columns whose bytes are equal, capped at 255 (what
    _match_count_kernel computes). One [U, K] compare per column."""
    U, L = tags.shape
    m = torch.zeros((U, allow.shape[0]), dtype=torch.int16,
                    device=tags.device)
    for c in range(L):
        m += tags[:, c, None] == allow[None, :, c]
    return m.clamp_(max=255).to(torch.uint8)


def _sorted_pairs(u, k, K):
    """(u, k) i64 index tensors sorted by (u, k)."""
    order = torch.argsort(u * K + k)
    return u[order], k[order]


def match_hits_reference(tags, allow, max_distance, chunk_u=2048,
                         chunk_k=16384):
    """tags u8 [U, L], allow u8 [K, L] -> (u, k) i64 [H], sorted by (u, k):
    the pairs whose Hamming distance L - min(matches, 255) is at most
    max_distance. The JAX formulation (distance.py:279-296):
    match_count_reference per (chunk_u x chunk_k) block and the radius
    test beside it; the chunks only bound the temporaries."""
    U, L = tags.shape
    K = allow.shape[0]
    us, ks = [], []
    for u0 in range(0, U, chunk_u):
        for k0 in range(0, K, chunk_k):
            m = match_count_reference(tags[u0:u0 + chunk_u],
                                      allow[k0:k0 + chunk_k])
            uu, kk = torch.nonzero(L - m.int() <= max_distance,
                                   as_tuple=True)
            us.append(uu + u0)
            ks.append(kk + k0)
    if not us:
        empty = torch.zeros(0, dtype=torch.int64, device=tags.device)
        return empty, empty.clone()
    return _sorted_pairs(torch.cat(us), torch.cat(ks), K)


def edit_distance_reference(a, b, la, lb):
    """a, b u8 [P, L], la, lb i32 [P] (0 <= la, lb <= L) -> u8 [P]:
    Levenshtein distance of a[p, :la[p]] and b[p, :lb[p]], capped at 255
    (what _edit_distance_kernel computes; la = 0 gives lb).

    Row i of the DP is built from row i-1 in three tensor ops: t[j] =
    min(up + 1, diag + sub) and then the left moves, D(i, j) = min over
    k <= j of t[k] + (j - k), as a cumulative minimum. Rows past la keep
    their last value; only columns up to max(lb) are computed. Pairs go
    in chunks of REFERENCE_CHUNK."""
    P = a.shape[0]
    out = torch.empty(P, dtype=torch.uint8, device=a.device)
    for s in range(0, P, REFERENCE_CHUNK):
        e = min(P, s + REFERENCE_CHUNK)
        la_c, lb_c = la[s:e].long(), lb[s:e].long()
        n = int(la_c.max())
        m = int(lb_c.max())
        ar = torch.arange(m + 1, dtype=torch.int32, device=a.device)
        row = ar.expand(e - s, m + 1).clone()          # D(0, j) = j
        bb = b[s:e, :m]
        for i in range(1, n + 1):
            sub = (a[s:e, i - 1, None] != bb).int()
            t = torch.empty_like(row)
            t[:, 0] = i
            t[:, 1:] = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
            new = torch.cummin(t - ar, dim=1).values + ar
            row = torch.where((la_c >= i)[:, None], new, row)
        d = row.gather(1, lb_c[:, None]).squeeze(1)
        out[s:e] = d.clamp(max=255).to(torch.uint8)
    return out


def _ratio_pass(ci, cj, ratio):
    """(ci != cj) & (max >= ratio * min) on i64 count tensors, in float64
    as numpy computes it (correct.py's pre-filter)."""
    hi = torch.maximum(ci, cj)
    lo = torch.minimum(ci, cj)
    return (ci != cj) & (hi.double() >= ratio * lo.double())


def edit_hits_reference(tags, counts, offsets, widths, max_distance,
                        collapse_ratio, pairs=None):
    """tags u8 [T, W], counts i64 [T], offsets i32 [G + 1] (group g holds
    tags offsets[g] .. offsets[g + 1]), widths i32 [G] (<= W) -> (h, j)
    i64, sorted by (h, j): every pair of one group with counts[h] >
    counts[j], counts[h] >= collapse_ratio * counts[j] (float64) and
    Levenshtein distance of tags[h, :w] and tags[j, :w] at most
    max_distance, w the group's width. With pairs (i32 [P, 2], both ends of
    one group) only those pairs are tested. The pairs are enumerated with
    torch.triu_indices a group, filtered, gathered, and their distances
    taken by edit_distance_reference."""
    dev = tags.device
    T = tags.shape[0]
    if pairs is None:
        offs = offsets.tolist()
        chunks = [torch.triu_indices(e - s, e - s, 1, device=dev).T + s
                  for s, e in zip(offs, offs[1:]) if e - s > 1]
        pairs = torch.cat(chunks) if chunks else torch.zeros(
            (0, 2), dtype=torch.int64, device=dev)
    pairs = pairs.long()
    i, j = pairs[:, 0], pairs[:, 1]
    ci, cj = counts[i], counts[j]
    keep = _ratio_pass(ci, cj, collapse_ratio)
    h = torch.where(ci > cj, i, j)[keep]
    j = torch.where(ci > cj, j, i)[keep]
    group = torch.searchsorted(offsets[1:].long(), h, right=True)
    w = widths.long()[group].int()
    dist = edit_distance_reference(tags[h], tags[j], w, w)
    close = dist.int() <= max_distance
    return _sorted_pairs(h[close], j[close], T)


# --- kernel wrappers ----------------------------------------------------------

def _as_words(v):
    """i64 values in [0, 2^32) -> the i32 tensor with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_hit_inputs(tags, allow, max_distance):
    """match_hits's encoding, built by torch ops on the tensors' device.

    Bytes map to class codes over the allowlist's distinct bytes (sorted),
    `bits` = 2, 4 or 8 a column for up to 4, 16 or 256 classes, packed
    32 // bits columns a word from the low bits up, rows S words wide (the
    next of HIT_ROW_WORDS at or above the words needed, or that count past
    8). A tag byte no allowlist row holds mismatches every row: it is
    counted out of the tag's budget (max_distance minus such bytes, capped
    to [-1, L]) and its column left out of the tag's live mask, which
    holds the top bit of every other field. Columns past L are code 0 on
    both sides. Returns (tag_words i32 [U, S], tag_masks i32 [U, S],
    budgets i32 [U], allow_words i32 [Kp, S] with Kp = K rounded up to a
    multiple of 4 and zero rows past K, bits). A pair (u, k) is a hit iff
    popcount(fold(tag_words[u] ^ allow_words[k]) & tag_masks[u]) <=
    budgets[u], fold setting each field's top bit iff the field is not 0."""
    dev = tags.device
    U, L = tags.shape
    K = allow.shape[0]
    vals = torch.unique(allow)
    n = vals.numel()
    bits = 2 if n <= 4 else 4 if n <= 16 else 8
    per = 32 // bits
    words = -(-L // per)
    S = next((w for w in HIT_ROW_WORDS if w >= words), words)
    lut = torch.full((256,), -1, dtype=torch.int64, device=dev)
    lut[vals.long()] = torch.arange(n, device=dev)
    shifts = torch.arange(per, device=dev) * bits

    def pack(codes, rows):
        full = torch.zeros((rows, S * per), dtype=torch.int64, device=dev)
        full[:codes.shape[0], :L] = codes
        return _as_words((full.view(rows, S, per) << shifts).sum(-1))

    tag_codes = lut[tags.long()]
    foreign = tag_codes < 0
    d = min(max(max_distance, -1), L)
    budgets = (d - foreign.sum(1)).clamp_(min=-1).to(torch.int32)
    tag_words = pack(tag_codes.clamp(min=0), U)
    tag_masks = pack((~foreign).long() << (bits - 1), U)
    allow_words = pack(lut[allow.long()], -(-K // 4) * 4)
    return tag_words, tag_masks, budgets, allow_words, bits


def match_hits(tags, allow, max_distance, chunk_u=2048, chunk_k=16384):
    """tags u8 [U, L], allow u8 [K, L] -> (u, k) i64, sorted by (u, k)
    (match_hits_reference's semantics, any L >= 1). Where L - max_distance
    exceeds 255 no pair can pass the capped count and nothing is launched.
    On the card: pack_hit_inputs, one launch into a hit buffer, the hit
    count read back once; a count past the buffer relaunches once with a
    buffer of that size. chunk_u / chunk_k bound the plain version's
    temporaries only."""
    global match_hits_launches
    dev = _device_of(tags)
    _check(tags, "tags", torch.uint8, 2, dev)
    _check(allow, "allow", torch.uint8, 2, dev)
    U, L = tags.shape
    K = allow.shape[0]
    if allow.shape[1] != L:
        raise ValueError(f"tags are {L} wide, allowlist rows "
                         f"{allow.shape[1]}")
    if L == 0:
        raise ValueError("tags must be at least one byte wide")
    if dev.type == "cpu":
        return match_hits_reference(tags, allow, max_distance, chunk_u,
                                    chunk_k)

    from clique_tpu_torch import _build

    lib = _build.load()
    s = _launch_stream(None, dev, (tags, allow))
    with torch.cuda.stream(s), torch.cuda.device(dev):
        if U == 0 or K == 0 or L - max_distance > 255:
            empty = torch.zeros(0, dtype=torch.int64, device=dev)
            return empty, empty.clone()
        tw, tm, budgets, aw, bits = pack_hit_inputs(tags, allow,
                                                    max_distance)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        cap = min(U * K, max(4 * U, 1 << 16))
        while True:
            out = torch.empty((cap, 2), dtype=torch.int32, device=dev)
            err = lib.clique_match_hits(
                tw.data_ptr(), tm.data_ptr(), budgets.data_ptr(),
                aw.data_ptr(), U, K, tw.shape[1], bits, count.data_ptr(),
                out.data_ptr(), cap, s.cuda_stream)
            _raise_on(err, "match_hits")
            match_hits_launches += 1
            n = int(count.item())
            if n <= cap:
                break
            cap = n
            count.zero_()
        pairs = out[:n].long()
        return _sorted_pairs(pairs[:, 0], pairs[:, 1], K)


def edit_distance(a, b, la, lb):
    """a, b u8 [P, L], la, lb i32 [P] -> u8 [P] (edit_distance_reference's
    semantics), any L. Every length must lie in [0, L]: that is checked on
    either device and raises ValueError. On the card the lengths' least and
    largest values are read back once, after the launch (the kernel clamps
    them; its output is dropped where one lies outside), so the check adds
    no round trip before the kernel. The kernel needs no scratch."""
    global edit_distance_launches
    dev = _device_of(a)
    _check(a, "a", torch.uint8, 2, dev)
    _check(b, "b", torch.uint8, 2, dev)
    _check(la, "la", torch.int32, 1, dev)
    _check(lb, "lb", torch.int32, 1, dev)
    P, L = a.shape
    if tuple(b.shape) != (P, L) or la.shape[0] != P or lb.shape[0] != P:
        raise ValueError("a and b must be [P, L] and la, lb [P]")
    if P == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev)

    def check_lengths(extremes):
        lo_a, hi_a, lo_b, hi_b = extremes.tolist()
        if min(lo_a, lo_b) < 0 or max(hi_a, hi_b) > L:
            raise ValueError(f"lengths must lie in [0, {L}]")

    extremes = torch.stack((*torch.aminmax(la), *torch.aminmax(lb)))
    if dev.type == "cpu":
        check_lengths(extremes)
        return edit_distance_reference(a, b, la, lb)

    from clique_tpu_torch import _build

    lib = _build.load()
    s = _launch_stream(None, dev, (a, b, la, lb))
    with torch.cuda.stream(s):
        out = torch.empty(P, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.clique_edit_distance(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            out.data_ptr(), P, L, s.cuda_stream)
    _raise_on(err, "edit_distance")
    edit_distance_launches += 1
    check_lengths(extremes)
    return out


def _check_edit_hit_inputs(tags, counts, offsets, widths, pairs):
    """Checks edit_hits's inputs on either device; the value checks read
    back one small tensor. Returns the widest group's width."""
    dev = _device_of(tags)
    _check(tags, "tags", torch.uint8, 2, dev)
    _check(counts, "counts", torch.int64, 1, dev)
    _check(offsets, "offsets", torch.int32, 1, dev)
    _check(widths, "widths", torch.int32, 1, dev)
    T, W = tags.shape
    G = widths.shape[0]
    if counts.shape[0] != T or offsets.shape[0] != G + 1:
        raise ValueError("counts must be [T], offsets [G + 1], widths [G]")
    if pairs is not None:
        _check(pairs, "pairs", torch.int32, 2, dev)
        if pairs.shape[1] != 2:
            raise ValueError("pairs must be [P, 2]")
    cap = min(W, EDIT_HITS_MAX_LEN)
    bad = ((offsets[0] != 0) | (offsets[-1] != T)
           | (offsets[1:] < offsets[:-1]).any()
           | ((widths < 0) | (widths > cap)).any())
    if pairs is not None and pairs.shape[0]:
        p = pairs.long()
        ends = offsets[1:].long()
        bad = bad | ((p < 0) | (p >= T)).any()
        pc = p.clamp(0, max(T - 1, 0)).T.contiguous()
        bad = bad | (torch.searchsorted(ends, pc[0], right=True)
                     != torch.searchsorted(ends, pc[1], right=True)).any()
    wmax = widths.max() if G else torch.zeros((), dtype=torch.int32,
                                                device=dev)
    bad, wmax = torch.stack((bad.int(), wmax.int())).tolist()
    if bad:
        raise ValueError(
            f"edit_hits needs offsets rising from 0 to {T}, widths in "
            f"[0, {cap}] and pairs of tags of one group")
    return wmax


def edit_hit_codes(tags, wmax):
    """edit_hits's encoding, built by torch ops on the tensors' device:
    each byte's class code over the distinct bytes of the first wmax
    columns (sorted), in rows of S words (the first of EDIT_HIT_ROW_WORDS
    that holds wmax bytes), zero past wmax. Returns (codes i32 [T, S], K
    classes)."""
    T = tags.shape[0]
    S = next(s for s in EDIT_HIT_ROW_WORDS if 4 * s >= wmax)
    head = tags[:, :wmax]
    vals = torch.unique(head)
    K = max(int(vals.numel()), 1)
    lut = torch.zeros(256, dtype=torch.uint8, device=tags.device)
    lut[vals.long()] = torch.arange(vals.numel(), dtype=torch.uint8,
                                    device=tags.device)
    codes = torch.zeros((T, 4 * S), dtype=torch.uint8, device=tags.device)
    codes[:, :wmax] = lut[head.long()]
    return codes.view(torch.int32), K


def edit_hit_groups(tags, counts, offsets, collapse_ratio, wmax, warps):
    """The group mode's inputs, built by torch ops on the tensors' device:
    the tags' codes (edit_hit_codes) and counts sorted by (group, count,
    index) with two stable sorts; the sorted tags that have a partner (a
    count above the group's least and at least ratio times it, so the
    least is one); and the cuts of that list into blocks of at most
    `warps` tags of one group. Returns (codes i32 [T, S], counts i64 [T],
    high i32 [H], bstart i32 [NB + 1] or None where H = 0, perm i64 [T]
    (sorted index -> the caller's), K)."""
    dev = tags.device
    T = tags.shape[0]
    G = offsets.shape[0] - 1
    codes, K = edit_hit_codes(tags, wmax)
    sizes = (offsets[1:] - offsets[:-1]).long()
    gid = torch.repeat_interleave(torch.arange(G, device=dev), sizes,
                                  output_size=T)
    by_count = torch.argsort(counts, stable=True)
    perm = by_count[torch.argsort(gid[by_count], stable=True)]
    cnt = counts[perm]
    least = cnt[offsets[:-1].long()[gid]]
    high = torch.nonzero(
        (cnt > least) & (cnt.double() >= collapse_ratio * least.double())
    ).flatten()
    H = high.numel()
    bstart = None
    if H:
        hg = gid[high]
        idx = torch.arange(H, device=dev)
        first = torch.ones(H, dtype=torch.bool, device=dev)
        first[1:] = hg[1:] != hg[:-1]
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
        bstart = torch.cat((torch.nonzero(rank % warps == 0).flatten(),
                            torch.tensor([H], device=dev))).int()
    return codes[perm], cnt, high.int(), bstart, perm, K


def edit_hits(tags, counts, offsets, widths, max_distance, collapse_ratio,
              pairs=None):
    """edit_hits_reference's semantics (widths at most EDIT_HITS_MAX_LEN);
    checked on either device. On the card: the group mode sorts each
    group's tags by count (two stable sorts), finds the tags with a partner
    and launches one CTA for every 8 of them; the pairs mode tests the
    given pairs, one a lane. One launch into a hit buffer, the hit count
    read back once; a count past the buffer relaunches once with a buffer
    of that size. Hits map back to the caller's tag order and are sorted
    by (h, j)."""
    global edit_hits_launches
    wmax = _check_edit_hit_inputs(tags, counts, offsets, widths, pairs)
    dev = tags.device
    if dev.type == "cpu":
        return edit_hits_reference(tags, counts, offsets, widths,
                                   max_distance, collapse_ratio, pairs)

    from clique_tpu_torch import _build

    lib = _build.load()
    T = tags.shape[0]
    G = widths.shape[0]
    ins = (tags, counts, offsets, widths) + (() if pairs is None
                                             else (pairs,))
    s = _launch_stream(None, dev, ins)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    with torch.cuda.stream(s), torch.cuda.device(dev):
        if T == 0 or G == 0 or (pairs is not None and pairs.shape[0] == 0):
            return empty, empty.clone()
        if pairs is None:
            codes, cnt, high, bstart, perm, K = edit_hit_groups(
                tags, counts, offsets, collapse_ratio, wmax,
                lib.clique_edit_hits_warps())
            if bstart is None:
                return empty, empty.clone()
            NB, P = bstart.numel() - 1, 0
            cap = max(4 * T, 1 << 16)
        else:
            codes, K = edit_hit_codes(tags, wmax)
            cnt, high, bstart, NB = counts, None, None, 0
            P = pairs.shape[0]
            cap = min(P, max(4 * T, 1 << 16))
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        while True:
            out = torch.empty((cap, 2), dtype=torch.int32, device=dev)
            err = lib.clique_edit_hits(
                codes.data_ptr(), cnt.data_ptr(), offsets.data_ptr(), G,
                widths.data_ptr(),
                high.data_ptr() if high is not None else None,
                bstart.data_ptr() if bstart is not None else None, NB,
                pairs.data_ptr() if pairs is not None else None, P,
                codes.shape[1], K, max_distance, float(collapse_ratio),
                count.data_ptr(), out.data_ptr(), cap, s.cuda_stream)
            _raise_on(err, "edit_hits")
            edit_hits_launches += 1
            n = int(count.item())
            if n <= cap:
                break
            cap = n
            count.zero_()
        hj = out[:n].long()
        if pairs is None:
            hj = perm[hj]
        return _sorted_pairs(hj[:, 0], hj[:, 1], T)


# --- Levenshtein dispatch -----------------------------------------------------

def _edit_distance_myers_host(a: np.ndarray, b: np.ndarray,
                              la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    """Bit-parallel Myers/Hyyro Levenshtein on the host: a/b [P, >=L] uint8
    rows (content beyond la/lb ignored), lengths <= 64. One uint64 bit
    vector per pair, vectorized across pairs; exact-byte equality like the
    kernel. Mirrors clique_tpu/collapse/distance.py:105-158."""
    P = a.shape[0]
    out = np.empty(P, dtype=np.uint8)
    if P == 0:
        return out
    la = la.astype(np.int64)
    lb = lb.astype(np.int64)
    L1 = int(la.max())
    L2 = int(lb.max())
    assert L1 <= 64 and L2 <= 255
    one = np.uint64(1)
    CH = 1 << 15  # chunk pairs to bound the per-chunk temporaries
    for s in range(0, P, CH):
        e = min(P, s + CH)
        n = e - s
        A = a[s:e, :max(L1, 1)]
        B = b[s:e, :max(L2, 1)]
        laa = la[s:e]
        lbb = lb[s:e]
        # Eq[p, j]: bitmask over pattern positions i < la with A[i] == B[j]
        # (built position-by-position: the [n, L1, L2] cube is 10x slower)
        Eq = np.zeros((n, max(L2, 1)), np.uint64)
        for i in range(L1):
            m = (A[:, i:i + 1] == B) & (i < laa)[:, None]
            Eq |= m.astype(np.uint64) << np.uint64(i)
        sh = np.where(laa < 64, laa, 0).astype(np.uint64)
        VP = np.where(laa == 64, ~np.uint64(0), (one << sh) - one)
        VP = np.where(laa == 0, np.uint64(0), VP)
        VN = np.zeros(n, np.uint64)
        score = laa.copy()
        mbit = one << np.where(laa > 0, laa - 1, 0).astype(np.uint64)
        for j in range(L2):
            act = (j < lbb) & (laa > 0)
            PM = Eq[:, j]
            D0 = (((PM & VP) + VP) ^ VP) | PM | VN
            HP = VN | ~(D0 | VP)
            HN = VP & D0
            score += (act & ((HP & mbit) != 0)).astype(np.int64)
            score -= (act & ((HN & mbit) != 0)).astype(np.int64)
            HP = (HP << one) | one
            HN = HN << one
            nVP = HN | ~(D0 | HP)
            nVN = HP & D0
            VP = np.where(act, nVP, VP)
            VN = np.where(act, nVN, VN)
        score = np.where(laa == 0, lbb, score)
        out[s:e] = np.minimum(score, 255).astype(np.uint8)
    return out


def edit_distance_rows(a: np.ndarray, b: np.ndarray, la: np.ndarray,
                       lb: np.ndarray, device="cuda") -> np.ndarray:
    """Exact Levenshtein per row pair, already-marshalled inputs:
    a/b [P, L] uint8 (content beyond la/lb ignored), la/lb [P] lengths.
    On the CPU, below DEVICE_MIN_PAIRS rows of at most MYERS_MAX_LEN bytes
    go to the host Myers code; everything else, and every call on a CUDA
    device, to `edit_distance` on `device`. Either route is exact. Mirrors
    clique_tpu/collapse/distance.py:207-226."""
    P, L = a.shape
    if P == 0:
        return np.zeros(0, dtype=np.uint8)
    if L <= MYERS_MAX_LEN and P < DEVICE_MIN_PAIRS and \
            torch.device(device).type != "cuda":
        return _edit_distance_myers_host(a, b, la, lb)
    dev = resolve_device(device)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (a, b, la.astype(np.int32), lb.astype(np.int32))]
    return edit_distance(*args).cpu().numpy()


def edit_distance_pairs(seqs_a: Sequence[bytes], seqs_b: Sequence[bytes],
                        pad_to: int = 32, device="cuda") -> np.ndarray:
    """Exact Levenshtein distance for each (seqs_a[i], seqs_b[i]) pair: the
    pairs are marshalled into [P, max(pad_to, longest)] rows and go to
    edit_distance_rows. Mirrors clique_tpu/collapse/distance.py:161-204."""
    assert len(seqs_a) == len(seqs_b)
    if not seqs_a:
        return np.zeros(0, dtype=np.int32)
    L = max(pad_to, max(max(len(s) for s in seqs_a),
                        max(len(s) for s in seqs_b)))
    P = len(seqs_a)

    def marshal(seqs, lens):
        if (lens == L).all():
            # uniform-length fast path: one C-speed join, no per-string pad
            return np.frombuffer(b"".join(seqs), dtype=np.uint8
                                 ).reshape(P, L)
        # mixed lengths: one join + block assignment per distinct length
        # (typically 2-3 distinct values) instead of a per-string ljust
        arr = np.zeros((P, L), dtype=np.uint8)
        for g in np.unique(lens):
            if g == 0:
                continue
            idx = np.flatnonzero(lens == g)
            sub = np.frombuffer(b"".join([seqs[i] for i in idx]),
                                dtype=np.uint8).reshape(len(idx), int(g))
            arr[idx, :g] = sub
        return arr

    la = np.fromiter(map(len, seqs_a), np.int32, count=P)
    lb = np.fromiter(map(len, seqs_b), np.int32, count=P)
    return edit_distance_rows(marshal(seqs_a, la), marshal(seqs_b, lb), la,
                              lb, device=device)


# --- Hamming against an allowlist ---------------------------------------------

def hamming_hits(tags: List[bytes], allowlist: List[bytes], max_distance: int,
                 device="cuda", chunk_u: int = 2048, chunk_k: int = 16384
                 ) -> List[List[int]]:
    """For each equal-length tag, indices of allowlist entries within Hamming
    radius max_distance (exact byte equality per column, as
    FastaString::hamming_distance, matches capped at 255), ascending per
    tag.

    Tags and allowlist go to `device` once and `match_hits` runs once over
    all of them; only the hits' indices come back to the host, and one
    split of them by tag builds the lists. chunk_u / chunk_k bound the
    plain version's temporaries on the CPU. Mirrors
    clique_tpu/collapse/distance.py:255-300."""
    if not tags or not allowlist:
        return [[] for _ in tags]
    L = len(allowlist[0])
    assert set(map(len, tags)) == {L}, "hamming requires equal lengths"
    assert set(map(len, allowlist)) == {L}
    dev = resolve_device(device)
    u, k = match_hits(upload_rows(tags, L, dev),
                      upload_rows(allowlist, L, dev), max_distance, chunk_u,
                      chunk_k)
    ends = np.searchsorted(u.cpu().numpy(), np.arange(len(tags) + 1)).tolist()
    ks = k.tolist()
    return [ks[a:b] for a, b in zip(ends, ends[1:])]


def upload_rows(seqs: List[bytes], L: int, dev) -> torch.Tensor:
    """Equal-length byte strings as a u8 [N, L] tensor on `dev`."""
    arr = np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(-1, L)
    return torch.from_numpy(arr.copy()).to(dev)


# --- pigeonhole candidate generation (host) ---------------------------------

def _piece_keys(a: np.ndarray):
    """Globally comparable scalar keys for byte-block rows: pieces of <= 8
    bytes pack into uint64 (much faster to sort/group than row-wise
    np.unique); wider pieces return None and callers fall back to
    np.unique(axis=0) ids. Mirrors clique_tpu/collapse/distance.py:314-325."""
    w = a.shape[1]
    if w > 8:
        return None
    k = np.zeros(a.shape[0], dtype=np.uint64)
    for c in range(w):
        k = (k << np.uint64(8)) | a[:, c].astype(np.uint64)
    return k


def _join_pairs(keys0: np.ndarray, keys1: np.ndarray, sorted0=None):
    """All (row0, row1) index pairs with keys0[row0] == keys1[row1], via
    one sort + searchsorted join, with no per-bucket python loop.
    `sorted0` lets callers reuse keys0's (order, sorted keys) across many
    keys1 probes (int32 rows: candidate sets are unique-tag indices, far
    below 2^31). Mirrors clique_tpu/collapse/distance.py:328-351."""
    if sorted0 is None:
        order0 = np.argsort(keys0, kind="stable").astype(np.int32)
        k0s = keys0[order0]
    else:
        order0, k0s = sorted0
    left = np.searchsorted(k0s, keys1, "left").astype(np.int32)
    right = np.searchsorted(k0s, keys1, "right").astype(np.int32)
    cnt = right - left
    total = int(cnt.sum())
    if total == 0:
        return None
    offs = np.cumsum(cnt, dtype=np.int64) - cnt
    intra = (np.arange(total, dtype=np.int64)
             - np.repeat(offs, cnt)).astype(np.int32)
    rows0 = order0[np.repeat(left, cnt) + intra]
    rows1 = np.repeat(np.arange(len(keys1), dtype=np.int32), cnt)
    return rows0, rows1


def _candidate_pairs_np(tags: List[bytes], max_distance: int,
                        counts: "np.ndarray" = None,
                        ratio: float = None) -> np.ndarray:
    """Vectorized pigeonhole for equal-length tags: byte-block packed keys
    + flat searchsorted joins. Mirrors
    clique_tpu/collapse/distance.py:354-488.

    With (counts, ratio): only pairs that can matter to ratio absorption
    are generated. A qualifying pair needs max(ci, cj) >= ratio * min(ci,
    cj) >= ratio * counts.min(), so one side always lies in the small
    high-count set H = {i: counts[i] >= ratio * cmin}; joining ALL x H
    (both unshifted/shifted directions) is an exact superset of
    qualifying pairs while skipping the count-1 x count-1 mass. Callers
    re-apply the exact (ci != cj) & ratio filter, so results are
    identical to the unrestricted join."""
    N = len(tags)
    L = len(tags[0])
    arr = np.frombuffer(b"".join(tags), dtype=np.uint8).reshape(N, L)
    n_pieces = max_distance + 1
    bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
    enc_chunks: List[np.ndarray] = []

    hmask = None
    if counts is not None and ratio is not None and N:
        counts = np.asarray(counts, dtype=np.int64)
        hset = np.flatnonzero(counts >= ratio * counts.min()).astype(
            np.int32)
        # the restricted path pays two joins per probe; only worth it
        # when H is genuinely sparse
        if len(hset) * 4 <= N:
            hmask = hset

    def _emit(r0: np.ndarray, r1: np.ndarray) -> None:
        # unordered (lo, hi) pairs packed straight into the int64 dedupe
        # encoding, no [P, 2] stack per join
        lo_i = np.minimum(r0, r1).astype(np.int64)
        enc_chunks.append(lo_i * N + np.maximum(r0, r1))

    for p in range(n_pieces):
        lo, hi = bounds[p], bounds[p + 1]
        if hi <= lo:
            continue
        a0 = arr[:, lo:hi]
        k0 = _piece_keys(a0)
        if k0 is None:
            _u, k0 = np.unique(a0, axis=0, return_inverse=True)
        order0 = np.argsort(k0, kind="stable").astype(np.int32)
        sorted0 = (order0, k0[order0])      # reused across every probe
        # same-piece buckets: self-join, keep each unordered pair once.
        # Count-restricted: ALL x H covers every qualifying pair (the
        # high side is in H by construction).
        if hmask is not None:
            j = _join_pairs(k0, k0[hmask], sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                r1 = hmask[r1]
                keep = r0 != r1
                if keep.any():
                    _emit(r0[keep], r1[keep])
        else:
            j = _join_pairs(k0, k0, sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                keep = r0 < r1
                if keep.any():
                    _emit(r0[keep], r1[keep])
        # shifted pieces join against the unshifted buckets. EQUAL-length
        # strings at Levenshtein <= d pair every insertion with a
        # deletion, so the alignment offset at any point is bounded by
        # floor(d/2): shifts beyond that cannot witness a real pair
        # (the ragged fallback path keeps the full +-d range)
        max_shift = max_distance // 2
        for s in range(-max_shift, max_shift + 1):
            if s == 0 or lo + s < 0 or hi + s > L:
                continue
            a_s = arr[:, lo + s:hi + s]
            k_s = _piece_keys(a_s)
            if k_s is None:
                _u, invb = np.unique(np.vstack([a0, a_s]), axis=0,
                                     return_inverse=True)
                kk0, kk1 = invb[:N], invb[N:]
                if hmask is not None:
                    # clean piece on either side: (ALL unshifted x H
                    # shifted) + (H unshifted x ALL shifted)
                    j = None
                    ja = _join_pairs(kk0, kk1[hmask])
                    if ja is not None:
                        r0, r1 = ja
                        r1 = hmask[r1]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                    jb = _join_pairs(kk0[hmask], kk1)
                    if jb is not None:
                        r0, r1 = jb
                        r0 = hmask[r0]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                else:
                    j = _join_pairs(kk0, kk1)
            else:
                # same width as a0, so k0 holds packed (comparable) keys
                if hmask is not None:
                    j = None
                    ja = _join_pairs(k0, k_s[hmask], sorted0=sorted0)
                    if ja is not None:
                        r0, r1 = ja
                        r1 = hmask[r1]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                    # H's unshifted pieces vs everyone's shifted windows:
                    # sort the H-restricted keys once per probe
                    jb = _join_pairs(k0[hmask], k_s)
                    if jb is not None:
                        r0, r1 = jb
                        r0 = hmask[r0]
                        keep = r0 != r1
                        if keep.any():
                            _emit(r1[keep], r0[keep])
                else:
                    j = _join_pairs(k0, k_s, sorted0=sorted0)
            if j is not None:
                r0, r1 = j
                keep = r0 != r1
                if keep.any():
                    _emit(r1[keep], r0[keep])

    if not enc_chunks:
        return np.zeros((0, 2), dtype=np.int64)
    enc = np.unique(np.concatenate(enc_chunks))
    return np.stack([enc // N, enc % N], axis=1)


def _pieces(seq: bytes, n_pieces: int) -> List[Tuple[int, bytes]]:
    """The n_pieces (index, piece) cuts of seq. Mirrors
    clique_tpu/collapse/distance.py:490-493."""
    L = len(seq)
    bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
    return [(i, seq[bounds[i]:bounds[i + 1]]) for i in range(n_pieces)]


def candidate_pairs_array(tags: List[bytes], max_distance: int,
                          counts: "np.ndarray" = None,
                          ratio: float = None) -> np.ndarray:
    """candidate_pairs returning an [P, 2] i64 ndarray directly (no python
    tuple round-trip), the form degenerate_prepare consumes. counts/ratio
    (optional, equal-length path only) restrict the superset to pairs that
    can pass ratio absorption (see _candidate_pairs_np). Mirrors
    clique_tpu/collapse/distance.py:496-507."""
    if tags and len({len(t) for t in tags}) == 1:
        return _candidate_pairs_np(tags, max_distance, counts=counts,
                                   ratio=ratio)
    return np.array(candidate_pairs(tags, max_distance),
                    dtype=np.int64).reshape(-1, 2)


def candidate_pairs(tags: List[bytes], max_distance: int
                    ) -> List[Tuple[int, int]]:
    """Superset of all pairs within edit distance max_distance, via the
    d+1-piece pigeonhole with +-d shifts (indel tolerance).

    Equal-length tag sets (the common case: normalize_tag pads) take the
    vectorized numpy path; ragged sets fall back to the dict build.
    Mirrors clique_tpu/collapse/distance.py:510-550."""
    if tags and len({len(t) for t in tags}) == 1:
        arr = _candidate_pairs_np(tags, max_distance)
        return list(zip(arr[:, 0].tolist(), arr[:, 1].tolist()))
    n_pieces = max_distance + 1
    buckets: Dict[Tuple[int, int, bytes], List[int]] = defaultdict(list)
    for idx, t in enumerate(tags):
        L = len(t)
        bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
        for p in range(n_pieces):
            lo, hi = bounds[p], bounds[p + 1]
            for shift in range(-max_distance, max_distance + 1):
                s, e = lo + shift, hi + shift
                if s < 0 or e > L:
                    continue
                buckets[(p, shift, t[s:e])].append(idx)
    pairs = set()
    for (p, shift, _piece), members in buckets.items():
        if shift != 0:
            continue
        for i in members:
            pairs.update((min(i, j), max(i, j)) for j in members if j != i)
    # shifted pieces join against unshifted ones
    unshifted: Dict[Tuple[int, bytes], List[int]] = defaultdict(list)
    for (p, shift, piece), members in buckets.items():
        if shift == 0:
            unshifted[(p, piece)].extend(members)
    for (p, shift, piece), members in buckets.items():
        if shift == 0:
            continue
        base = unshifted.get((p, piece))
        if not base:
            continue
        for i in members:
            pairs.update((min(i, j), max(i, j)) for j in base if j != i)
    return sorted(pairs)


def candidates_to_allowlist(tags: List[bytes], allowlist: List[bytes],
                            max_distance: int) -> List[List[int]]:
    """For each tag, allowlist indices sharing a pigeonhole piece (candidate
    superset for Levenshtein <= max_distance matching). Mirrors
    clique_tpu/collapse/distance.py:553-575."""
    n_pieces = max_distance + 1
    index: Dict[Tuple[int, bytes], List[int]] = defaultdict(list)
    for k, a in enumerate(allowlist):
        for p, piece in _pieces(a, n_pieces):
            index[(p, piece)].append(k)
    out: List[List[int]] = []
    for t in tags:
        L = len(t)
        bounds = [round(i * L / n_pieces) for i in range(n_pieces + 1)]
        cands = set()
        for p in range(n_pieces):
            lo, hi = bounds[p], bounds[p + 1]
            for shift in range(-max_distance, max_distance + 1):
                s, e = lo + shift, hi + shift
                if s < 0 or e > L:
                    continue
                cands.update(index.get((p, t[s:e]), ()))
        out.append(sorted(cands))
    return out
