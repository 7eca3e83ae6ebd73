"""Tag correction on PyTorch + CUDA: known-list matching and de-novo
(starcode-style) clustering.

Jax-free copy of clique_tpu/collapse/correct.py:42-399 on the port's
distance module (collapse/distance.py), with the torch `device` the
distance kernels run on threaded through:

- correct_known_hamming: accept iff exactly one allowlist entry lies
  within Hamming max_distance (match_hits kernel).
- correct_known_levenshtein: pigeonhole candidates + Levenshtein; unique
  hit accepted, multi-hit accepted iff a unique minimum distance.
- correct_degenerate: the one-group form (correct.py:402) of
  correct_degenerate_groups; no pipeline path calls it.
- correct_degenerate_groups: candidate pairs + Levenshtein + greedy
  count-ratio absorption (bigger cluster absorbs smaller when
  count_big/count_small >= minimum_collapsing_difference, default 5.0)
  with swallowed-link transitivity. From EDIT_HITS_MIN_PAIRS candidate
  pairs a call, groups of tags of at most 64 bytes go to one tag matrix on
  `device` and the edit_hits kernel enumerates, filters and tests their
  pairs there; only the close pairs come back.

All corrections key on the gap-stripped tag padded with '-' to the
configured length.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from clique_tpu_torch.utils.seq import normalize_tag

from clique_tpu_torch.collapse.distance import (
    EDIT_HITS_MAX_LEN,
    candidate_pairs_array,
    candidates_to_allowlist,
    edit_distance_pairs,
    edit_distance_rows,
    edit_hits,
    hamming_hits,
    resolve_device,
)

GAP = ord("-")
# candidate pairs a correct_degenerate_groups call needs before its groups
# of tags of at most 64 bytes go to the edit_hits kernel instead of the
# host pair preparation and Myers code: where the two routes took the same
# time on an H100 80GB HBM3 at 700 W (5.5-6.0 ms at 4,096 pairs of 12 bp
# UMIs; the host 2.7-2.8 ms against 4.3-4.8 at 1,024, 20.4-21.7 against
# 8.1-8.9 at 16,384), chip_smoke.py's threshold phase
EDIT_HITS_MIN_PAIRS = 4_096
# groups above this many tags take the pigeonhole candidates instead of
# every pair (clique_tpu/collapse/correct.py:200)
PIGEONHOLE_MIN_TAGS = 4096


def tag_consensus(seqs) -> bytes:
    """Per-column majority over equal-length byte strings with N/'-'
    losing ties to real bases; real-base ties break by first appearance.
    Mirrors clique_tpu/collapse/correct.py:42-62."""
    n = len(seqs[0])
    out = bytearray()
    for i in range(n):
        counts: Dict[int, int] = {}
        order: List[int] = []
        for s in seqs:
            assert len(s) == n, "consensus inputs must share a length"
            b = s[i]
            if b not in counts:
                order.append(b)
            counts[b] = counts.get(b, 0) + 1
        mx = max(counts.values())
        best = [b for b in order if counts[b] == mx]
        real = [b for b in best if b not in (ord("N"), GAP)]
        out.append(real[0] if real else best[0])
    return bytes(out)


def correct_known_hamming(counts: Dict[bytes, int], allowlist: List[bytes],
                          max_distance: int, length: int,
                          device="cuda") -> Dict[bytes, bytes]:
    """KnownList::correct_all semantics: pad tags to `length`, radius search,
    accept unique hits only. Keys of the result are the RAW observed tags.
    Mirrors clique_tpu/collapse/correct.py:74-92."""
    if not counts or not allowlist:
        return {}
    tags = list(counts.keys())
    padded = [t + b"-" * (length - len(t)) if len(t) < length else t
              for t in tags]
    # allowlist entries are used as-is (reference asserts equal length)
    usable = [(i, t) for i, t in enumerate(padded)
              if len(t) == len(allowlist[0])]
    hits = hamming_hits([t for _i, t in usable], allowlist, max_distance,
                        device=device)
    out: Dict[bytes, bytes] = {}
    for (i, _t), hit in zip(usable, hits):
        if len(hit) == 1:
            out[tags[i]] = allowlist[hit[0]]
    return out


def correct_known_levenshtein(counts: Dict[bytes, int], allowlist: List[bytes],
                              max_distance: int, length: int,
                              device="cuda") -> Dict[bytes, bytes]:
    """Trie chained-search semantics: tags matched against the allowlist by
    Levenshtein distance <= max_distance; unique hit accepted; multiple hits
    accepted iff one has the strictly minimal distance. Result keys are the
    normalized (gap-stripped, padded) tags. Mirrors
    clique_tpu/collapse/correct.py:95-132."""
    if not counts or not allowlist:
        return {}
    tags = sorted(counts.keys())
    norm = [normalize_tag(t, length) for t in tags]
    cands = candidates_to_allowlist(norm, allowlist, max_distance)

    pair_a: List[bytes] = []
    pair_b: List[bytes] = []
    owners: List[Tuple[int, int]] = []
    for i, cand in enumerate(cands):
        for k in cand:
            pair_a.append(norm[i])
            pair_b.append(allowlist[k])
            owners.append((i, k))
    dists = edit_distance_pairs(pair_a, pair_b, device=device)

    per_tag: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for (i, k), d in zip(owners, dists):
        if d <= max_distance:
            per_tag[i].append((int(d), k))

    out: Dict[bytes, bytes] = {}
    for i, hits in per_tag.items():
        if len(hits) == 1:
            out[norm[i]] = allowlist[hits[0][1]]
        else:
            dmin = min(d for d, _k in hits)
            minimal = [k for d, k in hits if d == dmin]
            if len(minimal) == 1:
                out[norm[i]] = allowlist[minimal[0]]
    return out


_TRIU_CACHE: Dict[int, np.ndarray] = {}
_TRIU_CACHE_BYTES = [0]
_TRIU_CACHE_BUDGET = 64 << 20        # total resident bytes
_TRIU_ENTRY_CAP = 8 << 20            # don't cache huge sizes (n ~> 1000)


def _triu_pairs(n: int) -> np.ndarray:
    """All (i, j<i) index pairs as one [P, 2] i64 array, cached by n (bins
    within a level share a handful of sizes). The cache is byte-bounded:
    only small arrays are kept, and the whole cache clears past a fixed
    budget. Mirrors clique_tpu/collapse/correct.py:141-158."""
    hit = _TRIU_CACHE.get(n)
    if hit is None:
        ii, jj = np.triu_indices(n, 1)
        hit = np.stack([ii, jj], axis=1).astype(np.int64)
        if hit.nbytes <= _TRIU_ENTRY_CAP:
            if _TRIU_CACHE_BYTES[0] + hit.nbytes > _TRIU_CACHE_BUDGET:
                _TRIU_CACHE.clear()
                _TRIU_CACHE_BYTES[0] = 0
            _TRIU_CACHE[n] = hit
            _TRIU_CACHE_BYTES[0] += hit.nbytes
    return hit


def degenerate_prepare(counts: Dict[bytes, int], max_distance: int,
                       length: int, collapse_ratio: float = 5.0):
    """Stage 1 of degenerate correction: normalize tags, build the padded
    tag matrix and the candidate-pair index array. Returns
    (norm_counts, tags, mat [T, max_len] u8, pairs [P, 2] i64, ready);
    ready is the finished map for the trivial 0/1-tag cases. Pairs are
    pre-filtered by the absorption rule before any distance is computed
    (only differing counts at ratio >= collapse_ratio can absorb). Mirrors
    clique_tpu/collapse/correct.py:161-183."""
    if not counts:
        return None, None, None, None, {}
    norm_counts: Counter = Counter()
    for tag, c in counts.items():
        norm_counts[normalize_tag(tag, length)] += c
    tags = list(norm_counts.keys())
    if len(tags) == 1:
        return None, None, None, None, {tags[0]: tags[0]}
    mat, pairs = _prepare_pairs(norm_counts, tags, max_distance,
                                collapse_ratio)
    return norm_counts, tags, mat, pairs, None


def _prepare_pairs(norm_counts, tags, max_distance: int,
                   collapse_ratio: float, candidates=None):
    """Tag matrix + count-ratio-filtered candidate pairs for an
    already-normalized multi-tag group, in the caller's tag ordering
    (`candidates`: the pigeonhole pairs of a group past
    PIGEONHOLE_MIN_TAGS tags, where the caller has them already).
    Mirrors clique_tpu/collapse/correct.py:186-218."""
    mat = _padded_matrix(tags)
    cnt = _counts_of(norm_counts, tags)
    if len(tags) <= PIGEONHOLE_MIN_TAGS:
        pairs = _count_filtered_pairs(cnt, collapse_ratio)
        if pairs is None:
            pairs = _triu_pairs(len(tags))
    elif candidates is not None:
        pairs = candidates
    else:
        pairs = _pigeonhole_pairs(tags, cnt, max_distance, collapse_ratio)
    ci, cj = cnt[pairs[:, 0]], cnt[pairs[:, 1]]
    hi = np.maximum(ci, cj)
    lo = np.minimum(ci, cj)
    pairs = pairs[(ci != cj) & (hi >= collapse_ratio * lo)]
    return mat, pairs


def _padded_matrix(tags) -> np.ndarray:
    """u8 [T, longest] rows of the tags, each padded with '-' (one join
    and block copy per distinct length)."""
    lens = np.fromiter(map(len, tags), np.int64, count=len(tags))
    max_len = int(lens.max())
    if (lens == max_len).all():
        return np.frombuffer(bytearray(b"".join(tags)), dtype=np.uint8
                             ).reshape(len(tags), max_len)
    mat = np.full((len(tags), max_len), GAP, dtype=np.uint8)
    for g in np.unique(lens):
        idx = np.flatnonzero(lens == g)
        mat[idx, :g] = np.frombuffer(
            b"".join([tags[i] for i in idx]), dtype=np.uint8
        ).reshape(len(idx), int(g))
    return mat


def _pigeonhole_pairs(tags, cnt, max_distance: int, collapse_ratio: float):
    """The pigeonhole candidate pairs [P, 2] i64 of one group's tags, each
    padded with '-' to the longest."""
    max_len = max(map(len, tags))
    padded = [t + b"-" * (max_len - len(t)) for t in tags]
    return candidate_pairs_array(padded, max_distance, counts=cnt,
                                 ratio=collapse_ratio)


def _count_filtered_pairs(cnt: np.ndarray,
                          collapse_ratio: float) -> Optional[np.ndarray]:
    """H x ALL cross-product pair indices for one group: every pair that
    can pass ratio absorption has its high side in H = {i: cnt[i] >=
    ratio * cnt.min()}, so when H is small this [h*T, 2] array is an
    exact-superset replacement for the [T*(T-1)/2] triu. Returns None when
    H is too big to beat triu. (i, i) self-rows and duplicates are
    harmless: self-rows fail the ci != cj filter and duplicate absorption
    links are idempotent. Mirrors clique_tpu/collapse/correct.py:221-239."""
    T = len(cnt)
    hset = np.flatnonzero(cnt >= collapse_ratio * cnt.min())
    h = len(hset)
    if h * 2 >= T - 1:
        return None
    left = np.repeat(hset.astype(np.int64), T)
    right = np.tile(np.arange(T, dtype=np.int64), h)
    return np.stack([left, right], axis=1)


def degenerate_finish(norm_counts, tags, pairs, dists, max_distance: int,
                      collapse_ratio: float) -> Dict[bytes, bytes]:
    """Stage 2: ratio absorption + transitive resolution given pair
    distances. pairs [P, 2] i64, dists [P]. Mirrors
    clique_tpu/collapse/correct.py:242-270."""
    close = pairs[np.asarray(dists) <= max_distance]
    parent = list(range(len(tags)))

    def better_absorber(a: int, cur: int) -> bool:
        ca, cc = norm_counts[tags[a]], norm_counts[tags[cur]]
        return ca > cc or (ca == cc and tags[a] < tags[cur])

    for i, j in close.tolist():
        ci, cj = norm_counts[tags[i]], norm_counts[tags[j]]
        if ci == cj:
            continue
        a, b = (i, j) if ci > cj else (j, i)
        ca, cb = max(ci, cj), min(ci, cj)
        if ca / cb >= collapse_ratio:
            if parent[b] == b or better_absorber(a, parent[b]):
                parent[b] = a

    def root(i: int) -> int:
        seen = set()
        while parent[i] != i and i not in seen:
            seen.add(i)
            i = parent[i]
        return i

    return {tags[i]: tags[root(i)] for i in range(len(tags))}


def correct_degenerate_groups(group_counts, max_distance: int, length: int,
                              collapse_ratio: float = 5.0, device="cuda"):
    """Degenerate correction over many groups. Every group is normalized;
    groups of more than one tag then take one of two routes:

    - the host route (`_rows_route`), the JAX package's: one flat
      preparation pass builds every candidate pair and its two rows, and
      one distance call (host Myers, or edit_distance where
      edit_distance_rows sends it) tests them all;
    - the edit-hits route (`_hits_route`), for the groups of tags of at
      most EDIT_HITS_MAX_LEN bytes once the call's candidate pairs reach
      EDIT_HITS_MIN_PAIRS: their tags go to `device` as one matrix and
      edit_hits returns only the close pairs.

    Candidate pairs are counted as the host route would build them: a
    group's count-filtered or triu pairs, or its pigeonhole candidates
    past PIGEONHOLE_MIN_TAGS tags. Both routes feed degenerate_finish the
    same close pairs, so the maps are equal. Mirrors
    clique_tpu/collapse/correct.py:273-399."""
    results, norm_list, tag_lists, multi = _normalize_groups(group_counts,
                                                             length)
    narrow, candidates, n_pairs = _plan(multi, norm_list, tag_lists,
                                        max_distance, collapse_ratio)
    rows = multi
    if narrow and n_pairs >= EDIT_HITS_MIN_PAIRS:
        small = [gi for gi in narrow if gi not in candidates]
        _hits_route(small, list(candidates), candidates, norm_list,
                    tag_lists, results, max_distance, collapse_ratio,
                    device)
        done = set(narrow)
        rows = [gi for gi in multi if gi not in done]
    if rows:
        _rows_route(rows, candidates, norm_list, tag_lists, results,
                    max_distance, length, collapse_ratio, device)
    return results


def _normalize_groups(group_counts, length: int):
    """Each group's tags normalized (counts of tags equal after
    normalize_tag summed). Returns (results with the maps of empty and
    one-tag groups filled in, normalized Counters, tag lists, the indices
    of the groups of more than one tag)."""
    n_groups = len(group_counts)
    results: List[Optional[Dict[bytes, bytes]]] = [None] * n_groups
    norm_list: List[Optional[Counter]] = [None] * n_groups
    tag_lists: List[Optional[List[bytes]]] = [None] * n_groups
    multi: List[int] = []
    for gi, counts in enumerate(group_counts):
        if not counts:
            results[gi] = {}
            continue
        nc: Counter = Counter()
        for tag, c in counts.items():
            nc[normalize_tag(tag, length)] += c
        norm_list[gi] = nc
        tags = list(nc.keys())
        tag_lists[gi] = tags
        if len(tags) == 1:
            results[gi] = {tags[0]: tags[0]}
        else:
            multi.append(gi)
    return results, norm_list, tag_lists, multi


def _plan(multi, norm_list, tag_lists, max_distance: int,
          collapse_ratio: float):
    """The groups the edit-hits route could take (tags of at most
    EDIT_HITS_MAX_LEN bytes), the pigeonhole candidates of those past
    PIGEONHOLE_MIN_TAGS tags, and the call's candidate pairs."""
    narrow = [gi for gi in multi
              if max(map(len, tag_lists[gi])) <= EDIT_HITS_MAX_LEN]
    candidates = {gi: _pigeonhole_pairs(
        tag_lists[gi], _counts_of(norm_list[gi], tag_lists[gi]),
        max_distance, collapse_ratio)
        for gi in narrow if len(tag_lists[gi]) > PIGEONHOLE_MIN_TAGS}
    small = [norm_list[gi] for gi in narrow if gi not in candidates]
    n_pairs = (_prefiltered_pairs(small, collapse_ratio)
               + sum(len(p) for p in candidates.values()))
    return narrow, candidates, n_pairs


def candidate_pair_count(group_counts, max_distance: int, length: int,
                         collapse_ratio: float = 5.0) -> int:
    """The candidate pairs correct_degenerate_groups compares with
    EDIT_HITS_MIN_PAIRS for these arguments."""
    _r, norm_list, tag_lists, multi = _normalize_groups(group_counts, length)
    return _plan(multi, norm_list, tag_lists, max_distance,
                 collapse_ratio)[2]


def _counts_of(norm_counts, tags) -> np.ndarray:
    return np.fromiter((norm_counts[t] for t in tags), np.int64,
                       count=len(tags))


def _prefiltered_pairs(norm_lists, collapse_ratio: float) -> int:
    """The pairs the host route builds for groups of at most
    PIGEONHOLE_MIN_TAGS tags before its ratio filter: h * T where
    _count_filtered_pairs applies (h tags of count >= ratio * least), else
    the T (T - 1) / 2 of _triu_pairs. O(T), no per-group numpy call."""
    if not norm_lists:
        return 0
    sizes = np.fromiter(map(len, norm_lists), np.int64,
                        count=len(norm_lists))
    cnt = np.fromiter((c for nc in norm_lists for c in nc.values()),
                      np.int64, count=int(sizes.sum()))
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    least = np.minimum.reduceat(cnt, starts)
    h = np.add.reduceat(cnt >= collapse_ratio * np.repeat(least, sizes),
                        starts)
    triu = sizes * (sizes - 1) // 2
    return int(np.where(h * 2 >= sizes - 1, triu, h * sizes).sum())


def _hits_route(small, big, candidates, norm_list, tag_lists, results,
                max_distance: int, collapse_ratio: float, device) -> None:
    """Close pairs from edit_hits for groups of tags of at most
    EDIT_HITS_MAX_LEN bytes: `small` groups (at most PIGEONHOLE_MIN_TAGS
    tags) have every pair enumerated on the device, `big` groups have
    their pigeonhole `candidates` tested. One tag matrix holds both, the
    small groups first, each tag padded with '-' to its group's longest
    (as _prepare_pairs pads); it, the counts and the offsets are the only
    O(T) uploads, and only the close pairs come back."""
    dev = resolve_device(device)
    order = small + big
    tags = [t for gi in order for t in tag_lists[gi]]
    sizes = np.fromiter((len(tag_lists[gi]) for gi in order), np.int64,
                        count=len(order))
    offs = np.concatenate(([0], np.cumsum(sizes))).astype(np.int32)
    lens = np.fromiter(map(len, tags), np.int64, count=len(tags))
    widths = np.maximum.reduceat(lens, offs[:-1]).astype(np.int32)
    cnt = np.fromiter((norm_list[gi][t] for gi in order
                       for t in tag_lists[gi]), np.int64, count=len(tags))
    mat_d, cnt_d, offs_d, widths_d = (
        torch.from_numpy(x).to(dev)
        for x in (_padded_matrix(tags), cnt, offs, widths))
    none = torch.zeros(0, dtype=torch.int64)
    hits = [(none, none)]
    if small:
        n_small = int(offs[len(small)])
        hits.append(edit_hits(mat_d[:n_small], cnt_d[:n_small],
                              offs_d[:len(small) + 1],
                              widths_d[:len(small)], max_distance,
                              collapse_ratio))
    if big:
        pairs = np.concatenate(
            [candidates[gi] + offs[len(small) + k]
             for k, gi in enumerate(big)]).astype(np.int32)
        if len(pairs):
            hits.append(edit_hits(mat_d, cnt_d, offs_d, widths_d,
                                  max_distance, collapse_ratio,
                                  torch.from_numpy(pairs).to(dev)))
    h = np.concatenate([x[0].cpu().numpy() for x in hits])
    j = np.concatenate([x[1].cpu().numpy() for x in hits])
    # both calls return hits sorted by h, the small groups' below the big
    # groups' tags
    bounds = np.searchsorted(h, offs)
    for k, gi in enumerate(order):
        s, e = int(bounds[k]), int(bounds[k + 1])
        close = np.stack([h[s:e], j[s:e]], axis=1) - int(offs[k])
        results[gi] = degenerate_finish(
            norm_list[gi], tag_lists[gi], close,
            np.zeros(e - s, np.uint8), max_distance, collapse_ratio)


def _rows_route(groups, candidates, norm_list, tag_lists, results,
                max_distance: int, length: int, collapse_ratio: float,
                device) -> None:
    """The host route over `groups`: one distance call for every group's
    candidate pairs combined, and one flat preparation pass: groups whose
    normalized tags all have the standard length share a single tag
    matrix, cached-triu pair index array and count-ratio pre-filter.
    Fills `results`."""
    flat: List[int] = []       # uniform-length multi-tag groups
    odd: List[int] = []        # per-group preparation
    for gi in groups:
        tags = tag_lists[gi]
        if len(tags) <= PIGEONHOLE_MIN_TAGS and all(len(t) == length
                                                     for t in tags):
            flat.append(gi)
        else:
            odd.append(gi)

    # --- flat path: one matrix + one pair array across all groups -----------
    seg_A = seg_B = None
    flat_pairs = flat_bounds = None
    if flat:
        sizes = np.fromiter((len(tag_lists[gi]) for gi in flat), np.int64,
                            count=len(flat))
        offs = np.concatenate(([0], np.cumsum(sizes)))
        mat = np.frombuffer(
            b"".join(t for gi in flat for t in tag_lists[gi]),
            dtype=np.uint8).reshape(int(offs[-1]), length)
        cnt = np.fromiter(
            (c for gi in flat for c in norm_list[gi].values()),
            np.int64, count=int(offs[-1]))
        pair_chunks = []
        pair_group = []
        for k, gi in enumerate(flat):
            cnt_g = cnt[offs[k]:offs[k + 1]]
            p = _count_filtered_pairs(cnt_g, collapse_ratio)
            if p is None:
                p = _triu_pairs(int(sizes[k]))
            pair_chunks.append(p + offs[k])
            pair_group.append(np.full(len(p), k, dtype=np.int32))
        pairs_all = np.concatenate(pair_chunks)
        group_of = np.concatenate(pair_group)
        ci, cj = cnt[pairs_all[:, 0]], cnt[pairs_all[:, 1]]
        hi = np.maximum(ci, cj)
        lo = np.minimum(ci, cj)
        keep = (ci != cj) & (hi >= collapse_ratio * lo)
        flat_pairs = pairs_all[keep]
        group_of = group_of[keep]
        # per-group span bounds in the filtered (still group-ordered) array
        flat_bounds = np.searchsorted(group_of, np.arange(len(flat) + 1))
        Lk = max(32, length)
        seg_A = np.zeros((len(flat_pairs), Lk), dtype=np.uint8)
        seg_B = np.zeros_like(seg_A)
        seg_A[:, :length] = mat[flat_pairs[:, 0]]
        seg_B[:, :length] = mat[flat_pairs[:, 1]]

    # --- odd path: per-group preparation (variable lengths / huge groups),
    # reusing the outer loop's normalization so pair indices and the finish
    # step share one tag ordering ---
    odd_rows: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
    for gi in odd:
        mat_g, pairs_g = _prepare_pairs(norm_list[gi], tag_lists[gi],
                                        max_distance, collapse_ratio,
                                        candidates.get(gi))
        if len(pairs_g) == 0:
            results[gi] = {t: t for t in tag_lists[gi]}
        else:
            odd_rows.append((gi, mat_g, pairs_g, mat_g.shape[1]))

    n_flat = len(flat_pairs) if flat_pairs is not None else 0
    total = n_flat + sum(len(p) for _gi, _m, p, _w in odd_rows)
    if total:
        Lk = max([32] + ([length] if n_flat else [])
                 + [w for _gi, _m, _p, w in odd_rows])
        A = np.zeros((total, Lk), dtype=np.uint8)
        B = np.zeros((total, Lk), dtype=np.uint8)
        la = np.empty(total, dtype=np.int32)
        if n_flat:
            A[:n_flat, :seg_A.shape[1]] = seg_A
            B[:n_flat, :seg_B.shape[1]] = seg_B
            la[:n_flat] = length
        pos = n_flat
        odd_spans = []
        for _gi, mat_g, pairs_g, w in odd_rows:
            e = pos + len(pairs_g)
            A[pos:e, :w] = mat_g[pairs_g[:, 0]]
            B[pos:e, :w] = mat_g[pairs_g[:, 1]]
            la[pos:e] = w
            odd_spans.append((pos, e))
            pos = e
        dists = edit_distance_rows(A, B, la, la, device=device)
    else:
        dists = np.zeros(0, np.uint8)
        odd_spans = []

    if flat:
        for k, gi in enumerate(flat):
            if results[gi] is not None:
                continue
            s, e = int(flat_bounds[k]), int(flat_bounds[k + 1])
            if s == e:
                results[gi] = {t: t for t in tag_lists[gi]}
            else:
                results[gi] = degenerate_finish(
                    norm_list[gi], tag_lists[gi],
                    flat_pairs[s:e] - int(offs[k]),
                    dists[s:e], max_distance, collapse_ratio)
    for (gi, _mat, pairs_g, _w), (s, e) in zip(odd_rows, odd_spans):
        results[gi] = degenerate_finish(
            norm_list[gi], tag_lists[gi], pairs_g, dists[s:e],
            max_distance, collapse_ratio)


def correct_degenerate(counts: Dict[bytes, int], max_distance: int,
                       length: int, collapse_ratio: float = 5.0,
                       device="cuda") -> Dict[bytes, bytes]:
    """Starcode-style ratio clustering of one group (correct_tags.rs:256-332):

    - 0 tags -> {}; 1 tag -> maps (padded) to itself;
    - else: pad tags, find pairs within Levenshtein max_distance, absorb the
      lower-count tag into the higher-count one when the count ratio >=
      collapse_ratio, resolve absorption chains transitively to the root.

    Result keys are the normalized tags; every observed tag maps somewhere
    (unabsorbed tags map to themselves). The one-group form of
    correct_degenerate_groups: absorption does not depend on the order of
    the close pairs, so the map equals that of
    clique_tpu/collapse/correct.py:402-477."""
    return correct_degenerate_groups([counts], max_distance, length,
                                     collapse_ratio, device=device)[0]
