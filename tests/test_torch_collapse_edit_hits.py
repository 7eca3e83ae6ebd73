"""The edit-hits path of degenerate correction (clique_tpu_torch.collapse:
distance.edit_hits and correct.correct_degenerate_groups's edit-hits
route) against the JAX package (clique_tpu.collapse, jax on the CPU).

Inputs are made from seeds with numpy and handed to both. On the CPU
edit_hits runs its plain version; the kernel itself is held against that
in tests/test_torch_cuda.py on the card, and its enumeration (tags sorted
by count, a warp's partners a prefix swept 32 at a time, the early exit of
a pair) is emulated here on the wrapper's own encoding. Every distance and
decision is an integer, so every comparison is exact.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import clique_tpu.collapse.correct as jcorrect
import clique_tpu.collapse.distance as jdist
from clique_tpu_torch.collapse import correct as tcorrect
from clique_tpu_torch.collapse import distance as tdist

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
RATIO = 5.0


def _edit(rng, tag, n):
    """tag with n random edits (substitution, or an insertion or deletion
    that keeps the width), never '-'."""
    t = bytearray(tag)
    w = len(t)
    for _ in range(n):
        kind = rng.integers(3)
        p = int(rng.integers(w))
        if kind == 0:
            t[p] = int(rng.choice(BASES))
        elif kind == 1:
            t = t[:p] + bytes([int(rng.choice(BASES))]) + t[p:w - 1]
        else:
            t = t[:p] + t[p + 1:] + bytes([int(rng.choice(BASES))])
    return bytes(t)


def _group(rng, T, w, n_centers, d, dense=False, mixed=False):
    """T distinct tags of w bytes with counts: n_centers centers of counts
    10-40 (ties among them), the rest 1 to d + 1 edits from a center with
    counts 1-4 (2 where the center has 10: hi == ratio * lo exactly). With
    `dense` the low counts are 2-9 and two thirds of the tags have a count
    of at least ratio times the least (so the JAX preparation takes the
    triu pairs); with `mixed` some tags lose one to three bytes at the end
    (the group is padded with '-' to its longest)."""
    centers = [rng.choice(BASES, w).tobytes() for _ in range(n_centers)]
    counts = {}
    for k, c in enumerate(centers):
        counts[c] = 10 + 10 * (k % 4)
    while len(counts) < T:
        k = int(rng.integers(n_centers))
        t = _edit(rng, centers[k], int(rng.integers(1, d + 2)))
        if mixed and rng.random() < 0.3:
            t = t[:w - int(rng.integers(1, 4))]
        if t in counts:
            continue
        if dense:
            counts[t] = int(rng.choice([1, 10, 11, 12, 20, 30, 40, 50])) \
                if rng.random() < 0.7 else int(rng.integers(2, 10))
        elif counts[centers[k]] == 10 and rng.random() < 0.5:
            counts[t] = 2
        else:
            counts[t] = int(rng.integers(1, 5))
    tags = list(counts)
    return tags, np.array([counts[t] for t in tags], np.int64)


def _matrix(groups):
    """The port's inputs for groups of (tags, counts): u8 [T, W] with each
    tag padded with '-' to its group's longest, counts, offsets, widths."""
    widths = [max(map(len, tags)) for tags, _c in groups]
    W = max(widths)
    rows, cnt, offs = [], [], [0]
    for (tags, c), w in zip(groups, widths):
        rows += [t.ljust(w, b"-").ljust(W, b"-") for t in tags]
        cnt.append(c)
        offs.append(offs[-1] + len(tags))
    mat = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, W)
    return (torch.from_numpy(mat.copy()), torch.from_numpy(np.concatenate(cnt)),
            torch.tensor(offs, dtype=torch.int32),
            torch.tensor(widths, dtype=torch.int32))


def _jax_hits(groups, d, ratio):
    """The pairs of the JAX package's preparation (correct.py:_prepare_pairs:
    triu, count-filtered or pigeonhole pairs, then the ratio filter) whose
    distance by jdist.edit_distance_rows is at most d, as sorted (h, j)
    flat indices with h the higher count."""
    out, off = [], 0
    for tags, cnt in groups:
        nc = Counter(dict(zip(tags, cnt.tolist())))
        mat, pairs = jcorrect._prepare_pairs(nc, tags, d, ratio)
        w = np.full(len(pairs), mat.shape[1], np.int32)
        dist = jdist.edit_distance_rows(mat[pairs[:, 0]], mat[pairs[:, 1]],
                                        w, w)
        close = pairs[dist <= d]
        up = cnt[close[:, 0]] > cnt[close[:, 1]]
        h = np.where(up, close[:, 0], close[:, 1]) + off
        j = np.where(up, close[:, 1], close[:, 0]) + off
        out += list(zip(h.tolist(), j.tolist()))
        off += len(tags)
    return sorted(out)


def _source(groups, ratio):
    """Which preparation the JAX package gives each group."""
    names = []
    for tags, cnt in groups:
        if len(tags) > 4096:
            names.append("pigeonhole")
        elif jcorrect._count_filtered_pairs(cnt, ratio) is None:
            names.append("triu")
        else:
            names.append("count_filtered")
    return names


def edit_hit_case(source, w, d, seed=0):
    """(groups, explicit pairs or None) of one test case of the sources
    triu (two dense groups), count_filtered (three sparse groups, one of
    mixed lengths) and explicit (a group of more than 4,096 tags, its
    pigeonhole candidates before the ratio filter as the pairs)."""
    rng = np.random.default_rng(1000 * w + 10 * d + seed)
    if source == "triu":
        return [_group(rng, 150, w, 8, d, dense=True),
                _group(rng, 90, w, 5, d, dense=True)], None
    if source == "count_filtered":
        return [_group(rng, 200, w, 10, d), _group(rng, 3, w, 1, d),
                _group(rng, 120, w, 6, d, mixed=True)], None
    groups = [_group(rng, 60, w, 4, d), _group(rng, 4200, w, 40, d)]
    tags, cnt = groups[1]
    cand = jdist.candidate_pairs_array(tags, d, counts=cnt, ratio=RATIO)
    return groups, torch.from_numpy((cand + 60).astype(np.int32))


@pytest.mark.parametrize("source", ["triu", "count_filtered", "explicit"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("w", [12, 16, 33, 64])
def test_edit_hits_match_jax_preparation_and_distances(w, d, source,
                                                        monkeypatch):
    groups, pairs = edit_hit_case(source, w, d)
    sources = _source(groups, RATIO)
    if source == "triu":
        assert set(sources) == {"triu"}
    else:
        assert {"count_filtered": "count_filtered",
                "explicit": "pigeonhole"}[source] in sources
    if d == 1:    # the JAX device kernel; host Myers for d = 2, 3
        monkeypatch.setenv("CLIQUE_TPU_EDIST_DEVICE_MIN_PAIRS", "0")
    want = _jax_hits(groups, d, RATIO)
    if pairs is not None:     # the explicit pairs cover the big group only
        want = [p for p in want if p[0] >= 60]
    h, j = tdist.edit_hits(*_matrix(groups), d, RATIO, pairs)
    assert list(zip(h.tolist(), j.tolist())) == want
    assert len(want) >= 10
    # a pair at exactly hi == ratio * lo, within the radius, is a hit
    cnt = torch.cat([torch.from_numpy(c) for _t, c in groups])
    if source != "triu":
        assert bool(((cnt[h] == 10) & (cnt[j] == 2)).any())


def test_edit_hits_ties_and_ratio_edges():
    """Equal counts never pair, hi == ratio * lo does, hi just below does
    not, whatever the distance."""
    tags = [b"AAAA", b"AAAC", b"AAAG", b"AAAT", b"CCCC", b"AACC"]
    cnt = np.array([10, 10, 2, 3, 5, 1], np.int64)
    mat, c, offs, widths = _matrix([(tags, cnt)])
    h, j = tdist.edit_hits(mat, c, offs, widths, 4, 5.0)
    got = set(zip(h.tolist(), j.tolist()))
    assert got == {(0, 2), (1, 2), (0, 5), (1, 5), (4, 5)}
    assert (2, 3) not in got and (0, 1) not in got and (0, 3) not in got
    h, j = tdist.edit_hits(mat, c, offs, widths, 1, 5.0)
    assert set(zip(h.tolist(), j.tolist())) == {(0, 2), (1, 2), (1, 5)}
    h, j = tdist.edit_hits(mat, c, offs, widths, 4, 2.5)
    assert (2, 3) not in set(zip(h.tolist(), j.tolist()))
    assert (4, 2) in set(zip(h.tolist(), j.tolist()))


def test_edit_hits_refuses_bad_inputs():
    mat, cnt, offs, widths = _matrix([([b"ACGT", b"ACGA"],
                                       np.array([5, 1], np.int64))])
    with pytest.raises(ValueError):
        tdist.edit_hits(mat, cnt, torch.tensor([0, 1], dtype=torch.int32),
                        widths, 1, 5.0)
    with pytest.raises(ValueError):
        tdist.edit_hits(mat, cnt, offs, torch.tensor([5], dtype=torch.int32),
                        1, 5.0)
    two = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):      # a pair across two groups
        tdist.edit_hits(mat, cnt, two, torch.tensor([4, 4], dtype=torch.int32),
                        1, 5.0, torch.tensor([[0, 1]], dtype=torch.int32))
    with pytest.raises(TypeError):
        tdist.edit_hits(mat, cnt.int(), offs, widths, 1, 5.0)
    wide = torch.zeros((2, 65), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tdist.edit_hits(wide, cnt, offs, torch.tensor([65], dtype=torch.int32),
                        1, 5.0)


def _myers_within(peq, text, w, d):
    """The kernel's within_radius on Python ints: the Myers/Hyyro column
    steps of distance.py::_edit_distance_myers_host with the early exit
    checked after every four columns."""
    if w == 0:
        return 0 <= d
    full = (1 << 64) - 1
    vp, vn, mbit, score = (1 << w) - 1, 0, 1 << (w - 1), w
    for k in range((w + 3) // 4):
        for col in range(4 * k, min(4 * k + 4, w)):
            pm = peq.get(text[col], 0)
            d0 = ((((pm & vp) + vp) & full) ^ vp) | pm | vn
            hp = vn | (~(d0 | vp) & full)
            hn = vp & d0
            score += bool(hp & mbit) - bool(hn & mbit)
            hp = ((hp << 1) | 1) & full
            hn = (hn << 1) & full
            vp = hn | (~(d0 | hp) & full)
            vn = hp & d0
        if score + min(4 * k + 4, w) > d + w:
            return False
    return score <= d


@pytest.mark.parametrize("source", ["triu", "count_filtered"])
@pytest.mark.parametrize("w,d", [(12, 2), (16, 1), (33, 3)])
def test_group_kernel_enumeration_emulated(w, d, source):
    """The group kernel's enumeration on the wrapper's own encoding
    (edit_hit_codes, the count sort, _edit_hit_blocks): every block of at
    most 8 patterns of one group, each pattern's partners swept 32 at a
    time from the start of its sorted group until 32 have no partner, each
    pair left once score + columns > d + w. Equals edit_hits_reference."""
    groups, _p = edit_hit_case(source, w, d, seed=1)
    tags, cnt, offs, widths = _matrix(groups)
    T, G = tags.shape[0], widths.shape[0]
    wmax = int(widths.max())
    codes, c, high, bstart, perm, K = tdist.edit_hit_groups(
        tags, cnt, offs, RATIO, wmax, 8)
    assert K == len(set(tags[:, :wmax].flatten().tolist()))
    gid = torch.repeat_interleave(torch.arange(G), (offs[1:] - offs[:-1]).long())
    # codes are the class codes of the sorted tags, counts ascend a group
    want_codes = tdist.edit_hit_codes(tags, wmax)[0][perm]
    assert torch.equal(codes, want_codes)
    assert torch.equal(gid[perm], gid) and torch.equal(c, cnt[perm])
    assert all(bool((c[s:e][1:] >= c[s:e][:-1]).all())
               for s, e in zip(offs.tolist(), offs.tolist()[1:]))
    code_rows = codes.view(torch.uint8).tolist()
    c = c.tolist()
    high, bstart, o = high.tolist(), bstart.tolist(), offs.tolist()
    got = []
    for b in range(len(bstart) - 1):
        block = high[bstart[b]:bstart[b + 1]]
        assert 1 <= len(block) <= 8
        assert len({int(gid[t]) for t in block}) == 1
        for h in block:
            g = int(gid[h])
            w_g = int(widths[g])
            peq = {}
            for i in range(w_g):
                peq[code_rows[h][i]] = peq.get(code_rows[h][i], 0) | 1 << i
            for r0 in range(o[g], o[g + 1], 32):
                lanes = range(r0, min(r0 + 32, o[g + 1]))
                passing = [j for j in lanes
                           if c[j] < c[h] and float(c[h]) >= RATIO * c[j]]
                if not passing:
                    break
                got += [(perm[h].item(), perm[j].item()) for j in passing
                        if _myers_within(peq, code_rows[j], w_g, d)]
    want_h, want_j = tdist.edit_hits_reference(tags, cnt, offs, widths, d,
                                               RATIO)
    assert sorted(got) == list(zip(want_h.tolist(), want_j.tolist()))
    assert len(got) >= 10 and T > 0


def _correction_groups(seed, L, d):
    """Many groups for correct_degenerate_groups: small ones of L-byte tags
    (some with gaps), one of more than 4,096 tags, one of mixed lengths
    (tags longer than L keep their length) and, with wide=True, one of
    80-byte tags."""
    rng = np.random.default_rng(seed)
    groups = []
    for k in range(25):
        tags, cnt = _group(rng, int(rng.integers(2, 160)), L,
                           int(rng.integers(1, 6)), d)
        if k % 5 == 0:
            tags = [t[:3] + b"-" + t[3:] for t in tags]
        groups.append(Counter(dict(zip(tags, cnt.tolist()))))
    tags, cnt = _group(rng, 4300, L, 50, d)
    groups.append(Counter(dict(zip(tags, cnt.tolist()))))
    tags, cnt = _group(rng, 200, L + 3, 8, d, mixed=True)
    groups.append(Counter(dict(zip(tags, cnt.tolist()))))
    groups += [Counter(), Counter({b"A" * L: 3})]
    return groups


def _wide_group(seed, d):
    tags, cnt = _group(np.random.default_rng(seed), 120, 80, 5, d)
    return Counter(dict(zip(tags, cnt.tolist())))


@pytest.mark.parametrize("L,d", [(16, 2), (12, 1), (16, 3)])
def test_correct_degenerate_groups_edit_hits_route_matches_jax(L, d,
                                                               monkeypatch):
    groups = _correction_groups(L * d, L, d) + [_wide_group(L + d, d)]
    assert any(len(g) > 4096 for g in groups)
    assert any(len({len(t) for t in g}) > 1 for g in groups)
    want = jcorrect.correct_degenerate_groups(groups, d, L, RATIO)
    monkeypatch.setattr(tcorrect, "EDIT_HITS_MIN_PAIRS", 0)
    n = tdist.edit_distance_launches, tdist.edit_hits_launches
    got = tcorrect.correct_degenerate_groups(groups, d, L, RATIO,
                                             device="cpu")
    assert got == want
    assert (tdist.edit_distance_launches, tdist.edit_hits_launches) == n
    assert sum(1 for m in got for k, v in m.items() if k != v) >= 50


@pytest.mark.parametrize("L,d", [(16, 2), (12, 3)])
def test_edit_hits_route_builds_no_pair_array(L, d, monkeypatch):
    """Groups of at most 64 bytes on the edit-hits route: neither the triu
    nor the count-filtered pair arrays nor any row of a pair is built on
    the host (only a group past 4,096 tags takes its pigeonhole
    candidates)."""
    groups = _correction_groups(7 * L + d, L, d)
    want = jcorrect.correct_degenerate_groups(groups, d, L, RATIO)

    def refuse(*_a, **_k):
        raise AssertionError("the host route ran")

    for name in ("_triu_pairs", "_count_filtered_pairs",
                 "edit_distance_rows"):
        monkeypatch.setattr(tcorrect, name, refuse)
    monkeypatch.setattr(tdist, "edit_distance_rows", refuse)
    monkeypatch.setattr(tdist, "_edit_distance_myers_host", refuse)
    monkeypatch.setattr(tcorrect, "EDIT_HITS_MIN_PAIRS", 0)
    assert tcorrect.correct_degenerate_groups(groups, d, L, RATIO,
                                              device="cpu") == want


def test_threshold_picks_the_route(monkeypatch):
    """Below EDIT_HITS_MIN_PAIRS candidate pairs the host route runs and
    edit_hits does not; from it, edit_hits runs and the host route does
    not. Both maps equal the JAX package's."""
    groups = _correction_groups(3, 16, 2)[:25]
    want = jcorrect.correct_degenerate_groups(groups, 2, 16, RATIO)
    normalized = []
    for g in groups:
        nc = Counter()
        for t, c in g.items():
            nc[tcorrect.normalize_tag(t, 16)] += c
        if len(nc) > 1:
            normalized.append(nc)
    n_pairs = tcorrect._prefiltered_pairs(normalized, RATIO)
    calls = []
    real = tcorrect.edit_hits
    monkeypatch.setattr(tcorrect, "edit_hits",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tcorrect, "EDIT_HITS_MIN_PAIRS", n_pairs + 1)
    assert tcorrect.correct_degenerate_groups(groups, 2, 16, RATIO,
                                              device="cpu") == want
    assert not calls
    monkeypatch.setattr(tcorrect, "EDIT_HITS_MIN_PAIRS", n_pairs)
    assert tcorrect.correct_degenerate_groups(groups, 2, 16, RATIO,
                                              device="cpu") == want
    assert calls == [1]


def test_prefiltered_pairs_counts_the_host_route_pairs():
    rng = np.random.default_rng(8)
    groups = [Counter(dict(zip(*_group(rng, n, 12, k, 2))))
              for n, k in ((50, 2), (3, 1), (400, 40), (9, 9))]
    groups[3] = Counter({t: 7 for t in groups[3]})       # every count equal
    want = 0
    for g in groups:
        cnt = np.array(list(g.values()), np.int64)
        p = jcorrect._count_filtered_pairs(cnt, RATIO)
        want += len(p) if p is not None else len(cnt) * (len(cnt) - 1) // 2
    assert tcorrect._prefiltered_pairs(groups, RATIO) == want
    assert tcorrect._prefiltered_pairs([], RATIO) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degenerate_finish_ignores_pair_order_and_duplicates(seed):
    """The hits come back in no order, h the higher count; absorption must
    give the same map whatever the order, orientation or repetition of the
    close pairs."""
    rng = np.random.default_rng(seed)
    tags, cnt = _group(rng, 300, 12, 12, 2)
    nc = Counter(dict(zip(tags, cnt.tolist())))
    mat, pairs = jcorrect._prepare_pairs(nc, tags, 2, RATIO)
    w = np.full(len(pairs), 12, np.int32)
    dist = jdist.edit_distance_rows(mat[pairs[:, 0]], mat[pairs[:, 1]], w, w)
    want = jcorrect.degenerate_finish(nc, tags, pairs, dist, 2, RATIO)
    close = pairs[dist <= 2]
    assert len(close) >= 20
    shuffled = close[rng.permutation(len(close))]
    flipped = np.where(rng.random((len(close), 1)) < 0.5, close,
                       close[:, ::-1])
    doubled = np.concatenate([shuffled, flipped, close[::3]])
    for p in (close, shuffled, flipped, doubled):
        got = tcorrect.degenerate_finish(nc, tags, p, np.zeros(len(p),
                                                               np.uint8),
                                         2, RATIO)
        assert got == want
    assert sum(1 for k, v in want.items() if k != v) >= 10
