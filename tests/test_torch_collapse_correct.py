"""The port's tag correction (clique_tpu_torch.collapse.correct) against the
JAX package's (clique_tpu.collapse.correct, jax on the CPU), on seeded
inputs. Every result is a byte-string map, so every comparison is exact.
"""

from collections import Counter

import numpy as np
import pytest

import clique_tpu.collapse.correct as jcorrect
from clique_tpu_torch.collapse import correct as tcorrect
from clique_tpu_torch.collapse import distance as tdist

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _observed(rng, allow, n_reads, L, err=0.3, gaps=True):
    """Counts of tags read off allowlist entries with substitutions, and
    now and then a lost base ('-' or a shorter tag)."""
    counts = Counter()
    for _ in range(n_reads):
        t = bytearray(allow[rng.integers(len(allow))])
        while rng.random() < err:
            t[rng.integers(L)] = int(rng.choice(BASES))
        if gaps and rng.random() < 0.1:
            p = int(rng.integers(L))
            t = t[:p] + (b"-" if rng.random() < 0.5 else b"") + t[p + 1:]
        counts[bytes(t)] += 1
    return counts


@pytest.mark.parametrize("d", [0, 1, 2])
def test_correct_known_hamming_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    allow = [rng.choice(BASES, 16).tobytes() for _ in range(300)]
    allow[5] = allow[4][:-1] + bytes([allow[4][-1] ^ 0x02])   # ambiguous
    counts = _observed(rng, allow, 2000, 16)
    want = jcorrect.correct_known_hamming(counts, allow, d, 16)
    got = tcorrect.correct_known_hamming(counts, allow, d, 16, device="cpu")
    assert got == want
    assert got


@pytest.mark.parametrize("d", [1, 2])
def test_correct_known_levenshtein_matches_jax(d):
    rng = np.random.default_rng(20 + d)
    allow = [rng.choice(BASES, 16).tobytes() for _ in range(300)]
    counts = _observed(rng, allow, 1500, 16)
    want = jcorrect.correct_known_levenshtein(counts, allow, d, 16)
    got = tcorrect.correct_known_levenshtein(counts, allow, d, 16,
                                             device="cpu")
    assert got == want
    assert got


def _degenerate_groups(rng, n_groups, L):
    groups = []
    for g in range(n_groups):
        centers = [rng.choice(BASES, L).tobytes()
                   for _ in range(int(rng.integers(1, 5)))]
        groups.append(_observed(rng, centers, int(rng.integers(1, 120)), L,
                                err=0.2, gaps=g % 3 == 0))
    groups.append(Counter())                   # empty bin
    groups.append(Counter({b"A" * L: 4}))      # single tag
    return groups


@pytest.mark.parametrize("L,d", [(12, 2), (16, 1), (10, 3)])
def test_correct_degenerate_groups_matches_jax(L, d):
    rng = np.random.default_rng(L * d)
    groups = _degenerate_groups(rng, 40, L)
    want = jcorrect.correct_degenerate_groups(groups, d, L, 5.0)
    got = tcorrect.correct_degenerate_groups(groups, d, L, 5.0, device="cpu")
    assert got == want


def test_correct_degenerate_groups_large_group_matches_jax():
    """A group of more than 4096 distinct tags takes the pigeonhole
    candidate path (_prepare_pairs -> candidate_pairs_array)."""
    rng = np.random.default_rng(5)
    centers = [rng.choice(BASES, 12).tobytes() for _ in range(400)]
    counts = _observed(rng, centers, 30000, 12, err=0.6, gaps=False)
    assert len(counts) > 4096
    want = jcorrect.correct_degenerate_groups([counts], 2, 12, 5.0)
    got = tcorrect.correct_degenerate_groups([counts], 2, 12, 5.0,
                                             device="cpu")
    assert got == want


def test_correct_degenerate_across_the_device_threshold(monkeypatch):
    """One group whose ratio-filtered pairs reach DEVICE_MIN_PAIRS (and
    EDIT_HITS_MIN_PAIRS): the port sends them to the device route (the
    edit-hits wrapper, here its plain version), never to the host Myers
    code, and the map equals the JAX package's computed with host Myers
    distances on the same rows."""
    rng = np.random.default_rng(2)
    hi = {rng.choice(BASES, 16).tobytes() for _ in range(1000)}
    lo = set()
    while len(lo) < 2100:
        t = rng.choice(BASES, 16).tobytes()
        if t not in hi:
            lo.add(t)
    # a few count-1 tags one substitution from a count-10 tag
    for t in sorted(hi)[:50]:
        near = t[:-1] + (b"A" if t[-1:] != b"A" else b"C")
        if near not in hi:
            lo.discard(sorted(lo)[0])
            lo.add(near)
    counts = Counter({t: 10 for t in hi})
    counts.update({t: 1 for t in lo})
    assert len(hi) * len(lo) >= tdist.DEVICE_MIN_PAIRS

    def no_myers(*_a, **_k):
        raise AssertionError("the host Myers path ran")

    monkeypatch.setattr(tdist, "_edit_distance_myers_host", no_myers)
    got = tcorrect.correct_degenerate_groups([counts], 2, 16, 5.0,
                                             device="cpu")
    monkeypatch.setenv("CLIQUE_TPU_EDIST_DEVICE_MIN_PAIRS", str(1 << 40))
    want = jcorrect.correct_degenerate_groups([counts], 2, 16, 5.0)
    assert got == want
    assert sum(1 for k, v in got[0].items() if k != v) >= 25


def test_degenerate_prepare_and_helpers_match_jax():
    rng = np.random.default_rng(9)
    counts = _observed(rng, [rng.choice(BASES, 12).tobytes()
                             for _ in range(6)], 300, 12, err=0.3)
    got = tcorrect.degenerate_prepare(counts, 2, 12, 5.0)
    want = jcorrect.degenerate_prepare(counts, 2, 12, 5.0)
    assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert tcorrect.degenerate_prepare({}, 2, 12) == \
        jcorrect.degenerate_prepare({}, 2, 12)
    assert tcorrect.degenerate_prepare({b"ACG": 3}, 2, 4)[4] == \
        jcorrect.degenerate_prepare({b"ACG": 3}, 2, 4)[4]
    for tag in (b"AC-GT", b"ACGTAC", b"", b"--"):
        assert tcorrect.normalize_tag(tag, 5) == \
            jcorrect.normalize_tag(tag, 5)
    seqs = [b"ACNT", b"AC-T", b"AGNT", b"TC-A"]
    assert tcorrect.tag_consensus(seqs) == jcorrect.tag_consensus(seqs)
