"""The plain references agree with the program's own plain versions at
small sizes on the CPU (the port's CPU path is the JAX package's
semantics, held to it by the repository's tests)."""

import random

import numpy as np
import pytest

from reference import affine_dp, pair_hmm


def _seq(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _mutate(rng, s):
    out = bytearray()
    for b in s:
        if rng.random() < 0.05:
            continue
        out.append(b if rng.random() > 0.1 else rng.choice(b"ACGT"))
        if rng.random() < 0.05:
            out.append(rng.choice(b"ACGT"))
    return bytes(out)


@pytest.mark.parametrize("mode,scoring", [("both", "aligner_default"),
                                          ("ref_n_only", "rust_bio_compat")])
def test_affine_dp_matches_the_program(mode, scoring):
    from clique_tpu_torch.align.pipeline import RUST_BIO_COMPAT, BatchAligner
    from clique_tpu_torch.align.scoring import AffineScoring

    rng = random.Random(5)
    refs, reads = [], []
    for i in range(60):
        ref = _seq(rng, rng.randint(20, 50))
        if i % 3 == 0:
            ref = ref[:5] + b"0000N" + ref[5:]
        refs.append(ref)
        reads.append(_mutate(rng, ref.replace(b"0", b"A")) if i % 2
                     else _seq(rng, rng.randint(10, 60)))
    sc = AffineScoring.aligner_default() if mode == "both" \
        else RUST_BIO_COMPAT
    got = BatchAligner(sc, 32, special_mode=mode, device="cpu"
                       ).align_pairs(refs, reads)
    mine = affine_dp.align(refs, reads, scoring, mode, "cpu", block=32)
    for (a1, a2, cig, score), m in zip(got, mine):
        assert (a1, a2, "".join(f"{c}{o}" for c, o in cig), float(score)) \
            == (m.ref_aligned, m.read_aligned, m.cigar, m.score)


def test_pair_hmm_matches_the_program():
    from clique_tpu_torch.align import hmm

    rng = random.Random(7)
    refs = [_seq(rng, rng.randint(30, 70)) for _ in range(30)]
    reads = [_mutate(rng, r) if i % 3 else _seq(rng, rng.randint(20, 80))
             for i, r in enumerate(refs)]
    refs[0] = refs[0][:4] + b"N0" + refs[0][6:]
    reads[1] = b"NN" + reads[1]
    mine = pair_hmm.forward(refs, reads, "cpu")
    _ri, _fi, ll = hmm.HmmRouter(refs, device="cpu").pair_lls(
        reads, [[i] for i in range(len(reads))])
    assert np.abs(ll - mine).max() < 1e-3


def test_levenshtein():
    import torch

    from reference.lineage_chain import levenshtein

    a = [b"ACGTACGT", b"ACGTACGT", b"AAAA----", b"ACGT----"]
    b = [b"ACGTACGT", b"CGTACGTA", b"AAAAC---", b"TGCA----"]
    w = [8, 8, 5, 4]
    ta = torch.tensor([list(x) for x in a], dtype=torch.uint8)
    tb = torch.tensor([list(x) for x in b], dtype=torch.uint8)
    d = levenshtein(ta, tb, torch.tensor(w)).tolist()
    assert d == [0, 2, 1, 4]
