"""Vectorized consensus for insertion-free groups.

When no member of a UMI group carries an insertion against the reference
(the overwhelmingly common case: every gapped reference_aligned equals the
reference), the stretcher column model reduces to fixed columns and the
whole group collapses in a handful of numpy array ops: per-column allele
counts, the log2-space Bayesian posterior of consensus/quality.py summed
vectorized, gap calls, and run-length CIGAR.

Semantics match consensus/stretcher.py exactly for base calls and CIGAR;
consensus PHRED values may differ by the floating-point summation order in
degenerate ties (documented; the slow path remains the reference
implementation and handles insertion-bearing groups).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from clique_tpu_torch.align.cpu import AlignmentResult, simplify_cigar

GAP = ord("-")

_ALLELE_INDEX = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGTN"):
    _ALLELE_INDEX[ord(_b)] = _i
    _ALLELE_INDEX[ord(_b.lower())] = _i

# byte -> count slot: A..N -> 0..4, gap -> 5, anything else -> 6 (ignored)
_SLOT7_LUT = np.full(256, 6, dtype=np.uint8)
_SLOT7_LUT[_ALLELE_INDEX >= 0] = _ALLELE_INDEX[_ALLELE_INDEX >= 0]
_SLOT7_LUT[GAP] = 5

# byte-indexed lookups for the per-base quality terms: quality bytes have
# only 256 possible values, so the 10**, log2 transcendentals collapse to
# table gathers (bit-identical - same expressions, evaluated once)
with np.errstate(divide="ignore"):
    _PERR_LUT = np.power(10.0, np.arange(256.0) / -10.0)
    _LHIT_LUT = np.log2(1.0 - _PERR_LUT)
    _LMISS_LUT = np.log2(_PERR_LUT / 3.0)


def group_is_insertion_free(reference: bytes,
                            members_ref_aligned: List[bytes]) -> bool:
    return all(ra == reference for ra in members_ref_aligned)


def consensus_fast_groups(reference: bytes,
                          groups: List[Tuple[List[bytes], List[Optional[bytes]],
                                             List[str]]],
                          reference_name: str,
                          gap_call_threshold: float = 0.75,
                          reference_prob: float = 0.75
                          ) -> List[AlignmentResult]:
    """Collapse MANY insertion-free groups at once: all members of all
    groups stack into one [N, L] matrix; per-group-column counts and the
    Bayesian posterior come from flat bincounts (the segment-sum consensus
    kernel of SURVEY 7), then bases/CIGARs are emitted per group."""
    if not groups:
        return []
    L = len(reference)
    G = len(groups)
    members = []
    all_quals = []
    sizes = []
    for reads, qlist, _names in groups:
        members.extend(reads)
        all_quals.extend(qlist)
        sizes.append(len(reads))
    N = len(members)
    reads_mat = np.frombuffer(b"".join(members), dtype=np.uint8
                              ).reshape(N, L)
    gid = np.repeat(np.arange(G, dtype=np.int32),
                    np.asarray(sizes, dtype=np.int64))

    # one 256-entry LUT gather classifies every byte into a count slot
    # (A..N -> 0..4, gap -> 5, everything else -> 6 = ignored); the
    # 7-slot bincount then yields all per-group-column counts in one pass
    cols32 = np.arange(L, dtype=np.int32)
    slot7 = _SLOT7_LUT[reads_mat].astype(np.int32)        # [N, L]
    flat_idx = (gid[:, None] * np.int32(L) + cols32) * np.int32(7) + slot7
    counts = np.bincount(flat_idx.ravel(), minlength=G * L * 7
                         ).reshape(G, L, 7).transpose(0, 2, 1)[:, :6, :]
    counts = np.ascontiguousarray(counts)                 # [G, 6, L]
    total = counts.sum(axis=1)                            # [G, L]

    # uniform-quality fast path: every chain BAM carries a single flat
    # qual byte ('H', to_sam_record hardcode alignment_matrix.rs:764-767),
    # making the per-cell quality terms constants - the weighted
    # bincounts and the qual scatter collapse to count-scaled constants
    # (bit-identical: the same l_hit/l_miss value per cell either way)
    uniform_q = None
    if all(q is not None for q in all_quals):
        qcat = np.frombuffer(b"".join(all_quals), dtype=np.uint8)
        if len(qcat) and int(qcat.min()) == int(qcat.max()):
            uniform_q = int(qcat[0])
            # every row's qual must cover exactly its non-gap cells, or
            # the scatter path would leave 'h' holes the constant can't
            qlens = np.fromiter((len(q) for q in all_quals), np.int64,
                                count=N)
            if not (qlens == (reads_mat != GAP).sum(axis=1)).all():
                uniform_q = None
    ref = np.frombuffer(reference, dtype=np.uint8)
    ref_allele = _ALLELE_INDEX[ref].astype(np.int64)      # [L] -1..4

    index_of_max = None
    if uniform_q is not None:
        # valid cells all carry uniform_q, so a column's posterior (and
        # hence its consensus phred + argmax allele) is a pure function of
        # its 5 allele counts and the reference allele. Those keys repeat
        # massively across the G*L columns; evaluate the f64 exp2/log10
        # block once per UNIQUE key and scatter back (bit-identical: the
        # same expressions on the same values, elementwise)
        lh, lm = float(_LHIT_LUT[uniform_q]), float(_LMISS_LUT[uniform_q])
        c5 = counts[:, :5, :]                             # [G, 5, L]
        m = int(c5.max()) + 1
        if m ** 5 * 6 < 2 ** 62:
            key = ((((c5[:, 0] * m + c5[:, 1]) * m + c5[:, 2]) * m
                    + c5[:, 3]) * m + c5[:, 4]) * 6 \
                + (ref_allele[None, :] + 1)               # [G, L]
            uk, inv = np.unique(key, return_inverse=True)
            U = len(uk)
            t = uk // 6
            ra_u = uk % 6 - 1                             # [U] -1..4
            cu = np.empty((U, 5), dtype=np.int64)
            for a in range(4, -1, -1):
                cu[:, a] = t % m
                t = t // m
            prior_u = np.full((U, 5), np.log2((1.0 - reference_prob) / 4.0))
            ku = ra_u >= 0
            prior_u[np.nonzero(ku)[0], ra_u[ku]] = np.log2(reference_prob)
            props_u = prior_u + (lm * cu.sum(axis=1))[:, None] \
                + (lh - lm) * cu
            powed_u = np.power(2.0, props_u)
            posterior_u = powed_u / powed_u.sum(axis=1, keepdims=True)
            idx_u = 3 - np.argmax(cu[:, :4][:, ::-1], axis=1)
            chosen_u = posterior_u[np.arange(U), idx_u]
            phred_u = np.where(
                np.isnan(chosen_u), 0,
                np.where(chosen_u < 1e-8, 0,
                         np.minimum(40, np.round(
                             -10.0 * np.log10(1.00000000001 - chosen_u))))
            ).astype(np.int64)
            inv = inv.reshape(G, L)
            index_of_max = idx_u[inv]
            phred = phred_u[inv]
        else:
            valid_count = c5.sum(axis=1)                  # [G, L]
            miss_sum = lm * valid_count
            hit_sum = (lh - lm) * c5
    else:
        allele = _ALLELE_INDEX[reads_mat]                 # [N, L] i8
        valid = allele >= 0
        nongap = reads_mat != GAP
        quals = np.full((N, L), ord("h"), dtype=np.uint8)
        # vectorized scatter for rows whose qual length equals the row's
        # non-gap count (the common case); per-row fallback otherwise
        ng_counts = nongap.sum(axis=1)
        qlens = np.fromiter((len(q) if q is not None else -1
                             for q in all_quals), np.int64, count=N)
        vec_rows = qlens == ng_counts
        if vec_rows.any():
            sub = nongap[vec_rows]
            rr, cc = np.nonzero(sub)        # row-major: matches concat order
            qcat2 = np.frombuffer(
                b"".join(all_quals[i] for i in np.flatnonzero(vec_rows)),
                dtype=np.uint8)
            rows_map = np.flatnonzero(vec_rows)
            quals[rows_map[rr], cc] = qcat2
        for i in np.flatnonzero(~vec_rows & (qlens >= 0)):
            idx = np.nonzero(nongap[i])[0]
            qa = np.frombuffer(all_quals[i], dtype=np.uint8)
            take = min(len(idx), len(qa))
            quals[i, idx[:take]] = qa[:take]

        # posterior log2 sums via weighted bincounts over valid cells only
        l_hit = _LHIT_LUT[quals]
        l_miss = _LMISS_LUT[quals]

        base_gl = gid[:, None] * np.int32(L) + cols32     # [N, L] i32
        miss_sum = np.bincount(base_gl[valid], weights=l_miss[valid],
                               minlength=G * L).reshape(G, L)
        hit_idx = (gid[:, None] * np.int32(5)
                   + np.clip(allele, 0, 4).astype(np.int32)) * np.int32(L) \
            + cols32
        hit_sum = np.bincount(hit_idx[valid],
                              weights=(l_hit - l_miss)[valid],
                              minlength=G * 5 * L).reshape(G, 5, L)

    if index_of_max is None:
        prior = np.full((5, L), np.log2((1.0 - reference_prob) / 4.0))
        known = ref_allele >= 0
        prior[ref_allele[known], np.nonzero(known)[0]] = \
            np.log2(reference_prob)

        props = prior[None, :, :] + miss_sum[:, None, :] + hit_sum
        powed = np.power(2.0, props)
        posterior = powed / powed.sum(axis=1, keepdims=True)  # [G, 5, L]

        acgt = counts[:, :4, :]
        index_of_max = 3 - np.argmax(acgt[:, ::-1, :], axis=1)  # [G, L]
        chosen = np.take_along_axis(posterior, index_of_max[:, None, :],
                                    axis=1)[:, 0, :]
        phred = np.where(
            np.isnan(chosen), 0,
            np.where(chosen < 1e-8, 0,
                     np.minimum(40, np.round(
                         -10.0 * np.log10(1.00000000001 - chosen))))
        ).astype(np.int64)

    call_gap = (total == 0) | \
        (np.divide(counts[:, 5, :], np.maximum(total, 1))
         >= gap_call_threshold)
    bases_all = np.where(
        call_gap, GAP,
        np.frombuffer(b"ACGT", dtype=np.uint8)[index_of_max]
    ).astype(np.uint8)

    # batched alignment rate of each consensus against the reference
    # (alignment_rate_fast semantics, one [G, L] pass): saves the
    # per-record numpy round trip in _consensus_record's rm tag
    from clique_tpu_torch.extract.extractor import alignment_rates_rows

    rates = alignment_rates_rows(ref[None, :], bases_all)

    results = []
    for gi, (reads, _qlist, names) in enumerate(groups):
        bases = bases_all[gi]
        cg = call_gap[gi]
        qual_out = (phred[gi][~cg] + 33).astype(np.uint8).tobytes()
        ops = cg.astype(np.uint8)
        change = np.nonzero(np.diff(ops))[0]
        starts = np.concatenate(([0], change + 1))
        ends = np.concatenate((change + 1, [L]))
        cigar = simplify_cigar(
            [(int(e - s), "MD"[ops[s]]) for s, e in zip(starts, ends)])
        res = AlignmentResult(
            reference_name=reference_name,
            read_name=names[0] if names else "UnnamedRead",
            reference_aligned=reference,
            read_aligned=bases.tobytes(),
            read_quals=qual_out,
            cigar=cigar,
            path=[],
            score=0.0,
        )
        res.alignment_rate = float(rates[gi])
        results.append(res)
    return results


def consensus_fast(reference: bytes, read_aligned: List[bytes],
                   read_quals: List[Optional[bytes]], read_names: List[str],
                   reference_name: str,
                   gap_call_threshold: float = 0.75,
                   reference_prob: float = 0.75) -> AlignmentResult:
    """Collapse an insertion-free group. read_aligned rows all have
    len == len(reference)."""
    G = len(read_aligned)
    L = len(reference)
    reads = np.frombuffer(b"".join(read_aligned), dtype=np.uint8
                          ).reshape(G, L)
    ref = np.frombuffer(reference, dtype=np.uint8)

    # per-member per-column quality bytes: the stretcher walks the member's
    # raw qual string, advancing only on non-gap read bases and substituting
    # '+' for gaps (stretcher.rs:283-290); gap columns carry no quality.
    quals = np.full((G, L), ord("h"), dtype=np.int32)
    nongap = reads != GAP
    for g in range(G):
        q = read_quals[g]
        if q is None:
            continue  # stretcher substitutes 'h' for missing quals
        idx = np.nonzero(nongap[g])[0]
        qa = np.frombuffer(q, dtype=np.uint8)
        take = min(len(idx), len(qa))
        quals[g, idx[:take]] = qa[:take]

    allele = _ALLELE_INDEX[reads]                       # [G, L] -1..4
    valid = allele >= 0
    gap_mask = reads == GAP

    # Bayesian posterior per column (quality.py combine_qual_scores):
    l_hit = _LHIT_LUT[quals]                            # [G, L]
    l_miss = _LMISS_LUT[quals]
    delta = l_hit - l_miss

    ref_allele = _ALLELE_INDEX[ref]                     # [L]
    prior = np.full((5, L), np.log2((1.0 - reference_prob) / 4.0))
    known = ref_allele >= 0
    prior[ref_allele[known], np.nonzero(known)[0]] = np.log2(reference_prob)

    counts = np.zeros((6, L), dtype=np.int64)           # A C G T N gap
    props = prior.copy()
    props += np.where(valid, l_miss, 0.0).sum(axis=0)[None, :]
    for a in range(5):
        hit = (allele == a)                             # implies valid
        counts[a] = hit.sum(axis=0)
        props[a] += np.where(hit, delta, 0.0).sum(axis=0)
    counts[5] = gap_mask.sum(axis=0)
    total = counts.sum(axis=0)

    powed = np.power(2.0, props)
    tot = powed.sum(axis=0)
    posterior = powed / tot                              # [5, L]

    # argmax over ACGT, later alleles win ties (Rust max_by keeps last)
    acgt = counts[:4]
    index_of_max = 3 - np.argmax(acgt[::-1], axis=0)
    chosen_prob = posterior[index_of_max, np.arange(L)]

    # prob_to_phred (quality.py): NaN->0, tiny->0, cap 40, +33 ascii
    phred = np.where(
        np.isnan(chosen_prob), 0,
        np.where(chosen_prob < 1e-8, 0,
                 np.minimum(40, np.round(
                     -10.0 * np.log10(1.00000000001 - chosen_prob))))
    ).astype(np.int64)

    call_gap = (total == 0) | \
        (np.divide(counts[5], np.maximum(total, 1)) >= gap_call_threshold)
    bases = np.where(call_gap, GAP,
                     np.frombuffer(b"ACGT", dtype=np.uint8)[index_of_max]
                     ).astype(np.uint8)
    qual_out = (phred[~call_gap] + 33).astype(np.uint8).tobytes()

    # run-length CIGAR: D for gap columns, M otherwise
    ops = np.where(call_gap, 1, 0).astype(np.uint8)
    change = np.nonzero(np.diff(ops))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [L]))
    cigar = simplify_cigar(
        [(int(e - s), "MD"[ops[s]]) for s, e in zip(starts, ends)])

    return AlignmentResult(
        reference_name=reference_name,
        read_name=read_names[0] if read_names else "UnnamedRead",
        reference_aligned=reference,
        read_aligned=bases.tobytes(),
        read_quals=qual_out,
        cigar=cigar,
        path=[],
        score=0.0,
    )
