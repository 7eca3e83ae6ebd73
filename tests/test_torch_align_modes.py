"""The port's banded, keep-last, `special_mode="none"` and local
(Waterman-Eggert) DP modes (clique_tpu_torch.align.batch, plain PyTorch on
the CPU) against the JAX package's align_batch_device, the host golden
model and the JAX inversion screen.

Every DP decision is exact on any backend (dyadic f32 sums,
clique_tpu/align/batch.py:18-21), so the tolerance is exact equality of
every traceback byte, score, plane, op and coordinate.
"""

import dataclasses

import numpy as np
import pytest
import torch

from clique_tpu.align import batch as jbatch
from clique_tpu.align.cpu import affine_align
from clique_tpu.align.merge import MERGE_SCORING
from clique_tpu.align.pipeline import RUST_BIO_COMPAT
from clique_tpu.align.scoring import AffineScoring, InversionScoring
from clique_tpu_torch.align import batch as tbatch
from clique_tpu_torch.align import dp_kernels
from clique_tpu_torch.align import scoring as tscoring
from clique_tpu_torch.align.pipeline import \
    RUST_BIO_COMPAT as PORT_RUST_BIO_COMPAT

B, N1, N2 = 8, 64, 72
SCORINGS = {
    "aligner_default": AffineScoring.aligner_default(),
    "default_dna": AffineScoring.default_dna(),
    "merge": MERGE_SCORING,
    "rust_bio_compat": RUST_BIO_COMPAT,
}
ALPHABET = np.frombuffer(b"ACGTACGTACGTN0129", dtype=np.uint8)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
INV = InversionScoring(10.0, -11.0, -15.0, -5.0, -2.0, 8)
PORT_INV = tscoring.InversionScoring(10.0, -11.0, -15.0, -5.0, -2.0, 8)


def _port_scoring(sc):
    """The port's AffineScoring with the values of the JAX one `sc`: each
    side calls its own package with its own objects."""
    return tscoring.AffineScoring(
        sc.match_score, sc.mismatch_score, sc.special_character_score,
        sc.gap_open, sc.gap_extend, sc.final_gap_multiplier)


def _inputs(seed, uniform=False, alphabet=ALPHABET):
    """Ragged rows: length 1 and n - 1 on both sides, a zero-length read
    and a zero-length reference, and a read that copies its reference."""
    rng = np.random.default_rng(seed)
    rows = 1 if uniform else B
    refs = np.zeros((rows, N1 - 1), np.uint8)
    reads = np.zeros((B, N2 - 1), np.uint8)
    ref_lens = rng.integers(1, N1, B).astype(np.int32)
    read_lens = rng.integers(1, N2, B).astype(np.int32)
    ref_lens[0], read_lens[0] = 1, N2 - 1
    ref_lens[1], read_lens[1] = N1 - 1, 1
    ref_lens[2], read_lens[2] = N1 - 1, 0
    ref_lens[3], read_lens[3] = 0, 17
    if uniform:
        ref_lens[:] = ref_lens[4]
    for i in range(rows):
        refs[i, :ref_lens[i]] = rng.choice(alphabet, ref_lens[i])
    for i in range(B):
        reads[i, :read_lens[i]] = rng.choice(alphabet, read_lens[i])
    if not uniform:
        n = min(ref_lens[5], N2 - 1)
        reads[5, :n] = refs[5, :n]
        reads[5, n // 3] = ord("T")
        read_lens[5] = n
    return refs, reads, ref_lens, read_lens


def _band(ref_lens, read_lens, width):
    bw = np.minimum(np.maximum(ref_lens, np.maximum(read_lens, 1)),
                    np.int32(width)).astype(np.int32)
    return bw, jbatch.band_centers_f64(ref_lens, read_lens, N1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same_fields(got, want, fields):
    for field in fields:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


GLOBAL_FIELDS = ("score", "start_z", "ops", "n_ops", "ops_packed")
LOCAL_FIELDS = GLOBAL_FIELDS + ("ref_start", "read_start", "ref_end",
                                "read_end")

GLOBAL_MODES = {
    "banded_ref_n_only": dict(special_mode="ref_n_only", width=12),
    "banded_both": dict(special_mode="both", width=5),
    "none_last": dict(special_mode="none", tie_order="last"),
    "none_ref": dict(special_mode="none"),
    "both_last": dict(special_mode="both", tie_order="last"),
    "banded_none_last": dict(special_mode="none", tie_order="last",
                             width=9),
}


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
@pytest.mark.parametrize("scoring", ["aligner_default", "default_dna"])
@pytest.mark.parametrize("mode", list(GLOBAL_MODES))
def test_global_modes_match_align_batch_device(mode, scoring, uniform):
    """Banded, keep-last and "none" fills + the walk equal the XLA scan:
    traceback, corner-derived score and plane, ops and the fused row."""
    kw = dict(GLOBAL_MODES[mode])
    width = kw.pop("width", None)
    seed = 300 + 7 * list(GLOBAL_MODES).index(mode) + int(uniform)
    refs, reads, ref_lens, read_lens = _inputs(seed, uniform)
    jparams = jbatch.scoring_to_params(SCORINGS[scoring])
    if width is None:
        bw = np.maximum(ref_lens, np.maximum(read_lens, 1))
        centers = None
    else:
        bw, centers = _band(ref_lens, read_lens, width)
    jres, jtb = jbatch.align_batch_device(
        refs, reads, ref_lens, read_lens, bw, jparams, n1=N1, n2=N2,
        band_centers=centers, **kw)
    jfused = np.asarray(jbatch.fuse_result(jres.ops_packed, jres.n_ops,
                                           jres.score))

    params = tbatch.params_from_jax(np.asarray(jparams), "cpu")
    t = _t(refs, reads, ref_lens, read_lens)
    band = {} if width is None else dict(
        zip(("bandwidth", "band_centers"), _t(bw, centers)))
    tb, corner = tbatch.fill_reference(*t, params, n1=N1, n2=N2, **kw,
                                       **band)
    res, fused = tbatch.walk_reference(tb, corner, t[2], t[3], n1=N1, n2=N2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    _same_fields(res, jres, GLOBAL_FIELDS)
    np.testing.assert_array_equal(fused.numpy(), jfused)

    # the wrapper takes the plain versions for CPU tensors, counting
    # nothing; its traceback comes in the kernel's strip layout
    before = (dp_kernels.align_launches, dict(dp_kernels.fill_mode_launches))
    fused_w, tb_w = tbatch.align_batch(*t, params, n1=N1, n2=N2,
                                       return_traceback=True, **kw, **band)
    assert torch.equal(fused_w, fused)
    assert torch.equal(tbatch.wavefront_to_tb(tb_w, t[2], t[3], n1=N1, n2=N2),
                       tb)
    assert (dp_kernels.align_launches,
            dp_kernels.fill_mode_launches) == before


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
def test_local_matches_align_batch_device(uniform, special_mode, scoring):
    """The Waterman-Eggert fill + walk equal align_batch_device(local=True)
    in every LocalBatchAlignment field, and the traceback bytes; a uniform
    batch sends one reference row, as the inversion screen does."""
    seed = 400 + 11 * (2 * int(uniform) + (special_mode == "both")) \
        + list(SCORINGS).index(scoring)
    refs, reads, ref_lens, read_lens = _inputs(seed, uniform, alphabet=BASES)
    jparams = jbatch.scoring_to_params(SCORINGS[scoring])
    bw = np.maximum(ref_lens, np.maximum(read_lens, 1))
    jres, jtb = jbatch.align_batch_device(
        refs, reads, ref_lens, read_lens, bw, jparams, n1=N1, n2=N2,
        local=True, special_mode=special_mode)

    params = tbatch.params_from_jax(np.asarray(jparams), "cpu")
    t = _t(refs, reads, ref_lens, read_lens)
    tb, zflags, best, best_xd = tbatch.fill_local_reference(
        *t, params, n1=N1, n2=N2, special_mode=special_mode)
    res, fused = tbatch.walk_local_reference(tb, zflags, best, best_xd,
                                             n1=N1, n2=N2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    _same_fields(res, jres, LOCAL_FIELDS)
    packed, n_ops, score, coords = tbatch.unfuse_result(fused.numpy(),
                                                        local=True)
    np.testing.assert_array_equal(n_ops, np.asarray(jres.n_ops))
    np.testing.assert_array_equal(score, np.asarray(jres.score))
    np.testing.assert_array_equal(packed, np.asarray(jres.ops_packed))
    np.testing.assert_array_equal(
        coords, np.stack([np.asarray(getattr(jres, f)) for f in
                          ("ref_start", "read_start", "ref_end",
                           "read_end")], axis=1))
    # three zero flags a cell; cells past the corner's diagonal hold 0.0
    assert zflags.dtype == torch.uint8 and int(zflags.max()) <= 7
    assert bool((zflags[0, int(ref_lens[0] + read_lens[0]) + 1:] == 7).all())

    fused_w = tbatch.align_batch_local(*t, params, n1=N1, n2=N2,
                                       special_mode=special_mode)
    assert torch.equal(fused_w, fused)


# inputs that hold the local kernel's one-byte traceback encoding: each
# (refs, reads, ref_lens, read_lens, params) with numpy arrays and a params
# list; n1 and n2 follow from the widths
LOCAL_CASES = ("random_per_row", "random_uniform", "gap_plane_zero",
               "all_mismatch", "empty_rows", "tied_hits")
_LOCAL_PARAMS = [10.0, -11.0, 8.0, -15.0, -5.0, 1.0]


def local_case(case):
    rng = np.random.default_rng(500 + LOCAL_CASES.index(case))
    if case.startswith("random"):
        refs, reads, ref_lens, read_lens = _inputs(
            510 + LOCAL_CASES.index(case), case.endswith("uniform"),
            alphabet=BASES)
        return refs, reads, ref_lens, read_lens, _LOCAL_PARAMS
    if case == "gap_plane_zero":
        # a positive gap extension: along a gap the D and I planes climb
        # from below 0.0 and cross it, so some walks stop in D or I
        refs = rng.choice(BASES, (48, 39))
        reads = rng.choice(BASES, (48, 39))
        ref_lens = rng.integers(1, 40, 48).astype(np.int32)
        read_lens = rng.integers(1, 40, 48).astype(np.int32)
        return refs, reads, ref_lens, read_lens, [2.0, -3.0, 2.0, -4.0, 1.0,
                                                  1.0]
    if case == "all_mismatch":
        # no cell beats the (0, 0) cell's 0.0: n_ops 0 at (0, 0)
        refs = np.full((4, 30), ord("A"), np.uint8)
        reads = np.full((4, 25), ord("C"), np.uint8)
        return (refs, reads, np.array([30, 1, 17, 30], np.int32),
                np.array([25, 25, 1, 9], np.int32), _LOCAL_PARAMS)
    if case == "empty_rows":
        refs = rng.choice(BASES, (4, 20))
        reads = rng.choice(BASES, (4, 20))
        reads[3, :12] = refs[3, 4:16]
        return (refs, reads, np.array([0, 20, 0, 20], np.int32),
                np.array([20, 0, 0, 20], np.int32), _LOCAL_PARAMS)
    # tied_hits: two hits of equal score. Row 0: ref P + Q, read Q + P, so
    # both end on one diagonal and the smaller x wins; row 1: a motif
    # twice in the reference, so the earlier diagonal wins.
    p, q, m = (rng.choice(BASES, 12) for _ in range(3))
    refs = np.zeros((2, 40), np.uint8)
    reads = np.zeros((2, 24), np.uint8)
    refs[0, :24] = np.concatenate([p, q])
    reads[0] = np.concatenate([q, p])
    refs[1] = rng.choice(BASES, 40)
    refs[1, 3:15] = refs[1, 25:37] = m
    reads[1, :12] = m
    return (refs, reads, np.array([24, 40], np.int32),
            np.array([24, 12], np.int32), _LOCAL_PARAMS)


def _local_plain(case):
    refs, reads, ref_lens, read_lens, params = local_case(case)
    n1, n2 = refs.shape[1] + 1, reads.shape[1] + 1
    t = _t(refs, reads, ref_lens, read_lens)
    p = torch.tensor(params, dtype=torch.float32)
    out = tbatch.fill_local_reference(*t, p, n1=n1, n2=n2)
    return t, p, n1, n2, out


def _walk_packed(wave, best, best_xd, n1, n2):
    """The local kernel's walk over its one-byte layout, in torch: from the
    argmax cell, in the plane that wins its three values; each step reads
    one byte and stops on a field of LOCAL_ZERO, else emits the plane and
    follows the field, until a border. Returns the fused rows and the
    plane each walk stopped in on a zero field (-1 where it met a
    border)."""
    B, T = wave.shape[0], n1 + n2
    z0, score = tbatch.corner_to_z0_score(best[:, 1:4])
    ex = best_xd[:, 0].long()
    ey = best_xd[:, 1].long() - ex
    x, y, z = ex.clone(), ey.clone(), z0.long()
    rows = torch.arange(B)
    live = torch.ones(B, dtype=torch.bool)
    stop = torch.full((B,), -1)
    walk = torch.full((B, T), tbatch.OP_DONE, dtype=torch.uint8)
    n = torch.zeros(B, dtype=torch.long)
    for _ in range(T):
        live &= (x > 0) & (y > 0)
        off = tbatch.wavefront_offset(x.clamp(min=1), y.clamp(min=1), n1=n1,
                                      n2=n2)
        field = (wave[rows, off].long() >> (2 * z)) & 3
        zero = live & (field == tbatch.LOCAL_ZERO)
        stop = torch.where(zero, z, stop)
        live &= ~zero
        walk[rows[live], n[live]] = z[live].to(torch.uint8)
        n += live.long()
        x -= (live & (z != 2)).long()
        y -= (live & (z != 1)).long()
        z = torch.where(live, field, z)
    j = torch.arange(T)[None, :]
    back = torch.gather(walk, 1, (n[:, None] - 1 - j).clamp(min=0))
    fwd = torch.where(j < n[:, None], back, tbatch.OP_DONE).to(torch.uint8)
    res = tbatch._ops_epilogue(fwd, score, z0, n1=n1, n2=n2)
    coords = torch.stack([x, y, ex, ey], dim=1)
    return tbatch.fuse_result(res.ops_packed, res.n_ops, res.score,
                              coords), stop


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_local_wavefront_round_trip(case):
    """local_tb_to_wavefront then local_wavefront_to_tb gives back the
    plain fill's zero flags on interior cells and its directions where a
    plane's flag is clear; the CPU wrapper returns that layout and counts
    no launch."""
    t, p, n1, n2, (tb, zflags, best, best_xd) = _local_plain(case)
    wave = tbatch.local_tb_to_wavefront(tb, zflags, t[2], t[3], n1=n1, n2=n2)
    tb2, zf2 = tbatch.local_wavefront_to_tb(wave, t[2], t[3], n1=n1, n2=n2)
    x = torch.arange(n1)[None, None, :]
    y = torch.arange(n1 + n2 - 1)[None, :, None] - x
    interior = ((x >= 1) & (x <= t[2][:, None, None])
                & (y >= 1) & (y <= t[3][:, None, None]))
    assert torch.equal(zf2[interior], zflags[interior])
    assert bool((zf2[~interior] == 7).all())
    assert bool((tb2[~interior] == tbatch._TB_FRESH).all())
    for z in range(3):
        clear = interior & ((zflags >> z) & 1 == 0)
        assert torch.equal((tb2[clear] >> 2 * z) & 3, (tb[clear] >> 2 * z) & 3)
    bi, _xi, _yi, off = tbatch._wavefront_index(t[2], t[3], n1, n2)
    outside = torch.ones_like(wave, dtype=torch.bool)
    outside[bi, off] = False
    assert bool((wave[outside] == 0).all())

    before = (dp_kernels.align_local_launches,
              dict(dp_kernels.fill_mode_launches))
    fused_w, wave_w = dp_kernels.dp_align_local(*t, p, n1=n1, n2=n2,
                                                return_traceback=True)
    assert torch.equal(wave_w, wave)
    assert torch.equal(fused_w, tbatch.walk_local_reference(
        tb, zflags, best, best_xd, n1=n1, n2=n2)[1])
    assert (dp_kernels.align_local_launches,
            dp_kernels.fill_mode_launches) == before


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_packed_walk_matches_walk_local_reference(case):
    """A walk over the one-byte layout (stop on a field of 3, else follow
    it) gives walk_local_reference's fused rows byte for byte: walks that
    stop in D or I, an all-mismatch batch whose argmax is (0, 0), empty
    reads and references, and equal best hits in (diagonal, x) order."""
    t, _p, n1, n2, (tb, zflags, best, best_xd) = _local_plain(case)
    _res, want = tbatch.walk_local_reference(tb, zflags, best, best_xd,
                                             n1=n1, n2=n2)
    wave = tbatch.local_tb_to_wavefront(tb, zflags, t[2], t[3], n1=n1, n2=n2)
    got, stop = _walk_packed(wave, best, best_xd, n1, n2)
    assert torch.equal(got, want)
    _packed, n_ops, score, coords = tbatch.unfuse_result(got.numpy(),
                                                         local=True)
    if case == "gap_plane_zero":
        assert bool(((stop == 1) | (stop == 2)).any())
    elif case == "all_mismatch":
        assert (n_ops == 0).all() and (score == 0).all()
        assert (coords == 0).all()
    elif case == "empty_rows":
        assert (n_ops[:3] == 0).all() and n_ops[3] > 0
    elif case == "tied_hits":
        # equal scores; row 0 ends at (12, 24) before (24, 12) on diagonal
        # 36, row 1 at x = 15 (diagonal 27) before x = 37 (diagonal 49)
        assert score[0] == score[1] == 12 * _LOCAL_PARAMS[0]
        assert coords[0].tolist() == [0, 12, 12, 24]
        assert coords[1].tolist() == [3, 0, 15, 12]


def _expand_local(local, i, ref, read):
    """Aligned strings of row i, as tests/test_local_device.py expands."""
    ops = local.ops[i].numpy()
    x, y = int(local.ref_start[i]), int(local.read_start[i])
    a1, a2 = bytearray(), bytearray()
    for op in ops[:int(local.n_ops[i])]:
        if op == tbatch.OP_MATCH:
            a1.append(ref[x]); a2.append(read[y]); x += 1; y += 1
        elif op == tbatch.OP_DEL:
            a1.append(ref[x]); a2.append(ord("-")); x += 1
        else:
            a1.append(ord("-")); a2.append(read[y]); y += 1
    assert (x, y) == (int(local.ref_end[i]), int(local.read_end[i]))
    return bytes(a1), bytes(a2)


def _local_pairs(pairs, scoring):
    refs_arr, ref_lens = tbatch.pad_batch([a for a, _b in pairs])
    reads_arr, read_lens = tbatch.pad_batch([b for _a, b in pairs])
    n1, n2 = refs_arr.shape[1] + 1, reads_arr.shape[1] + 1
    t = _t(refs_arr, reads_arr, ref_lens, read_lens)
    out = tbatch.fill_local_reference(
        *t, tbatch.scoring_to_params(_port_scoring(scoring), "cpu"), n1=n1,
        n2=n2)
    return tbatch.walk_local_reference(*out, n1=n1, n2=n2)[0]


def test_waterman_eggert_fixture():
    """The W-E fixture of tests/test_local_device.py and its mixed-length
    padding case: the port's local walk gives the golden strings."""
    sc = AffineScoring(10, -9, 8, -20, -10, 1.0)
    pairs = [(b"CCAATCTACTACTGCTTGCAGTAC", b"AGTCCGAGGGCTACTCTACTGAAC"),
             (b"ACGT", b"ACGT"), (b"AAAA", b"TTTT")]
    local = _local_pairs(pairs, sc)
    assert _expand_local(local, 0, *pairs[0]) == (b"CCAATCTACT",
                                                  b"CTACTCTACT")
    for i, (a, b) in enumerate(pairs):
        golden = affine_align(a, b, sc, local=True)
        assert float(local.score[i]) == golden.score, i
        assert _expand_local(local, i, a, b) == (golden.reference_aligned,
                                                 golden.read_aligned)


def test_local_matches_host_golden_random():
    rng = np.random.default_rng(2024)
    sc = AffineScoring(10, -11, 8, -15, -5, 1.0)
    pairs = []
    for _ in range(16):
        a = rng.choice(BASES, int(rng.integers(8, 40))).tobytes()
        b = rng.choice(BASES, int(rng.integers(8, 40))).tobytes()
        if rng.random() < 0.5:
            seg = rng.choice(BASES, int(rng.integers(5, 12))).tobytes()
            pa, pb = int(rng.integers(0, len(a))), int(rng.integers(0, len(b)))
            a, b = a[:pa] + seg + a[pa:], b[:pb] + seg + b[pb:]
        pairs.append((a, b))
    local = _local_pairs(pairs, sc)
    for i, (a, b) in enumerate(pairs):
        golden = affine_align(a, b, sc, local=True)
        assert float(local.score[i]) == golden.score, i
        assert _expand_local(local, i, a, b) == (golden.reference_aligned,
                                                 golden.read_aligned), i


def _mutate(seq, rng, sub=0.05, indel=0.02):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(int(rng.choice(BASES)))
        out.append(int(rng.choice(BASES)) if rng.random() < sub else c)
    return bytes(out)


@pytest.mark.parametrize("case", ["width20", "f64_truncation", "ragged"])
def test_banded_matches_host_affine_align(case):
    """Banded fill + walk against the host golden affine_align(bandwidth=)
    (perform_affine_alignment_bandwidth), including len1=48, len2=146,
    where the f64 band center at x=1 truncates to 2, not the exact 3."""
    rng = np.random.default_rng(77)
    scoring = AffineScoring.aligner_default()
    if case == "width20":
        ref = rng.choice(BASES, 80).tobytes()
        pairs, width = [(ref, _mutate(ref, rng))], 20
    elif case == "f64_truncation":
        centers = tbatch.band_centers_f64(np.array([48]), np.array([146]), 49)
        assert centers[0, 1] == 2
        pairs = [(rng.choice(BASES, 48).tobytes(),
                  rng.choice(BASES, 146).tobytes())]
        width = 3
    else:
        pairs = []
        for n in (40, 80, 120):
            ref = rng.choice(BASES, n).tobytes()
            pairs.append((ref, _mutate(ref, rng)))
        width = 16
    refs_arr, ref_lens = tbatch.pad_batch([a for a, _b in pairs])
    reads_arr, read_lens = tbatch.pad_batch([b for _a, b in pairs])
    n1, n2 = refs_arr.shape[1] + 1, reads_arr.shape[1] + 1
    bw = np.full(len(pairs), width, np.int32)
    centers = tbatch.band_centers_f64(ref_lens, read_lens, n1)
    t = _t(refs_arr, reads_arr, ref_lens, read_lens, bw, centers)
    params = tbatch.scoring_to_params(_port_scoring(scoring), "cpu")
    fused, _tb = tbatch.align_batch(*t[:4], params, n1=n1, n2=n2,
                                    special_mode="both", bandwidth=t[4],
                                    band_centers=t[5])
    packed, n_ops, score = tbatch.unfuse_result(fused.numpy())
    ops = tbatch.unpack_ops(packed, n1 + n2)
    for i, (ref, read) in enumerate(pairs):
        golden = affine_align(ref, read, scoring, bandwidth=width)
        a1, a2, cigar = tbatch.ops_to_alignment(ops[i], int(n_ops[i]), ref,
                                                read)
        assert (a1, a2, cigar) == (golden.reference_aligned,
                                   golden.read_aligned, golden.cigar), i
        assert float(score[i]) == golden.score, i


def test_inversion_batch_matches_jax():
    """The port's inversion_alignment_batch against the JAX one on the
    input of tests/test_inversion.py:45-91 (14 plain reads, one with a
    20 bp inverted block, one with an indel): every field of every
    result, the block markers included."""
    from clique_tpu.align.inversion import (
        inversion_alignment_batch as jax_inversion_batch)
    from clique_tpu.utils.seq import reverse_complement
    from clique_tpu_torch.align.inversion import inversion_alignment_batch

    aff = AffineScoring(10.0, -11.0, 8.0, -15.0, -5.0, 1.0)
    rng = np.random.default_rng(5)
    ref = rng.choice(BASES, 60).tobytes()
    reads = []
    for i in range(14):
        r = bytearray(ref)
        for _k in range(3):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(BASES))
        if i % 3 == 1:
            p = int(rng.integers(1, len(r) - 4))
            del r[p:p + int(rng.integers(1, 4))]
        elif i % 3 == 2:
            p = int(rng.integers(1, len(r) - 1))
            r[p:p] = rng.choice(BASES, int(rng.integers(1, 4))).tobytes()
        reads.append(bytes(r))
    reads.append(ref[:20] + reverse_complement(ref[20:40]) + ref[40:])
    reads.append(ref[:25] + ref[28:])
    names = [f"r{i}" for i in range(len(reads))]

    want = jax_inversion_batch(ref, reads, "ref", names, INV, aff)
    got = inversion_alignment_batch(ref, reads, "ref", names, PORT_INV,
                                    _port_scoring(aff), device="cpu")
    assert len(got) == len(want) == len(reads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), i
    ops = [op for _c, op in got[14].cigar]
    assert "<" in ops and ">" in ops


def test_inversion_batch_splits_by_memory(monkeypatch):
    """A traceback budget below one group's size splits the screen and the
    keep-last fill into several launches with the same results."""
    from clique_tpu_torch.align import inversion

    rng = np.random.default_rng(9)
    ref = rng.choice(BASES, 40).tobytes()
    reads = [_mutate(ref, rng) for _ in range(6)]
    names = [f"q{i}" for i in range(6)]
    aff = tscoring.AffineScoring(10.0, -11.0, 8.0, -15.0, -5.0, 1.0)
    calls = []

    def counted(fn):
        def run(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return run

    for name in ("align_batch", "align_batch_local"):
        monkeypatch.setattr(tbatch, name, counted(getattr(tbatch, name)))
    whole = inversion.inversion_alignment_batch(ref, reads, "ref", names,
                                                PORT_INV, aff, device="cpu")
    n_whole = len(calls)
    # room for about two screen alignments (n1 = 41, n2 <= 47) a launch
    monkeypatch.setattr(tbatch, "MAX_TRACEBACK_BYTES",
                        2 * tbatch.local_traceback_bytes(41, 50, "cpu"))
    split = inversion.inversion_alignment_batch(
        ref, reads, "ref", names, PORT_INV, aff, device="cpu")
    assert split == whole
    assert len(calls) - n_whole > n_whole


@pytest.mark.parametrize("bad", ["tie_order", "special_mode", "band_half",
                                 "centers_shape", "centers_dtype"])
def test_mode_arguments_are_checked(bad):
    refs, reads, ref_lens, read_lens = _inputs(3)
    t = _t(refs, reads, ref_lens, read_lens)
    bw, centers = _band(ref_lens, read_lens, 8)
    bw_t, c_t = _t(bw, centers)
    kw = dict(n1=N1, n2=N2, special_mode="both")
    if bad == "tie_order":
        kw["tie_order"] = "first"
    elif bad == "special_mode":
        kw["special_mode"] = "all"
    elif bad == "band_half":
        kw["bandwidth"] = bw_t
    elif bad == "centers_shape":
        kw.update(bandwidth=bw_t, band_centers=c_t[:, :-1].contiguous())
    else:
        kw.update(bandwidth=bw_t, band_centers=c_t.to(torch.int64))
    params = tbatch.scoring_to_params(PORT_RUST_BIO_COMPAT, "cpu")
    with pytest.raises((TypeError, ValueError)):
        dp_kernels.dp_align(*t, params, **kw)
    if bad == "special_mode":
        # the local kernel takes no band and no tie order
        with pytest.raises(ValueError):
            dp_kernels.dp_align_local(*t, params, **kw)


def test_walk_local_rejects_bad_inputs():
    """dp_align_local, which now walks inside the fused local kernel,
    rejects a bad shape, a bad dtype and a bad row count."""
    refs, reads, ref_lens, read_lens = _inputs(4)
    t = _t(refs, reads, ref_lens, read_lens)
    params = tbatch.scoring_to_params(PORT_RUST_BIO_COMPAT, "cpu")
    with pytest.raises(ValueError):
        dp_kernels.dp_align_local(*t[:3], t[3][:-1].contiguous(), params,
                                  n1=N1, n2=N2)
    with pytest.raises(TypeError):
        dp_kernels.dp_align_local(*t, params.double(), n1=N1, n2=N2)
    with pytest.raises(ValueError):
        dp_kernels.dp_align_local(t[0][:2].contiguous(), *t[1:], params,
                                  n1=N1, n2=N2)
