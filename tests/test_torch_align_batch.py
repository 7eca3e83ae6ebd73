"""clique_tpu_torch.align.batch (plain PyTorch fill + walk) against the JAX
package's align_batch_device and Pallas fill, on the CPU.

Every DP decision is exact on any backend (dyadic f32 sums,
clique_tpu/align/batch.py:18-21), so the tolerance is exact equality:
traceback bytes, score, start plane, ops, n_ops, packed ops and the fused
result buffer must be identical.
"""

import numpy as np
import pytest
import torch

from clique_tpu.align import batch as jbatch
from clique_tpu.align.merge import MERGE_SCORING as JAX_MERGE_SCORING
from clique_tpu.align.pallas_kernel import pallas_fill, unpack_words
from clique_tpu.align.pipeline import RUST_BIO_COMPAT as JAX_RUST_BIO_COMPAT
from clique_tpu.align.scoring import AffineScoring as JaxAffineScoring
from clique_tpu_torch.align import batch as tbatch
from clique_tpu_torch.align import dp_kernels
from clique_tpu_torch.align.merge import MERGE_SCORING
from clique_tpu_torch.align.pipeline import RUST_BIO_COMPAT
from clique_tpu_torch.align.scoring import AffineScoring

B, N1, N2 = 8, 128, 128
# each side's own scoring objects, by name
SCORINGS = {
    "rust_bio_compat": (JAX_RUST_BIO_COMPAT, RUST_BIO_COMPAT),
    "merge": (JAX_MERGE_SCORING, MERGE_SCORING),
    "aligner_default": (JaxAffineScoring.aligner_default(),
                        AffineScoring.aligner_default()),
    "default_dna": (JaxAffineScoring.default_dna(),
                    AffineScoring.default_dna()),
}
# bases, N and digit bytes (< 58): both special-byte rules get exercised
ALPHABET = np.frombuffer(b"ACGTACGTACGTN0129", dtype=np.uint8)


def _inputs(seed, uniform):
    rng = np.random.default_rng(seed)
    rows = 1 if uniform else B
    refs = np.zeros((rows, N1 - 1), np.uint8)
    reads = np.zeros((B, N2 - 1), np.uint8)
    ref_lens = rng.integers(1, N1, B).astype(np.int32)
    read_lens = rng.integers(1, N2, B).astype(np.int32)
    # ragged extremes: length 1 and n - 1 on both sides
    ref_lens[0], read_lens[0] = 1, N2 - 1
    ref_lens[1], read_lens[1] = N1 - 1, 1
    ref_lens[2], read_lens[2] = N1 - 1, N2 - 1
    if uniform:
        ref_lens[:] = ref_lens[3]
    for i in range(rows):
        refs[i, :ref_lens[i]] = rng.choice(ALPHABET, ref_lens[i])
    for i in range(B):
        reads[i, :read_lens[i]] = rng.choice(ALPHABET, read_lens[i])
    # a read that copies its reference, so long match runs occur too
    if not uniform:
        n = min(ref_lens[4], N2 - 1)
        reads[4, :n] = refs[4, :n]
        read_lens[4] = n
    return refs, reads, ref_lens, read_lens


def _jax_run(refs, reads, ref_lens, read_lens, scoring, special_mode):
    params = jbatch.scoring_to_params(scoring)
    bw = np.maximum(ref_lens, np.maximum(read_lens, 1))
    res, tb = jbatch.align_batch_device(
        refs, reads, ref_lens, read_lens, bw, params, n1=N1, n2=N2,
        special_mode=special_mode)
    fused = jbatch.fuse_result(res.ops_packed, res.n_ops, res.score)
    return params, res, np.asarray(tb), np.asarray(fused)


def _torch_run(refs, reads, ref_lens, read_lens, params, special_mode):
    t = [torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)]
    tb, corner = tbatch.fill_reference(*t, params, n1=N1, n2=N2,
                                       special_mode=special_mode)
    res, fused = tbatch.walk_reference(tb, corner, t[2], t[3], n1=N1, n2=N2)
    return tb, corner, res, fused


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
def test_fill_walk_match_align_batch_device(special_mode, scoring, uniform):
    seed = 100 + 10 * list(SCORINGS).index(scoring) + int(uniform)
    refs, reads, ref_lens, read_lens = _inputs(seed, uniform)
    jparams, jres, jtb, jfused = _jax_run(refs, reads, ref_lens, read_lens,
                                          SCORINGS[scoring][0], special_mode)
    params = tbatch.params_from_jax(np.asarray(jparams), "cpu")
    tb, corner, res, fused = _torch_run(refs, reads, ref_lens, read_lens,
                                        params, special_mode)

    np.testing.assert_array_equal(tb.numpy(), jtb)
    z0, score = tbatch.corner_to_z0_score(corner)
    np.testing.assert_array_equal(score.numpy(), np.asarray(jres.score))
    np.testing.assert_array_equal(z0.numpy(), np.asarray(jres.start_z))
    for field in ("score", "start_z", "ops", "n_ops", "ops_packed"):
        got = getattr(res, field).numpy()
        want = np.asarray(getattr(jres, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_array_equal(fused.numpy(), jfused)

    # the wrapper takes the plain versions for CPU tensors: same bytes, the
    # traceback in the kernel's strip layout, and no kernel launch counted
    before = dp_kernels.align_launches
    t = [torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)]
    fused_w, tb_w = tbatch.align_batch(*t, params, n1=N1, n2=N2,
                                       special_mode=special_mode,
                                       return_traceback=True)
    assert torch.equal(fused_w, fused)
    assert torch.equal(tbatch.wavefront_to_tb(tb_w, t[2], t[3], n1=N1, n2=N2),
                       tb)
    assert dp_kernels.align_launches == before


@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
def test_fill_matches_pallas_interpret(special_mode):
    """Mirror of tests/test_pallas_kernel.py: the port's traceback and
    corner equal the Pallas kernel run in interpret mode."""
    refs, reads, ref_lens, read_lens = _inputs(7, uniform=False)
    jparams = jbatch.scoring_to_params(JaxAffineScoring.aligner_default())
    refs_p = np.zeros((B, N1), np.uint8)      # pre-shifted: ref[x - 1]
    refs_p[:, 1:] = refs
    words, jcorner = pallas_fill(refs_p, reads, ref_lens, read_lens, jparams,
                                 n1=N1, n2=N2, special_mode=special_mode,
                                 packed=True, interpret=True)
    jtb = np.asarray(unpack_words(words, N1 + N2 - 1))
    params = tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")
    tb, corner, _res, _fused = _torch_run(refs, reads, ref_lens, read_lens,
                                          params, special_mode)
    np.testing.assert_array_equal(tb.numpy(), jtb)
    np.testing.assert_array_equal(corner.numpy(), np.asarray(jcorner))


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_params_from_jax_equals_scoring_to_params(scoring):
    jparams = np.asarray(jbatch.scoring_to_params(SCORINGS[scoring][0]))
    got = tbatch.params_from_jax(jparams, "cpu")
    want = tbatch.scoring_to_params(SCORINGS[scoring][1], "cpu")
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def _random_ops(seed, rows=12, T=40):
    rng = np.random.default_rng(seed)
    n_ops = rng.integers(0, T + 1, rows).astype(np.int32)
    n_ops[0] = 0
    n_ops[1] = T
    ops = np.full((rows, T), tbatch.OP_DONE, np.uint8)
    for i, n in enumerate(n_ops):
        ops[i, :n] = rng.integers(0, 3, n)
    refs_arr = rng.choice(ALPHABET, (rows, T)).astype(np.uint8)
    reads_arr = rng.choice(ALPHABET, (rows, T)).astype(np.uint8)
    return ops, n_ops, refs_arr, reads_arr


def _same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


HELPERS = {
    "unfuse_result": lambda m, ops, n, r, d: m.unfuse_result(
        np.concatenate([n.view(np.uint8).reshape(-1, 4),
                        np.float32(n * 0.5).view(np.uint8).reshape(-1, 4),
                        ops], axis=1)),
    "unpack_ops": lambda m, ops, n, r, d: m.unpack_ops(ops, 4 * ops.shape[1]),
    "pad_batch": lambda m, ops, n, r, d: m.pad_batch(
        [bytes(row[:k]) for row, k in zip(r, n)]),
    "ops_to_alignments_batch": lambda m, ops, n, r, d:
        m.ops_to_alignments_batch(ops, n, r, d),
    "cigar_from_ops_row": lambda m, ops, n, r, d: [
        m.cigar_from_ops_row(ops[i], int(n[i])) for i in range(len(n))],
    "cigar_runs_from_ops_batch": lambda m, ops, n, r, d:
        m.cigar_runs_from_ops_batch(ops, n),
    "cigars_from_runs": lambda m, ops, n, r, d: m.cigars_from_runs(
        *jbatch.cigar_runs_from_ops_batch(ops, n)),
    "cigars_from_ops_batch": lambda m, ops, n, r, d:
        m.cigars_from_ops_batch(ops, n),
    "ops_to_alignment": lambda m, ops, n, r, d: [
        m.ops_to_alignment(ops[i], int(n[i]), bytes(r[i]), bytes(d[i]))
        for i in range(len(n))],
}


@pytest.mark.parametrize("helper", list(HELPERS))
def test_host_helper_copies_match(helper):
    """The copied host helpers give the JAX package's results."""
    for seed in (1, 2, 3):
        ops, n_ops, refs_arr, reads_arr = _random_ops(seed)
        fn = HELPERS[helper]
        _same(fn(tbatch, ops, n_ops, refs_arr, reads_arr),
              fn(jbatch, ops, n_ops, refs_arr, reads_arr))


def _wrapper_args():
    refs, reads, ref_lens, read_lens = _inputs(3, uniform=False)
    t = [torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)]
    params = tbatch.scoring_to_params(RUST_BIO_COMPAT, "cpu")
    return t, params


@pytest.mark.parametrize("bad", [
    "reads_dtype", "refs_rows", "lens_dtype", "params_len", "narrow_reads",
    "special_mode", "noncontiguous", "lens_range",
])
def test_dp_fill_rejects_bad_inputs(bad):
    (refs, reads, ref_lens, read_lens), params = _wrapper_args()
    kw = dict(n1=N1, n2=N2, special_mode="both")
    if bad == "reads_dtype":
        reads = reads.to(torch.int32)
    elif bad == "refs_rows":
        refs = refs[:3].contiguous()
    elif bad == "lens_dtype":
        ref_lens = ref_lens.to(torch.int64)
    elif bad == "params_len":
        params = params[:5].contiguous()
    elif bad == "narrow_reads":
        reads = reads[:, :N2 - 2].contiguous()
    elif bad == "special_mode":
        kw["special_mode"] = "wildcards"
    elif bad == "noncontiguous":
        reads = torch.cat([reads, reads], dim=1)[:, ::2]
    elif bad == "lens_range":
        ref_lens = ref_lens.clone()
        ref_lens[0] = N1
    with pytest.raises((TypeError, ValueError)):
        dp_kernels.dp_align(refs, reads, ref_lens, read_lens, params, **kw)


@pytest.mark.parametrize("n1,n2", [(2, 2), (13, 5), (14, 40), (128, 128),
                                   (400, 9), (800, 30)])
def test_traceback_wavefront_layout(n1, n2):
    """The kernel's traceback layout: its size (the traceback-memory caps
    use it) stays under the old [D, n1] layout for square buckets, every
    interior cell has a byte of its own, and every interior cell of
    fill_reference's traceback, and nothing else, survives
    tb_to_wavefront -> wavefront_to_tb."""
    size = tbatch.traceback_bytes(n1, n2)
    S = -(-(n1 - 1) // 12)
    assert size % 16 == 0 and size >= S * 12 * (n2 - 1)
    if n1 == n2 and n1 > 100:
        assert size < (n1 + n2 - 1) * n1
    rng = np.random.default_rng(n1 * 1000 + n2)
    refs = rng.choice(ALPHABET, (3, n1 - 1)).astype(np.uint8)
    reads = rng.choice(ALPHABET, (3, n2 - 1)).astype(np.uint8)
    t = [torch.from_numpy(a) for a in (
        refs, reads, np.array([n1 - 1, 0, (n1 - 1) // 2], np.int32),
        np.array([n2 - 1, n2 - 1, 0], np.int32))]
    _b, _x, _y, off = tbatch._wavefront_index(t[2][:1], t[3][:1], n1, n2)
    assert len(set(off.tolist())) == (n1 - 1) * (n2 - 1)
    assert not len(off) or int(off.max()) < size
    params = tbatch.scoring_to_params(RUST_BIO_COMPAT, "cpu")
    tb, _corner = tbatch.fill_reference(*t, params, n1=n1, n2=n2,
                                        special_mode="both")
    wave = tbatch.tb_to_wavefront(tb, t[2], t[3], n1=n1, n2=n2)
    assert tuple(wave.shape) == (3, size)
    assert int(wave[1].count_nonzero()) == int(wave[2].count_nonzero()) == 0
    assert torch.equal(tbatch.wavefront_to_tb(wave, t[2], t[3], n1=n1,
                                              n2=n2), tb)


def test_wavefront_to_tb_rejects_bad_shapes():
    (refs, reads, ref_lens, read_lens), params = _wrapper_args()
    _fused, wave = dp_kernels.dp_align(refs, reads, ref_lens, read_lens,
                                       params, n1=N1, n2=N2,
                                       special_mode="both",
                                       return_traceback=True)
    with pytest.raises(ValueError):
        tbatch.wavefront_to_tb(wave[:, :-16], ref_lens, read_lens, n1=N1,
                               n2=N2)
    with pytest.raises(ValueError):
        tbatch.wavefront_to_tb(wave, ref_lens, read_lens, n1=N1 + 12, n2=N2)
    # a marked row (lengths outside the bucket) lays out fresh throughout
    bad = ref_lens.clone()
    bad[0] = N1
    tb = tbatch.wavefront_to_tb(wave, bad, read_lens, n1=N1, n2=N2)
    assert bool((tb[0] == tbatch._TB_FRESH).all())


def test_marked_rows_raise_when_read_back():
    """A fused row with n_ops -1 (how the CUDA walk marks lengths outside
    the bucket) raises the plain fill's ValueError when BatchAligner
    reads it back; unmarked rows expand as before."""
    from clique_tpu_torch.align.pipeline import BatchAligner

    aligner = BatchAligner(RUST_BIO_COMPAT, batch_size=4, device="cpu")
    refs = [b"ACGTACGTAC"] * 3
    reads = [b"ACGTTCGTAC", b"ACGACGTAC", b"ACGTACGTACG"]
    entries = list(aligner.align_pairs_entries(refs, reads))
    assert len(entries) == 1
    raws = aligner.expand_entry(entries[0])
    assert [len(r[0]) for r in raws] == [3]

    *head, fused = entries[0]
    marked = fused.copy()
    marked[1, 0:4] = np.array([-1], np.int32).view(np.uint8)
    with pytest.raises(ValueError, match="outside their bucket"):
        aligner.expand_entry(tuple(head) + (marked,))
    with pytest.raises(ValueError, match="ref_lens"):
        t = [torch.from_numpy(a) for a in _inputs(3, uniform=False)]
        t[2][0] = N1
        tbatch.align_batch(*t, tbatch.scoring_to_params(RUST_BIO_COMPAT,
                                                        "cpu"),
                           n1=N1, n2=N2, special_mode="ref_n_only")
