"""The port's parallel/mesh.py::length_sharded_align (one alignment's DP
rows split into parts over a list of devices: a column tile of a part a
fill_segment call with the row above handed down, the walk climbing from
the corner's part) against the JAX package's length_sharded_align on the
conftest's virtual 8-device CPU mesh, against its single-device
align_batch_device on splits the JAX mesh cannot take, and against the
port's own dp_align and fill_reference. Here the mesh is CPU entries, so
the plain versions (batch.fill_segment_reference, walk_segment_reference)
run; csrc/dp_align_split.cu is held on the card by test_torch_cuda.py and
chip_smoke.py. Inputs come from numpy seeds; scores are dyadic floats and
ops and tracebacks integers, so every comparison is exact."""

import numpy as np
import pytest
import torch

from clique_tpu_torch.align import batch as tbatch
from clique_tpu_torch.align import dp_kernels
from clique_tpu_torch.align.scoring import AffineScoring
from clique_tpu_torch.parallel import length_sharded_align
from clique_tpu_torch.parallel.mesh import split_rows

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ALPHABET = np.frombuffer(b"ACGTACGTN0", dtype=np.uint8)


def _params():
    return tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")


def _jax_test_inputs():
    """The inputs of tests/test_parallel.py's
    test_length_sharded_align_matches_single_device: B=2, LR=512, LD=480,
    seed 12, reads the references' first LD bases with 5%
    substitutions."""
    rng = np.random.default_rng(12)
    B, LR, LD = 2, 512, 480
    refs = rng.choice(BASES, size=(B, LR)).astype(np.uint8)
    reads = np.empty((B, LD), dtype=np.uint8)
    for b in range(B):
        r = refs[b, :LD].copy()
        subs = rng.random(LD) < 0.05
        r[subs] = rng.choice(BASES, int(subs.sum()))
        reads[b] = r
    return (refs, reads, np.full(B, LR, dtype=np.int32),
            np.full(B, LD, dtype=np.int32))


def _dp_align(refs, reads, ref_lens, read_lens, n1, n2):
    """One dp_align call on the CPU (its plain versions): (scores, ops,
    n_ops) as numpy arrays."""
    fused, _ = dp_kernels.dp_align(
        *(torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)),
        _params(), n1=n1, n2=n2, special_mode="both")
    packed, n_ops, score = tbatch.unfuse_result(fused.numpy())
    return score, tbatch.unpack_ops(np.ascontiguousarray(packed),
                                    n1 + n2), n_ops


def _assert_same(got, want):
    scores, ops, n_ops = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), scores)
    np.testing.assert_array_equal(got[2].numpy(), n_ops)
    np.testing.assert_array_equal(got[1].numpy(), ops)


def test_matches_jax_length_sharded_align():
    """The JAX test's case over [cpu] * 8 (8 parts of 64 rows) against the
    JAX function on the virtual 8-device mesh."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from clique_tpu.align.batch import scoring_to_params as jax_params
    from clique_tpu.align.scoring import AffineScoring as JaxAffine
    from clique_tpu.parallel.mesh import length_sharded_align as jax_fn
    from clique_tpu.parallel.mesh import make_mesh as jax_make_mesh

    refs, reads, ref_lens, read_lens = _jax_test_inputs()
    n1, n2 = refs.shape[1] + 1, reads.shape[1] + 1
    params = np.asarray(jax_params(JaxAffine.aligner_default()))
    got = length_sharded_align([torch.device("cpu")] * 8, refs, reads,
                               ref_lens, read_lens, params, n1=n1, n2=n2)
    want = jax_fn(jax_make_mesh(8), refs, reads, ref_lens, read_lens,
                  params, n1=n1, n2=n2)
    _assert_same(got, want)
    _assert_same(got, _dp_align(refs, reads, ref_lens, read_lens, n1, n2))


def test_uneven_ragged_split_matches_jax_align_batch_device():
    """Three uneven parts (the JAX mesh cannot take the split), ragged
    lengths: corners on every part, an l1 on each side of a part boundary,
    empty reads and references, tiles of 9 columns; against the JAX
    single-device align_batch_device with the JAX function's band."""
    from clique_tpu.align.batch import align_batch_device
    from clique_tpu.align.batch import scoring_to_params as jax_params
    from clique_tpu.align.scoring import AffineScoring as JaxAffine

    rng = np.random.default_rng(31)
    B, LR, LD = 9, 60, 50
    bounds = [1, 17, 22, 61]
    refs = rng.choice(ALPHABET, size=(B, LR)).astype(np.uint8)
    reads = rng.choice(ALPHABET, size=(B, LD)).astype(np.uint8)
    ref_lens = np.array([60, 40, 17, 16, 21, 22, 3, 0, 35], dtype=np.int32)
    read_lens = np.array([50, 33, 12, 41, 0, 29, 7, 25, 50], dtype=np.int32)
    reads[1, :30] = refs[1, 5:35]         # a near-diagonal path
    params = np.asarray(jax_params(JaxAffine.aligner_default()))
    got = length_sharded_align(["cpu"] * 3, refs, reads, ref_lens, read_lens,
                               params, n1=LR + 1, n2=LD + 1, bounds=bounds,
                               tile=9)
    bw = np.maximum(ref_lens, read_lens)
    single, _ = align_batch_device(refs, reads, ref_lens, read_lens, bw,
                                   params, n1=LR + 1, n2=LD + 1)
    _assert_same(got, (single.score, single.ops, single.n_ops))


@pytest.mark.parametrize("parts", [1, 2, 5])
@pytest.mark.parametrize("tile", [1, 7, 40])
def test_segments_match_dp_align_and_fill_reference(parts, tile):
    """Every tile width (one column, a few, all columns in one tile) and
    number of parts: the result equals one dp_align call, and the parts'
    tracebacks, stacked in row order, equal fill_reference's cells."""
    rng = np.random.default_rng(100 * parts + tile)
    B, n1, n2 = 5, 30, 25
    refs = rng.choice(ALPHABET, (B, n1 - 1)).astype(np.uint8)
    reads = rng.choice(ALPHABET, (B, n2 - 1)).astype(np.uint8)
    ref_lens = rng.integers(0, n1, B).astype(np.int32)
    read_lens = rng.integers(0, n2, B).astype(np.int32)
    ref_lens[:2], read_lens[:2] = (n1 - 1, 0), (n2 - 1, n2 - 1)
    got = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                               read_lens, _params(), n1=n1, n2=n2, tile=tile,
                               return_parts=True)
    _assert_same(got, _dp_align(refs, reads, ref_lens, read_lens, n1, n2))
    info, times = got[3], got[4]
    assert [p["rows"] for p in info] == list(zip(
        split_rows(n1, parts, False)[:-1], split_rows(n1, parts, False)[1:]))
    assert all(p["fills"] == -(-(n2 - 1) // tile) for p in info)
    assert times["fill_ms"] >= 0 and times["walk_ms"] >= 0
    tb, _corner = tbatch.fill_reference(
        *(torch.from_numpy(a) for a in (refs, reads, ref_lens, read_lens)),
        _params(), n1=n1, n2=n2, special_mode="both")
    x = torch.arange(1, n1)[:, None]
    y = torch.arange(1, n2)[None, :]
    assert torch.equal(torch.cat([p["traceback"] for p in info], dim=1),
                       tb[:, x + y, x])


def test_part_traceback_is_dp_aligns_bands():
    """A part whose first row starts a 384-row band of dp_align: its
    traceback in the kernels' layout (the plain one relaid) is dp_align's
    bytes of those bands; segment_wavefront_to_rows reads them back."""
    rng = np.random.default_rng(7)
    B, n1, n2 = 2, 800, 40
    refs = rng.choice(BASES, (B, n1 - 1)).astype(np.uint8)
    reads = rng.choice(BASES, (B, n2 - 1)).astype(np.uint8)
    ref_lens = np.array([n1 - 1, 500], dtype=np.int32)
    read_lens = np.array([n2 - 1, 30], dtype=np.int32)
    assert split_rows(n1, 2, True).tolist() == [1, 385, 800]
    got = length_sharded_align(["cpu"] * 2, refs, reads, ref_lens, read_lens,
                               _params(), n1=n1, n2=n2,
                               bounds=split_rows(n1, 2, True),
                               return_parts=True)
    lens = [torch.from_numpy(a) for a in (ref_lens, read_lens)]
    _f, wave = dp_kernels.dp_align(
        *(torch.from_numpy(a) for a in (refs, reads)), *lens, _params(),
        n1=n1, n2=n2, special_mode="both", return_traceback=True)
    part = got[3][1]
    start = 384 * (n2 + 30)            # dp_align's band 1
    relaid = tbatch.segment_wavefront_to_rows(
        wave[:, start:start + tbatch.traceback_bytes(416, n2)], *lens,
        row0=385, n=415, n1=n1, n2=n2)
    assert torch.equal(relaid, part["traceback"])
    assert torch.equal(relaid[:, :, 9:20], tbatch.segment_wavefront_to_rows(
        wave[:, start:start + tbatch.traceback_bytes(416, n2)], *lens,
        row0=385, n=415, n1=n1, n2=n2, cols=(10, 21)))


def test_split_rows():
    assert split_rows(513, 8, False).tolist() == list(range(1, 514, 64))
    assert split_rows(16385, 4, True).tolist() == [1, 3841, 8065, 12289,
                                                   16385]
    # fewer bands than parts: the rows are cut evenly
    assert split_rows(513, 3, True).tolist() == [1, 171, 342, 513]
    with pytest.raises(ValueError):
        split_rows(4, 4, False)


def test_lengths_outside_the_bucket_raise():
    refs, reads, _rl, _dl = _jax_test_inputs()
    refs, reads = refs[:, :20], reads[:, :20]
    for rl, dl in ((np.array([21, 5]), np.array([5, 5])),
                   (np.array([5, 5]), np.array([5, -1]))):
        with pytest.raises(ValueError):
            length_sharded_align(["cpu"] * 2, refs, reads,
                                 rl.astype(np.int32), dl.astype(np.int32),
                                 _params(), n1=21, n2=21)


def test_bad_meshes_and_splits_raise():
    refs, reads, _rl, _dl = _jax_test_inputs()
    lens = np.full(2, 20, dtype=np.int32)
    args = (refs[:, :20], reads[:, :20], lens, lens, _params())
    with pytest.raises(ValueError):        # a mixed mesh
        length_sharded_align(["cpu", "cuda:0"], *args, n1=21, n2=21)
    with pytest.raises(ValueError):        # bounds that do not cover the rows
        length_sharded_align(["cpu"] * 2, *args, n1=21, n2=21,
                             bounds=[1, 10, 20])
    with pytest.raises(ValueError):        # an empty part
        length_sharded_align(["cpu"] * 2, *args, n1=21, n2=21,
                             bounds=[1, 1, 21])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):      # no CUDA device on this host
        length_sharded_align(["cuda:0"] * 2, *args, n1=21, n2=21)


def test_segment_wrappers_check_their_inputs():
    B, n, n2 = 2, 5, 9
    bufs = dp_kernels.segment_buffers(B, n, n2, "cpu")
    refs = torch.zeros((B, n), dtype=torch.uint8)
    reads = torch.zeros((B, n2 - 1), dtype=torch.uint8)
    lens = torch.full((B,), 3, dtype=torch.int32)
    halo = torch.zeros((B, 4, 3))
    kw = dict(n1=20, n2=n2, y0=1, y1=4)
    with pytest.raises(ValueError):        # a halo into the first part
        dp_kernels.fill_segment(refs, reads, lens, lens, _params(), halo,
                                bufs, row0=1, **kw)
    with pytest.raises(ValueError):        # no halo into a later part
        dp_kernels.fill_segment(refs, reads, lens, lens, _params(), None,
                                bufs, row0=6, **kw)
    with pytest.raises(ValueError):        # a tile past the columns
        dp_kernels.fill_segment(refs, reads, lens, lens, _params(), None,
                                bufs, row0=1, n1=20, n2=n2, y0=5, y1=10)
    with pytest.raises(ValueError):        # rows past n1 - 1
        dp_kernels.fill_segment(refs, reads, lens, lens, _params(), halo,
                                bufs, row0=17, **kw)
    state = torch.full((B, 4), -1, dtype=torch.int32)
    with pytest.raises(ValueError):        # ops of the wrong width
        dp_kernels.walk_segment(bufs, lens, lens, _params(), state,
                                torch.zeros((B, 5), dtype=torch.uint8),
                                row0=1, n1=20, n2=n2)
