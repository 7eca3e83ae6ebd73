"""The hand-written CUDA kernels (the fused global fill + walk in every
mode, the fused local fill + walk, the fused Hamming hit search, edit
distance, the edit-hit search, the pair-HMM forward recurrence and the
wavefront fills with and without the fused walk, and the midpoint fill
of the bialign engine) against their plain PyTorch versions, on CUDA
tensors, and the paths that run them (align_reads with a band, with long
reads and under the wavefront engines, the inversion batch, WfaAligner,
the bialign engine and the wavefront screen) against the CPU. The fused
kernel is held to walk_reference(fill_reference(...)): its fused rows,
and its traceback laid out as fill_reference's.
Needs an NVIDIA GPU with nvcc; run there with

    python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (the `cuda` fixture decides, at run time).
Tolerance: exact equality of every byte (all DP decisions are exact, and
the tag distances are integers), except the pair-HMM log-likelihoods
(rtol 1e-5, atol 1e-3: see HMM_RTOL).
"""

import os

import numpy as np
import pytest
import torch

from clique_tpu_torch.align import batch as tbatch
from clique_tpu_torch.align import dp_kernels
from clique_tpu_torch.align.pipeline import MERGE_SCORING, RUST_BIO_COMPAT
from clique_tpu_torch.align.scoring import AffineScoring

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = np.frombuffer(b"ACGTACGTACGTN0129", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(seed, B, n1, n2, uniform):
    rng = np.random.default_rng(seed)
    rows = 1 if uniform else B
    refs = np.zeros((rows, n1 - 1), np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    ref_lens = rng.integers(1, n1, B).astype(np.int32)
    read_lens = rng.integers(1, n2, B).astype(np.int32)
    ref_lens[0], read_lens[0] = 1, n2 - 1
    ref_lens[1], read_lens[1] = n1 - 1, 1
    if uniform:
        ref_lens[:] = ref_lens[2]
    for i in range(rows):
        refs[i, :ref_lens[i]] = rng.choice(ALPHABET, ref_lens[i])
    for i in range(B):
        reads[i, :read_lens[i]] = rng.choice(ALPHABET, read_lens[i])
    return refs, reads, ref_lens, read_lens


def _check_align(args, params, n1, n2, **kw):
    """One dp_align launch against the plain fill + walk: the fused rows,
    and the kernel's traceback laid out as fill_reference's, byte for
    byte. Returns the kernel's outputs."""
    launches = dp_kernels.align_launches
    fused_k, wave = dp_kernels.dp_align(*args, params, n1=n1, n2=n2,
                                        return_traceback=True, **kw)
    torch.cuda.synchronize()
    assert dp_kernels.align_launches == launches + 1
    tb_p, corner_p = tbatch.fill_reference(*args, params, n1=n1, n2=n2, **kw)
    _res, fused_p = tbatch.walk_reference(tb_p, corner_p, args[2], args[3],
                                          n1=n1, n2=n2)
    assert torch.equal(tbatch.wavefront_to_tb(wave, args[2], args[3], n1=n1,
                                              n2=n2), tb_p)
    assert torch.equal(fused_k, fused_p)
    return fused_k, wave


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
@pytest.mark.parametrize("shape", [(16, 128, 128), (12, 128, 384),
                                   (8, 1536, 256), (4, 4096, 128),
                                   (6, 128, 3968), (6, 3968, 128),
                                   (1024, 384, 384)],
                         ids=str)
@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
def test_kernels_match_plain(cuda, special_mode, shape, uniform):
    """dp_align in the full band: ragged rows, one reference row or one a
    read, row bands (n1 > 385), the anchored path's long, thin buckets and
    the bench shape."""
    B, n1, n2 = shape
    host = _inputs(sum(shape) + int(uniform), B, n1, n2, uniform)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    scoring = MERGE_SCORING if special_mode == "both" else RUST_BIO_COMPAT
    params = tbatch.scoring_to_params(scoring, cuda)
    bands = dp_kernels.fill_mode_launches["row_bands"]
    _check_align(args, params, n1, n2, special_mode=special_mode)
    assert dp_kernels.fill_mode_launches["row_bands"] - bands == int(n1 > 385)


def _modes_inputs(seed, B, n1, n2, uniform):
    """_inputs with a zero-length read and a zero-length reference row."""
    refs, reads, ref_lens, read_lens = _inputs(seed, B, n1, n2, uniform)
    read_lens[2] = 0
    reads[2] = 0
    if not uniform and B > 3:
        ref_lens[3] = 0
        refs[3] = 0
    return refs, reads, ref_lens, read_lens


def _band_args(ref_lens, read_lens, n1, width, dev):
    bw = np.minimum(np.maximum(ref_lens, np.maximum(read_lens, 1)),
                    np.int32(width)).astype(np.int32)
    centers = tbatch.band_centers_f64(ref_lens, read_lens, n1)
    return dict(bandwidth=torch.from_numpy(bw).to(dev),
                band_centers=torch.from_numpy(centers).to(dev))


FILL_MODES = {
    "banded": dict(special_mode="ref_n_only", width=16),
    "none_last": dict(special_mode="none", tie_order="last"),
    "both_last": dict(special_mode="both", tie_order="last"),
    "banded_none_last": dict(special_mode="none", tie_order="last",
                             width=7),
}


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
@pytest.mark.parametrize("shape", [(16, 128, 128), (12, 128, 384),
                                   (6, 1536, 256), (40, 1001, 1001)],
                         ids=str)
@pytest.mark.parametrize("mode", list(FILL_MODES))
def test_fill_modes_match_plain(cuda, mode, shape, uniform):
    """dp_align's banded, keep-last and "none" modes (the inversion path's
    keep-last shape, n1 = n2 = 1001, among them), with zero-length rows."""
    B, n1, n2 = shape
    kw = dict(FILL_MODES[mode])
    width = kw.pop("width", None)
    host = _modes_inputs(sum(shape) + 3, B, n1, n2, uniform)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    if width is not None:
        kw.update(_band_args(host[2], host[3], n1, width, cuda))
    params = tbatch.scoring_to_params(MERGE_SCORING, cuda)
    modes = dict(dp_kernels.fill_mode_launches)
    _check_align(args, params, n1, n2, **kw)
    for mode_name, on in (("banded", width is not None),
                          ("tie_last", kw.get("tie_order") == "last"),
                          ("special_none", kw["special_mode"] == "none")):
        assert (dp_kernels.fill_mode_launches[mode_name] - modes[mode_name]
                == int(on)), mode_name


def _check_local(args, params, n1, n2, **kw):
    """One dp_align_local launch against the plain fill + walk: the fused
    rows, and the kernel's one-byte traceback decoded as
    fill_local_reference's (zero flags on interior cells, directions where
    a plane's flag is clear), byte for byte."""
    launches = dp_kernels.align_local_launches
    fused_k, wave = dp_kernels.dp_align_local(*args, params, n1=n1, n2=n2,
                                              return_traceback=True, **kw)
    torch.cuda.synchronize()
    assert dp_kernels.align_local_launches == launches + 1
    tb_p, zf_p, best_p, xd_p = tbatch.fill_local_reference(
        *args, params, n1=n1, n2=n2, **kw)
    _res, fused_p = tbatch.walk_local_reference(tb_p, zf_p, best_p, xd_p,
                                                n1=n1, n2=n2)
    lens = dict(ref_lens=args[2], read_lens=args[3], n1=n1, n2=n2)
    got = tbatch.local_wavefront_to_tb(wave, **lens)
    want = tbatch.local_wavefront_to_tb(
        tbatch.local_tb_to_wavefront(tb_p, zf_p, **lens), **lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(fused_k, fused_p)


@pytest.mark.parametrize("uniform", [False, True], ids=["per_row", "uniform"])
@pytest.mark.parametrize("shape", [(16, 128, 128), (12, 128, 384),
                                   (6, 1536, 256), (4, 3328, 3328),
                                   (1, 3328, 3328)], ids=str)
@pytest.mark.parametrize("special_mode", ["both", "ref_n_only"])
def test_local_kernels_match_plain(cuda, special_mode, shape, uniform):
    """dp_align_local (the fused local fill and walk): the fused rows with
    their coordinates, the traceback and the zero flags; a uniform batch
    sends one reference row, as the inversion screen does; one CTA at
    n1 = n2 = 3328."""
    B, n1, n2 = shape
    seed = sum(shape) + 5 + int(uniform)
    if B == 1:
        # one full-length read that copies its reference with 2%
        # substitutions: a walk through every band of the CTA
        rng = np.random.default_rng(seed)
        refs = rng.choice(ALPHABET[:4], (1, n1 - 1))
        reads = refs.copy()
        subs = rng.random(n2 - 1) < 0.02
        reads[0, subs] = rng.choice(ALPHABET[:4], int(subs.sum()))
        host = (refs, reads, np.array([n1 - 1], np.int32),
                np.array([n2 - 1], np.int32))
    else:
        host = _modes_inputs(seed, B, n1, n2, uniform)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    params = tbatch.scoring_to_params(AffineScoring(10.0, -11.0, 8.0, -15.0,
                                                    -5.0, 1.0), cuda)
    bands = dp_kernels.fill_mode_launches["local_row_bands"]
    _check_local(args, params, n1, n2, special_mode=special_mode)
    assert (dp_kernels.fill_mode_launches["local_row_bands"] - bands
            == int(n1 > 385))


@pytest.mark.parametrize("case", ["gap_plane_zero", "all_mismatch",
                                  "empty_rows", "tied_hits"])
def test_local_kernel_encoding_cases(cuda, case):
    """The one-byte encoding's cases of the CPU tests on the card: walks
    that stop in D or I, an argmax at (0, 0), empty rows, tied hits."""
    from test_torch_align_modes import local_case

    *host, params = local_case(case)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in host]
    n1, n2 = host[0].shape[1] + 1, host[1].shape[1] + 1
    _check_local(args, torch.tensor(params, device=cuda), n1, n2)


def test_local_kernel_empty_batch(cuda):
    """B = 0: empty fused rows and traceback of the right widths, and no
    launch."""
    n1, n2 = 1001, 900
    refs = torch.zeros((1, n1 - 1), dtype=torch.uint8, device=cuda)
    reads = torch.zeros((0, n2 - 1), dtype=torch.uint8, device=cuda)
    lens = torch.zeros(0, dtype=torch.int32, device=cuda)
    params = tbatch.scoring_to_params(MERGE_SCORING, cuda)
    launches = dp_kernels.align_local_launches
    fused, wave = dp_kernels.dp_align_local(refs, reads, lens, lens, params,
                                            n1=n1, n2=n2,
                                            return_traceback=True)
    assert tuple(fused.shape) == (0, 24 + -(-(n1 + n2) // 4))
    assert tuple(wave.shape) == (0, tbatch.traceback_bytes(n1, n2))
    assert dp_kernels.align_local_launches == launches


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_fill_beyond_6144_rows(cuda, local):
    """n1 = 6,600 DP rows: 18 row bands, handed on through a scratch row
    band to band (the global kernel one after another on one warp, the
    local one on the 10 warps of its CTA, bands 10-17 wrapping to the
    first warps), and both still equal their plain versions."""
    B, n1, n2 = 3, 6600, 700
    host = _modes_inputs(6600, B, n1, n2, False)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    params = tbatch.scoring_to_params(MERGE_SCORING, cuda)
    if not local:
        bands = dp_kernels.fill_mode_launches["row_bands"]
        _check_align(args, params, n1, n2, special_mode="both")
        assert dp_kernels.fill_mode_launches["row_bands"] == bands + 1
        return
    bands = dp_kernels.fill_mode_launches["local_row_bands"]
    _check_local(args, params, n1, n2)
    assert dp_kernels.fill_mode_launches["local_row_bands"] == bands + 1


def test_inversion_batch_on_cuda_equals_cpu(cuda):
    from clique_tpu_torch.align.inversion import inversion_alignment_batch
    from clique_tpu_torch.align.scoring import InversionScoring
    from clique_tpu_torch.utils.seq import reverse_complement

    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, 300).tobytes()
    reads = []
    for i in range(40):
        r = bytearray(ref)
        for _k in range(6):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(bases))
        reads.append(bytes(r))
    reads[7] = ref[:100] + reverse_complement(ref[100:150]) + ref[150:]
    names = [f"r{i}" for i in range(len(reads))]
    inv = InversionScoring(10.0, -11.0, -15.0, -5.0, -2.0, 30)
    # the HiFi scoring keeps local hits of unrelated sequence short: read 7
    # is the one screen positive, the others take the keep-last fill
    aff = AffineScoring.hifi_default()
    screens = dp_kernels.align_local_launches
    keep_last = dp_kernels.fill_mode_launches["tie_last"]
    got = inversion_alignment_batch(ref, reads, "ref", names, inv, aff,
                                    device="cuda")
    assert dp_kernels.align_local_launches == screens + 1
    assert dp_kernels.fill_mode_launches["tie_last"] == keep_last + 1
    want = inversion_alignment_batch(ref, reads, "ref", names, inv, aff,
                                     device="cpu")
    assert got == want
    assert "<" in [op for _c, op in got[7].cigar]


@pytest.mark.parametrize("option", ["bandwidth", "anchored"])
def test_align_reads_modes_on_cuda_equal_cpu(cuda, option, tmp_path):
    """align_reads with a partial band, and with long reads on the
    anchored path, gives the same BAM on the card as on the CPU."""
    from test_torch_align_anchored import _long_layout, _mutate
    from test_torch_align_pipeline import _bench_shaped, _inflate_bgzf

    from clique_tpu_torch.align.pipeline import align_reads

    if option == "bandwidth":
        layout, rm, fq = _bench_shaped(tmp_path, n_reads=128)
        kw = dict(bandwidth=12)
    else:
        rng = np.random.default_rng(44)
        ref, layout, rm = _long_layout(tmp_path, 2600, rng)
        fq = str(tmp_path / "long.fastq")
        with open(fq, "w") as fh:
            for i in range(6):
                r = _mutate(rng, ref.encode(), 40, 8).decode()
                fh.write(f"@long{i}\n{r}\n+\n{'I' * len(r)}\n")
        kw = dict(anchored_min_length=1024)
    outs = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.bam")
        launches = dp_kernels.align_launches
        align_reads(layout, rm, out, read1=fq, batch_size=32, device=device,
                    **kw)
        assert (dp_kernels.align_launches > launches) == (device == "cuda")
        outs[device] = _inflate_bgzf(out)
    assert outs["cuda"] == outs["cpu"]


def test_wrappers_reject_mixed_devices(cuda):
    host = _inputs(5, 4, 128, 128, False)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    params = tbatch.scoring_to_params(RUST_BIO_COMPAT, "cpu")
    with pytest.raises(ValueError):
        dp_kernels.dp_align(*args, params, n1=128, n2=128,
                            special_mode="both")


def test_align_reads_golden_on_cuda(cuda, tmp_path):
    from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                           _load_make_golden)

    from clique_tpu_torch.align.pipeline import align_reads

    gd, layout, rm, _r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                              tmp_path)
    out = str(tmp_path / "aligned.bam")
    align_reads(layout, rm, out, read1=os.path.join(gd, "reads.fastq.gz"),
                batch_size=16, device="cuda")
    assert _inflate_bgzf(out) == _inflate_bgzf(os.path.join(gd,
                                                            "aligned.bam"))


def test_out_of_range_lengths_are_marked(cuda):
    """The kernel marks a row whose lengths lie outside the bucket (n_ops
    -1, NaN score, no ops, no traceback), check_marked_rows raises on it as
    the plain versions raise at call time, and the other rows equal the
    plain versions' bytes."""
    n1 = n2 = 128
    host = list(_inputs(11, 6, n1, n2, False))
    bad_ref, bad_read = host[2].copy(), host[3].copy()
    bad_ref[2], bad_read[4] = n1, -1
    args = [torch.from_numpy(a).to(cuda)
            for a in (host[0], host[1], bad_ref, bad_read)]
    params = tbatch.scoring_to_params(MERGE_SCORING, cuda)
    fused, wave = dp_kernels.dp_align(*args, params, n1=n1, n2=n2,
                                      special_mode="both",
                                      return_traceback=True)
    torch.cuda.synchronize()
    packed, n_ops, score = tbatch.unfuse_result(fused.cpu().numpy())
    assert n_ops[2] == n_ops[4] == -1
    assert np.isnan(score[2]) and np.isnan(score[4])
    assert (packed[[2, 4]] == 0xFF).all()
    tb = tbatch.wavefront_to_tb(wave, args[2], args[3], n1=n1, n2=n2)
    assert (tb[[2, 4]] == tbatch._TB_FRESH).all()
    with pytest.raises(ValueError, match="outside their bucket"):
        tbatch.check_marked_rows(n_ops)
    with pytest.raises(ValueError):
        tbatch.fill_reference(*args, params, n1=n1, n2=n2,
                              special_mode="both")

    good = [0, 1, 3, 5]
    ok = [t[good].contiguous() for t in args]
    tb_p, corner_p = tbatch.fill_reference(ok[0] if ok[0].shape[0] > 1
                                           else args[0], *ok[1:], params,
                                           n1=n1, n2=n2, special_mode="both")
    _res, fused_p = tbatch.walk_reference(tb_p, corner_p, ok[2], ok[3],
                                          n1=n1, n2=n2)
    assert torch.equal(tb[good], tb_p)
    assert torch.equal(fused[good], fused_p)


TAG_ALPHABET = np.frombuffer(b"ACGTN-", dtype=np.uint8)


MANY = b"ACGTNRYKMSWBDHVacgtn"       # 20 byte classes
# name: (U, K, L, d, allowlist letters, substitution letters); the names
# give the code width and the row words pack_hit_inputs picks
HIT_CASES = {
    "one_pair": (1, 1, 16, 1, b"ACGT", b"ACGT"),
    "acgt_l16_1word": (2048, 3000, 16, 1, b"ACGT", b"ACGT"),
    "acgt_foreign_tag_bytes": (700, 5000, 16, 2, b"ACGT", b"N-"),
    "acgt_l20_2words": (300, 1001, 20, 2, b"ACGT", b"ACGTN"),
    "acgt_l64_4words": (300, 1001, 64, 3, b"ACGT", b"ACGT-"),
    "acgt_l128_8words": (130, 777, 128, 4, b"ACGT", b"ACGT"),
    "acgt_l129_wide": (130, 777, 129, 4, b"ACGT", b"ACGTN"),
    "six_l16_4bit": (500, 3001, 16, 1, b"ACGTN-", b"ACGTN-"),
    "six_l12_exact": (37, 91, 12, 0, b"ACGTN-", b"ACGTN-"),
    "many_l16_8bit": (500, 2000, 16, 2, MANY, MANY),
    "many_l24_8words": (200, 999, 24, 3, MANY, MANY),
    "many_l255_wide": (129, 515, 255, 30, MANY, MANY),
    "six_l300_d50": (60, 300, 300, 50, b"ACGTN-", b"ACGTN-"),
    "six_l300_d20_need_over_255": (60, 300, 300, 20, b"ACGTN-", b"ACGTN-"),
    "many_tags": (70000, 20, 8, 1, b"ACGT", b"ACGTN"),
    "every_pair_relaunch": (300, 1000, 8, 8, b"ACGT", b"ACGT"),
}


def _hit_inputs(name, device):
    U, K, L, d, letters, noise = HIT_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    letters = np.frombuffer(letters, np.uint8)
    noise = np.frombuffer(noise, np.uint8)
    allow = rng.choice(letters, (K, L))
    tags = rng.choice(letters, (U, L))
    pick = rng.integers(0, K, len(tags[::2]))
    tags[::2] = allow[pick]
    for u in range(0, U, 2):           # 0 to d + 1 substitutions
        cols = rng.integers(0, L, int(rng.integers(0, d + 2)))
        tags[u, cols] = rng.choice(noise, len(cols))
    return (torch.from_numpy(tags).to(device),
            torch.from_numpy(allow).to(device), d)


@pytest.mark.parametrize("name", list(HIT_CASES))
def test_match_hits_kernel_matches_plain(cuda, name):
    from clique_tpu_torch.collapse import distance as tdist

    t, a, d = _hit_inputs(name, cuda)
    U, L = t.shape
    K = a.shape[0]
    n = tdist.match_hits_launches
    u, k = tdist.match_hits(t, a, d)
    torch.cuda.synchronize()
    launches = tdist.match_hits_launches - n
    want_u, want_k = tdist.match_hits_reference(t, a, d)
    assert torch.equal(u, want_u) and torch.equal(k, want_k)
    if L - d > 255:
        assert launches == 0 and len(u) == 0
    elif U * K > max(4 * U, 1 << 16) and len(u) > max(4 * U, 1 << 16):
        assert launches == 2                  # the hit buffer overflowed
    else:
        assert launches == 1
    if name == "every_pair_relaunch":
        assert len(u) == U * K


@pytest.mark.parametrize("L", [8, 16, 32, 33, 64, 65, 80, 128, 129, 192,
                               193, 200, 256, 257, 300, 1000])
def test_edit_distance_kernel_matches_plain(cuda, L):
    """Every width where the kernel's words change (32-bit, one to four
    64-bit words, bands of 256 past that), rows holding every byte value
    (the zero padding included), P not a multiple of a warp's 32."""
    from clique_tpu_torch.collapse import distance as tdist

    rng = np.random.default_rng(L)
    P = 3001
    a = rng.choice(TAG_ALPHABET, (P, L))
    a[P // 2:] = rng.integers(0, 256, a[P // 2:].shape, dtype=np.uint8)
    a.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    b = a.copy()
    b[rng.random((P, L)) < 0.1] = ord("A")
    b[::7] = rng.choice(TAG_ALPHABET, b[::7].shape)
    b[1::9] = rng.integers(0, 256, b[1::9].shape, dtype=np.uint8)
    la = rng.integers(0, L + 1, P).astype(np.int32)
    lb = np.clip(la + rng.integers(-3, 4, P), 0, L).astype(np.int32)
    la[0], lb[1], la[2], lb[2] = 0, 0, 0, 0
    la[3], lb[3] = L, L
    args = [torch.from_numpy(x).to(cuda) for x in (a, b, la, lb)]
    n = tdist.edit_distance_launches
    got = tdist.edit_distance(*args)
    torch.cuda.synchronize()
    assert tdist.edit_distance_launches == n + 1
    assert torch.equal(got, tdist.edit_distance_reference(*args))
    if L <= 64:
        assert np.array_equal(got.cpu().numpy(),
                              tdist._edit_distance_myers_host(a, b, la, lb))


@pytest.mark.parametrize("L", [32, 300, 1000])
def test_edit_distance_kernel_allocates_no_scratch(cuda, L):
    """The wrapper allocates the output and its length check's
    temporaries, nothing that grows with L (the DP kernel's u8 scratch was
    P * (L + 1) bytes past 256)."""
    from clique_tpu_torch.collapse import distance as tdist

    P = 4096
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.integers(0, 256, (P, L), dtype=np.uint8)).to(
        cuda)
    la = torch.full((P,), L, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    got = tdist.edit_distance(a, a.flip(0).contiguous(), la, la)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < 16 * P + 16384 \
        + a.numel()                                   # the flipped copy
    assert torch.equal(got, tdist.edit_distance_reference(
        a, a.flip(0).contiguous(), la, la))


@pytest.mark.parametrize("source", ["triu", "count_filtered", "explicit"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("w", [12, 16, 33, 64])
def test_edit_hits_kernel_matches_plain(cuda, w, d, source):
    from test_torch_collapse_edit_hits import _matrix, edit_hit_case

    from clique_tpu_torch.collapse import distance as tdist

    groups, pairs = edit_hit_case(source, w, d)
    args = [x.to(cuda) for x in _matrix(groups)]
    pairs = pairs.to(cuda) if pairs is not None else None
    n = tdist.edit_hits_launches
    h, j = tdist.edit_hits(*args, d, 5.0, pairs)
    torch.cuda.synchronize()
    assert tdist.edit_hits_launches == n + 1
    want_h, want_j = tdist.edit_hits_reference(*args, d, 5.0, pairs)
    assert torch.equal(h, want_h) and torch.equal(j, want_j)
    assert len(h) >= 10


@pytest.mark.parametrize("w", [16, 40])
def test_edit_hits_kernel_tiles_and_many_groups(cuda, w):
    """A group of 4,000 tags (2 to 8 shared-memory tiles of partners) and
    300 groups of 2-20 tags in one launch."""
    from clique_tpu_torch.collapse import distance as tdist

    rng = np.random.default_rng(w)
    sizes = [4000] + rng.integers(2, 21, 300).tolist()
    T = sum(sizes)
    base = rng.choice(TAG_ALPHABET[:4], (64, w))
    tags = base[rng.integers(0, 64, T)]
    sub = rng.random((T, w)) < 0.08
    tags[sub] = rng.choice(TAG_ALPHABET, int(sub.sum()))
    cnt = np.where(rng.random(T) < 0.1, rng.integers(5, 60, T),
                   rng.integers(1, 5, T)).astype(np.int64)
    offs = np.concatenate(([0], np.cumsum(sizes))).astype(np.int32)
    widths = np.full(len(sizes), w, np.int32)
    widths[1::3] = w - 3
    args = [torch.from_numpy(x).to(cuda) for x in (tags, cnt, offs, widths)]
    n = tdist.edit_hits_launches
    h, j = tdist.edit_hits(*args, 2, 5.0)
    torch.cuda.synchronize()
    assert tdist.edit_hits_launches == n + 1
    want_h, want_j = tdist.edit_hits_reference(*args, 2, 5.0)
    assert torch.equal(h, want_h) and torch.equal(j, want_j)
    assert len(h) >= 100


def test_edit_hits_kernel_relaunches_past_its_buffer(cuda):
    """600 tags of count 10 and 600 of count 1 with the radius at the
    width: all 360,000 ratio pairs are hits, past the first buffer of
    max(4 T, 65,536) pairs, so the wrapper launches twice."""
    from clique_tpu_torch.collapse import distance as tdist

    rng = np.random.default_rng(13)
    tags = torch.from_numpy(rng.choice(TAG_ALPHABET[:4], (1200, 16))).to(cuda)
    cnt = torch.tensor([10] * 600 + [1] * 600, device=cuda)
    offs = torch.tensor([0, 1200], dtype=torch.int32, device=cuda)
    widths = torch.tensor([16], dtype=torch.int32, device=cuda)
    n = tdist.edit_hits_launches
    h, j = tdist.edit_hits(tags, cnt, offs, widths, 16, 5.0)
    torch.cuda.synchronize()
    assert tdist.edit_hits_launches == n + 2
    assert len(h) == 360_000
    want_h, want_j = tdist.edit_hits_reference(tags, cnt, offs, widths, 16,
                                               5.0)
    assert torch.equal(h, want_h) and torch.equal(j, want_j)


def test_correct_degenerate_groups_edit_hits_on_cuda_equals_cpu(
        cuda, monkeypatch):
    from test_torch_collapse_edit_hits import _correction_groups, _wide_group

    from clique_tpu_torch.collapse import correct as tcorrect
    from clique_tpu_torch.collapse import distance as tdist

    groups = _correction_groups(32, 16, 2) + [_wide_group(18, 2)]
    monkeypatch.setattr(tcorrect, "EDIT_HITS_MIN_PAIRS", 0)
    want = tcorrect.correct_degenerate_groups(groups, 2, 16, 5.0,
                                              device="cpu")
    n = tdist.edit_hits_launches, tdist.edit_distance_launches
    got = tcorrect.correct_degenerate_groups(groups, 2, 16, 5.0,
                                             device="cuda")
    # the small groups, the big group's candidates, the 80-byte group
    assert (tdist.edit_hits_launches - n[0],
            tdist.edit_distance_launches - n[1]) == (2, 1)
    assert got == want


def test_hamming_hits_on_cuda_equals_cpu(cuda):
    from clique_tpu_torch.collapse import distance as tdist

    rng = np.random.default_rng(4)
    allow = [rng.choice(TAG_ALPHABET[:4], 16).tobytes() for _ in range(5000)]
    tags = [bytes(bytearray(allow[i])[:15]) + b"N" for i in range(0, 5000, 7)]
    tags += [rng.choice(TAG_ALPHABET, 16).tobytes() for _ in range(300)]
    want = tdist.hamming_hits(tags, allow, 2, device="cpu", chunk_u=256,
                              chunk_k=1024)
    n = tdist.match_hits_launches
    got = tdist.hamming_hits(tags, allow, 2, device="cuda", chunk_u=256,
                             chunk_k=1024)
    assert tdist.match_hits_launches == n + 1      # one launch a call
    assert got == want
    assert sum(map(len, got)) >= 5000 // 7


def test_collapse_golden_on_cuda(cuda, tmp_path):
    from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                           _load_make_golden)

    from clique_tpu_torch.caller.events import call_events_from_bam
    from clique_tpu_torch.collapse import distance as tdist
    from clique_tpu_torch.collapse.pipeline import collapse

    gd, layout, _rm, _r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                               tmp_path)
    out = str(tmp_path / "collapsed.bam")
    n = tdist.match_hits_launches
    collapse(out, layout, os.path.join(gd, "aligned.bam"), device="cuda")
    assert tdist.match_hits_launches > n
    assert _inflate_bgzf(out) == _inflate_bgzf(os.path.join(gd,
                                                            "collapsed.bam"))
    tsv = str(tmp_path / "alleles.tsv")
    call_events_from_bam(layout, out, tsv, min_read_count=1)
    with open(tsv) as f1, open(os.path.join(gd, "alleles.tsv")) as f2:
        assert f1.read() == f2.read()


# --- the pair-HMM forward kernel (csrc/hmm_forward.cu) -----------------------
# Tolerance: rtol 1e-5 and atol 1e-3 on log-likelihoods of -10^1 to -10^4.
# Both versions take the same f32 terms and the JAX package's order of
# operations; CUDA's precise expf / logf are within 1-2 ulp of PyTorch's,
# and those ulps accumulate over a pair's cells.

HMM_RTOL, HMM_ATOL = 1e-5, 1e-3


def _hmm_pairs(seed, B, n1, n2):
    rng = np.random.default_rng(seed)
    refs = rng.choice(ALPHABET, (B, n1 - 1)).astype(np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    l1 = rng.integers(0, n1, B).astype(np.int32)
    l2 = rng.integers(0, n2, B).astype(np.int32)
    for i in range(B):
        src = refs[i, :min(l1[i], n2 - 1)].copy()
        sub = rng.random(len(src)) < 0.08
        src[sub] = rng.choice(np.frombuffer(b"ACGTN", np.uint8), sub.sum())
        reads[i, :len(src)] = src
        reads[i, len(src):] = rng.choice(ALPHABET, n2 - 1 - len(src))
    l1[0], l2[0] = n1 - 1, n2 - 1
    if B > 4:
        l1[1], l2[2] = 0, 0
        l1[3] = l2[3] = 0
    return refs, reads, l1, l2


@pytest.mark.parametrize("shape", [
    (64, 251, 251), (1024, 251, 251), (5, 6601, 64), (1, 2, 2), (33, 385, 40),
    (7, 40, 1200),
], ids=["B64", "B1024", "rows_6600", "one_cell", "two_bands", "long_reads"])
def test_hmm_forward_kernel_matches_plain(cuda, shape):
    from clique_tpu_torch.align import hmm as thmm

    B, n1, n2 = shape
    args = [torch.from_numpy(a).to(cuda) for a in _hmm_pairs(5, B, n1, n2)]
    p = torch.from_numpy(thmm.default_hmm_params()).to(cuda)
    n = thmm.hmm_forward_launches
    got = thmm.hmm_forward_batch(*args, p)
    torch.cuda.synchronize()
    assert thmm.hmm_forward_launches == n + 1
    want = thmm.hmm_forward_batch_reference(*args, p)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=HMM_RTOL, atol=HMM_ATOL)


def _hmm_edge_pairs(seed, B, l1, l2):
    """B pairs at (l1, l2) but two (one at l1 // 2 rows, one at l2 // 2
    columns), reference bytes with N and digit wildcards, reads from their
    reference with 8% substitutions (N among them); rows padded to l1 and
    max(l2, 1) bytes."""
    rng = np.random.default_rng(seed)
    refs = rng.choice(ALPHABET, (B, l1)).astype(np.uint8)
    reads = rng.choice(ALPHABET, (B, max(l2, 1))).astype(np.uint8)
    k = min(l1, l2)
    reads[:, :k] = refs[:, :k]
    sub = rng.random((B, k)) < 0.08
    reads[:, :k][sub] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                   int(sub.sum()))
    ref_lens = np.full(B, l1, np.int32)
    read_lens = np.full(B, l2, np.int32)
    ref_lens[5], read_lens[6] = l1 // 2, l2 // 2
    return refs, reads, ref_lens, read_lens


@pytest.mark.parametrize("l2", [0, 1, 230])
@pytest.mark.parametrize("l1", [1, 7, 8, 9, 255, 256, 257, 383, 384, 385,
                                1100])
def test_hmm_forward_strip_edges_equal_plain(cuda, l1, l2):
    """A launch of l1 reference rows at each strip height's edges: 8 rows
    a lane up to 256 rows, 12 at 257-384, 8 in two row bands at 385, 12 in
    three at 1,100; 37 pairs (no multiple of a CTA's 4 warps). Equal to
    the plain version on the card, bit for bit."""
    from clique_tpu_torch import _build
    from clique_tpu_torch.align import hmm as thmm

    rows = _build.load().clique_hmm_forward_strip_rows(l1 + 1)
    assert rows == (12 if l1 in (257, 383, 384, 1100) else 8)
    args = [torch.from_numpy(a).to(cuda)
            for a in _hmm_edge_pairs(l1 + l2, 37, l1, l2)]
    p = torch.from_numpy(thmm.default_hmm_params()).to(cuda)
    n = thmm.hmm_forward_launches
    got = thmm.hmm_forward_batch(*args, p)
    torch.cuda.synchronize()
    assert thmm.hmm_forward_launches == n + 1
    want = thmm.hmm_forward_batch_reference(*args, p)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_hmm_forward_panel_batch_equals_plain(cuda):
    """A panel-shaped launch: 40 reads against 24 references of one 230 bp
    backbone a 20 bp guide apart (960 pairs of 230 x ~230, the reads with
    5% substitutions and every third a 3-base deletion), bit for bit."""
    from clique_tpu_torch.align import hmm as thmm

    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    backbone = rng.choice(bases, 230)
    refs = np.repeat(backbone[None], 24, axis=0)
    refs[:, 100:120] = rng.choice(bases, (24, 20))
    reads = np.zeros((40, 230), np.uint8)
    read_lens = np.zeros(40, np.int32)
    for i in range(40):
        r = refs[i % 24].copy()
        sub = rng.random(230) < 0.05
        r[sub] = rng.choice(bases, int(sub.sum()))
        if i % 3 == 0:
            r = np.delete(r, [50, 51, 52])
        reads[i, :len(r)], read_lens[i] = r, len(r)
    qi, ri = np.repeat(np.arange(40), 24), np.tile(np.arange(24), 40)
    host = (refs[ri], reads[qi], np.full(960, 230, np.int32), read_lens[qi])
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in host]
    p = torch.from_numpy(thmm.default_hmm_params()).to(cuda)
    got = thmm.hmm_forward_batch(*args, p)
    want = thmm.hmm_forward_batch_reference(*args, p)
    assert torch.equal(got, want)
    assert (got.view(40, 24).argmax(1).cpu().numpy()
            == np.arange(40) % 24).all()


def test_hmm_forward_streamed_pairs_equal_plain(cuda):
    """More pairs than the card holds warps (2 x 64 an SM, + 37), so that
    every warp streams two pairs or more: seeded draws of twelve pairs in
    one launch of 6,600 rows and 300 columns, among them pairs in row
    bands (6,600, 5,000 with 30 columns, 1,100, 257 with 1 column), pairs
    with no interior cell (a length 0) and ordinary ones. Equal bit for
    bit to the plain version of the twelve, taken at the same widths."""
    from clique_tpu_torch.align import hmm as thmm

    rng = np.random.default_rng(12)
    shapes = [(6600, 250), (5000, 30), (1100, 300), (257, 1), (256, 230),
              (230, 230), (230, 0), (0, 200), (0, 0), (8, 300), (1, 1),
              (100, 300)]
    K, n1, n2 = len(shapes), 6601, 301
    refs = rng.choice(ALPHABET, (K, n1 - 1)).astype(np.uint8)
    reads = rng.choice(ALPHABET, (K, n2 - 1)).astype(np.uint8)
    for k, (l1, l2) in enumerate(shapes):
        n = min(l1, l2)
        src = refs[k, l1 - n:l1].copy()
        sub = rng.random(n) < 0.08
        src[sub] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                              int(sub.sum()))
        reads[k, :n] = src
    l1s = np.array([s[0] for s in shapes], np.int32)
    l2s = np.array([s[1] for s in shapes], np.int32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = 2 * 64 * sms + 37
    pick = rng.integers(0, K, B)
    args = [torch.from_numpy(np.ascontiguousarray(a[pick])).to(cuda)
            for a in (refs, reads, l1s, l2s)]
    p = torch.from_numpy(thmm.default_hmm_params()).to(cuda)
    got = thmm.hmm_forward_batch(*args, p)
    want = thmm.hmm_forward_batch_reference(
        *[torch.from_numpy(a).to(cuda) for a in (refs, reads, l1s, l2s)], p)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want[torch.from_numpy(pick).to(cuda)])


def test_hmm_forward_kernel_marks_bad_lengths(cuda):
    from clique_tpu_torch.align import hmm as thmm

    t = torch.full((3, 20), ord("A"), dtype=torch.uint8, device=cuda)
    l1 = torch.tensor([5, 21, 4], dtype=torch.int32, device=cuda)
    l2 = torch.tensor([5, 3, -1], dtype=torch.int32, device=cuda)
    p = torch.from_numpy(thmm.default_hmm_params()).to(cuda)
    got = thmm.hmm_forward_batch(t, t, l1, l2, p).cpu()
    assert torch.isfinite(got[0]) and torch.isnan(got[1:]).all()


def test_hmm_router_on_cuda_equals_cpu(cuda):
    """One launch a route call; the same routes as the CPU wherever a
    read's two best LLs differ by more than the tolerance."""
    from clique_tpu_torch.align import hmm as thmm

    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", np.uint8)
    backbone = rng.choice(bases, 230)
    refs = []
    for _ in range(24):
        r = backbone.copy()
        r[100:120] = rng.choice(bases, 20)
        refs.append(r.tobytes())
    reads = []
    for i in range(96):
        r = np.frombuffer(refs[i % 24], np.uint8).copy()
        sub = rng.random(len(r)) < 0.05
        r[sub] = rng.choice(bases, sub.sum())
        reads.append(r.tobytes())
    n = thmm.hmm_forward_launches
    got = thmm.HmmRouter(refs, device="cuda").route(reads)
    assert thmm.hmm_forward_launches == n + 1
    want = thmm.HmmRouter(refs, device="cpu").route(reads)
    assert [r for r, _ in got] == [r for r, _ in want]
    np.testing.assert_allclose([ll for _, ll in got], [ll for _, ll in want],
                               rtol=HMM_RTOL, atol=HMM_ATOL)
    assert sum(r == i % 24 for i, (r, _) in enumerate(got)) >= 90


def test_align_router_hmm_on_cuda_equals_cpu(cuda, tmp_path):
    """align_reads(router="hmm") over two references on the card gives
    the CPU's BAM, launching hmm_forward and dp_align."""
    from test_torch_align_pipeline import _bench_shaped, _inflate_bgzf

    from clique_tpu_torch.align import hmm as thmm
    from clique_tpu_torch.align.pipeline import align_reads

    layout, rm, fq = _bench_shaped(tmp_path, n_reads=96)
    outs = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.bam")
        n = (thmm.hmm_forward_launches, dp_kernels.align_launches)
        align_reads(layout, rm, out, read1=fq, batch_size=16, router="hmm",
                    device=device)
        if device == "cuda":
            assert thmm.hmm_forward_launches > n[0]
            assert dp_kernels.align_launches > n[1]
        outs[device] = _inflate_bgzf(out)
    assert outs["cuda"] == outs["cpu"]


def test_hmm_route_calls_in_flight_on_cuda(cuda, tmp_path):
    """A 20-reference guide panel through align_reads(router="hmm") at
    batch 16: four route calls, each launched while the one before was in
    flight, and the CPU's BAM. Then two calls in flight on the router's
    stream: collecting the first returns while the second's forward pass
    still runs, with the LLs of each call made alone."""
    import json

    from test_torch_align_pipeline import _guide_panel, _inflate_bgzf

    from clique_tpu_torch.align import hmm as thmm
    from clique_tpu_torch.align.pipeline import align_reads

    layout, rm, fq = _guide_panel(tmp_path, 20, 240)
    outs = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.bam")
        mpath = tmp_path / f"{device}.json"
        align_reads(layout, rm, out, read1=fq, batch_size=16, router="hmm",
                    device=device, metrics_path=str(mpath))
        m = json.loads(mpath.read_text())
        assert (m["route_calls"], m["route_calls_overlapped"]) == (4, 3)
        outs[device] = _inflate_bgzf(out)
    assert outs["cuda"] == outs["cpu"]

    refs = [r.sequence for r in rm.references.values()]
    rng = np.random.default_rng(5)
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
             for _ in range(16384)]
    first, second = reads[:1024], reads
    router = thmm.HmmRouter(refs, device="cuda")
    want = [router.pair_lls(r)[2].copy() for r in (first, second)]
    router.launch(first)
    router.launch(second)
    second_done = router._inflight[1][2][3]
    got_first = router.pair_lls(first)[2]
    assert not second_done.query()
    got_second = router.pair_lls(second)[2]
    assert second_done.query()
    assert (router.calls, router.calls_overlapped) == (4, 1)
    assert np.array_equal(got_first, want[0])
    assert np.array_equal(got_second, want[1])


def test_collapse_workers_on_cuda(cuda, tmp_path):
    """collapse with two workers on the card: the pin's bytes, the
    corrections launched in the main process, no worker with CUDA."""
    import json

    from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                           _load_make_golden)

    from clique_tpu_torch.collapse.pipeline import collapse

    gd, layout, _rm, _r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                               tmp_path)
    out = str(tmp_path / "collapsed.bam")
    collapse(out, layout, os.path.join(gd, "aligned.bam"),
             temp_dir=str(tmp_path), n_workers=2, device="cuda")
    assert _inflate_bgzf(out) == _inflate_bgzf(os.path.join(gd,
                                                            "collapsed.bam"))
    with open(out + ".collapse_metrics.json") as fh:
        m = json.load(fh)
    assert m["kernel_launches"]["match_hits"] > 0
    assert m["workers"] and not any(w["cuda_initialized"]
                                    for w in m["workers"])


def _wfa_pairs(seed, B, W):
    """B pairs of up to W bytes: substitutions and indels, long deletions,
    identical pairs, wildcard zones, one hopeless pair."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        L = int(rng.integers(8, W + 1))
        ref = rng.choice(bases, L)
        if i % 5 == 0 and L >= 9:
            ref[3:9] = np.frombuffer(b"012N45", np.uint8)
        read = ref.copy()
        if i % 4 == 0 and L > 20:
            cut = int(rng.integers(8, L // 2))
            read = np.concatenate([read[:5], read[5 + cut:]])
        elif i % 4 != 1:
            sub = rng.random(L) < 0.08
            read[sub] = rng.choice(bases, int(sub.sum()))
            if L > 12:
                d = int(rng.integers(1, L - 1))
                read = np.concatenate([read[:d], read[d + 2:]])
        a[i, :L], b[i, :len(read)] = ref, read
        la[i], lb[i] = L, len(read)
    a[-1, :40], b[-1, :40] = ord("A"), ord("C")
    la[-1] = lb[-1] = 40
    return a, b, la, lb


WFA_PEN = dict(x=4, o=6, e=2, o2=24, e2=1)


def _check_wfa(args, smax, model, pen=None, **kw):
    """wfa_align and wfa_score on the card against the plain fill, walk and
    replay: penalties, op-store rows up to each pair's penalty, skeletons,
    end rows, run words (the host replay's CIGARs, lane for lane),
    score-only penalties."""
    from clique_tpu_torch.align import wfa_kernels as wk

    pen = dict(WFA_PEN, **(pen or {}))
    n = (wk.wfa_align_launches, wk.wfa_score_launches)
    pen_, ops, fwd, fin, runs = wk.wfa_align(*args, smax=smax, model=model,
                                             **pen, **kw)
    adaptive = kw.pop("adaptive", None)
    sc = wk.wfa_score(*args, smax=smax, model=model, **pen, **kw)
    torch.cuda.synchronize()
    assert (wk.wfa_align_launches, wk.wfa_score_launches) == (n[0] + 1,
                                                              n[1] + 1)
    p_pen, p_ops = wk.wfa_fill_reference(*args, smax=smax, model=model,
                                         adaptive=adaptive, **pen, **kw)
    p_fwd, p_fin = wk.wfa_walk_reference(p_ops, p_pen, args[2] - args[3],
                                         model=model, **pen)
    assert torch.equal(pen_, p_pen)
    rows = torch.arange(smax + 1, device=pen_.device)[:, None] <= p_pen[None]
    assert bool(((ops == p_ops) | ~rows[:, :, None]).all())
    assert torch.equal(fwd, p_fwd) and torch.equal(fin, p_fin)
    p_runs = wk.wfa_runs_reference(
        *args, p_fwd, p_fin, wildcards=kw.get("wildcards", False),
        width=wk.runs_width(model, smax, pen["x"], pen["e"], pen["e2"]))
    _same_runs(runs, p_runs, fin)
    if adaptive is None:
        assert torch.equal(sc, p_pen)
    return pen_


def _same_runs(runs, p_runs, fin):
    """The card's run words equal the plain version's up to each walked
    lane's 0 (the words past it are not defined); other lanes' rows start
    with the 0."""
    assert runs.shape == p_runs.shape
    runs, p_runs = runs.cpu().numpy(), p_runs.cpu().numpy()
    for j, f in enumerate(fin.tolist()):
        k = int((p_runs[j] == 0).argmax()) if f == -1 else 0
        assert (runs[j, :k + 1] == p_runs[j, :k + 1]).all(), j


def _force_plan(monkeypatch, kinds=("align", "score"), **force):
    """The wfa_plan of every launch of these kinds with `force` (cluster=C,
    0 the global workspace); returns the list the plans go into."""
    from clique_tpu_torch.align import wfa_kernels as wk

    plans = []
    orig = getattr(wk.wfa_plan, "__wrapped__", wk.wfa_plan)

    def plan(*a, **kw):
        plans.append(orig(*a, **{**kw, **(force if a[0] in kinds else {})}))
        return plans[-1]

    plan.__wrapped__ = orig
    monkeypatch.setattr(wk, "wfa_plan", plan)
    return plans


@pytest.mark.parametrize("option", [
    dict(), dict(wildcards=True), dict(kband=6),
    dict(wildcards=True, adaptive=3), dict(smax=10),
], ids=["exact", "wildcards", "kband", "adaptive", "censored"])
@pytest.mark.parametrize("model", ["affine", "affine2p"])
def test_wfa_kernels_match_plain(cuda, model, option):
    kw = dict(option)
    smax = kw.pop("smax", 96)
    args = [torch.from_numpy(a).to(cuda) for a in _wfa_pairs(3, 64, 120)]
    pen = _check_wfa(args, smax, model, **kw)
    assert bool((pen > smax).any())


@pytest.mark.parametrize("model", ["affine", "affine2p"])
def test_wfa_kernels_bench_shape(cuda, model):
    """bench_extra.py's bench_wfa shape: 5%-substituted pairs at L = 512,
    smax 192."""
    rng = np.random.default_rng(3)
    refs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (512, 512))
    reads = refs.copy()
    sub = rng.random(reads.shape) < 0.05
    reads[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(sub.sum()))
    lens = np.full(512, 512, np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (refs, reads, lens, lens)]
    _check_wfa(args, 192, model)


def test_wfa_kernel_global_rings(cuda):
    """Rings past a cluster of 8 CTAs live in the global workspace: affine2p
    at the 1,024-ceiling rerun of an L = 384 bucket (K = 1,537) with a
    mismatch of 300, whose M rings keep 301 rows (311 rows in all, 242 KB
    a CTA of 8)."""
    from clique_tpu_torch.align import wfa_kernels as wk

    a, b, la, lb = _wfa_pairs(4, 32, 120)
    a = np.pad(a, ((0, 0), (0, 264)))
    b = np.pad(b, ((0, 0), (0, 264)))
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
            for v in (a, b, la, lb)]
    n = wk.wfa_global_ring_launches
    _check_wfa(args, 1024, "affine2p", pen=dict(x=300), wildcards=True)
    assert wk.wfa_global_ring_launches == n + 2


def test_wfa_kernel_affine2p_rerun_in_shared_memory(cuda, monkeypatch):
    """The same rerun shape at the default penalties: compact rings (M 26
    rows, I1 and D1 3, I2 and D2 2) fit shared memory, a cluster of 2
    CTAs a pair at B = 32."""
    from clique_tpu_torch.align import wfa_kernels as wk

    plans = _force_plan(monkeypatch)
    a, b, la, lb = _wfa_pairs(4, 32, 120)
    a = np.pad(a, ((0, 0), (0, 264)))
    b = np.pad(b, ((0, 0), (0, 264)))
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
            for v in (a, b, la, lb)]
    n = wk.wfa_global_ring_launches
    _check_wfa(args, 1024, "affine2p", wildcards=True)
    assert wk.wfa_global_ring_launches == n
    assert [(p.C, p.grid) for p in plans] == [(2, 0), (2, 0)]


@pytest.mark.parametrize("B", [1, 32, 64])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_wfa_kernels_every_cluster_size(cuda, monkeypatch, C, B):
    """wfa_align and wfa_score (both models) with C CTAs a pair at B = 1,
    32 and 64 (one diagonal slice a CTA, halos in the neighbours' shared
    memory), and wfa_mid at those batches."""
    plans = _force_plan(monkeypatch, cluster=C)
    host = _wfa_pairs(20 + B, max(B, 2), 120)
    args = [torch.from_numpy(np.ascontiguousarray(v[:B])).to(cuda)
            for v in host]
    for model in ("affine", "affine2p"):
        _check_wfa(args, 96, model, wildcards=True)
    _check_mid(args, smax=96, wildcards=True)
    assert {p.C for p in plans if p.grid == 0} == {C}
    assert sum(p.grid > 0 for p in plans) == 1      # wfa_mid's


@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("option", [
    dict(), dict(wildcards=True), dict(kband=6),
    dict(wildcards=True, adaptive=3), dict(smax=10),
], ids=["exact", "wildcards", "kband", "adaptive", "censored"])
def test_wfa_kernels_options_under_a_cluster(cuda, monkeypatch, option, C):
    """The heuristic band, the wf-adaptive trim (its maximum taken over the
    cluster), censoring and wildcards with 2 and 8 CTAs a pair."""
    plans = _force_plan(monkeypatch, cluster=C)
    kw = dict(option)
    smax = kw.pop("smax", 96)
    args = [torch.from_numpy(a).to(cuda) for a in _wfa_pairs(3, 64, 120)]
    for model in ("affine", "affine2p"):
        pen = _check_wfa(args, smax, model, **kw)
        assert bool((pen > smax).any())
    assert {p.C for p in plans} == {C}


def test_wfa_kernels_paths_cross_slice_edges(cuda, monkeypatch):
    """Deletions of 1 to 44 bases and insertions of 1 to 44 at K = 91: each
    path runs along the diagonals of several CTAs (slices of 12 at C = 8,
    23 at C = 4)."""
    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", np.uint8)
    B, W = 88, 160
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        d = i % 44 + 1
        ref = rng.choice(bases, 110)
        if i < 44:
            read = np.concatenate([ref[:30], ref[30 + d:]])
        else:
            read = np.concatenate([ref[:30], rng.choice(bases, d), ref[30:]])
        a[i, :110], b[i, :len(read)] = ref, read
        la[i], lb[i] = 110, len(read)
    args = [torch.from_numpy(v).to(cuda) for v in (a, b, la, lb)]
    for C in (8, 4):
        plans = _force_plan(monkeypatch, cluster=C)
        for model in ("affine", "affine2p"):
            _check_wfa(args, 96, model)
        assert plans[0].cw < 44 and {p.C for p in plans} == {C}


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("model", ["affine", "affine2p"])
def test_wfa_score_warp_path_matches_plain(cuda, monkeypatch, model, B):
    """wfa_score on the warp path (one warp a pair, B not a multiple of
    the pairs a CTA): wildcards, censored pairs, kband at both sides of
    the switch (K = 127 on the warp path, 129 on the CTA path), a pair
    whose lengths lie outside its rows (-1, the others unchanged)."""
    from clique_tpu_torch.align import wfa_kernels as wk

    plans = _force_plan(monkeypatch, kinds=("score",))
    host = _wfa_pairs(40 + B, max(B, 2), 120)
    args = [torch.from_numpy(np.ascontiguousarray(v[:B])).to(cuda)
            for v in host]
    n = (wk.wfa_score_launches, wk.wfa_score_warp_launches)
    for kw in (dict(wildcards=True), dict(), dict(smax=10),
               dict(kband=63, smax=200), dict(kband=64, smax=200)):
        kw = {**WFA_PEN, "smax": 96, **kw}
        got = wk.wfa_score(*args, model=model, **kw)
        want = wk.wfa_fill_reference(*args, model=model, traceback=False,
                                     **kw)[0]
        assert torch.equal(got, want)
    assert [p.wp > 0 for p in plans] == [
        2 * wk.kmax_of(model, 120, 120, 96, 6, 2, 24, 1) + 1 <= 128] * 2 + \
        [True, True, False]
    bad = [a.clone() for a in args]
    bad[2][0] = 121                                  # past the 120-byte row
    got = wk.wfa_score(*bad, model=model, **WFA_PEN, smax=10,
                       wildcards=True)
    want = wk.wfa_fill_reference(*args, model=model, traceback=False,
                                 **WFA_PEN, smax=10, wildcards=True)[0]
    assert int(got[0]) == -1 and torch.equal(got[1:], want[1:])
    assert plans[-1].wp > 0
    assert wk.wfa_score_launches - n[0] == 6
    assert wk.wfa_score_warp_launches - n[1] == \
        sum(p.wp > 0 for p in plans)


def _ont_like(rng, ref):
    """A read of ref at ONT raw-read rates: 5% substitutions, 2.5% each of
    1-3 bp deletions and insertions."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    out, i = [], 0
    while i < len(ref):
        u = rng.random()
        if u < 0.05:
            out.append(rng.choice(bases))
        elif u < 0.075:
            i += int(rng.integers(1, 4))
            continue
        elif u < 0.1:
            out.extend(rng.choice(bases, int(rng.integers(1, 4))))
            out.append(ref[i])
        else:
            out.append(ref[i])
        i += 1
    return np.array(out, np.uint8)


def test_wfa_mid_ont_pairs_at_the_top_rung(cuda, monkeypatch):
    """wfa_mid on 8 pairs of a 4 kb reference and its ONT-like reads at the
    bialign engine's top rung (smax 4,096, L = 4,224, K = 4,091): int16
    rings in shared memory, then all in the global workspace."""
    rng = np.random.default_rng(13)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    B, W = 8, 4224
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        read = _ont_like(rng, ref)[:W]
        a[i, :4000], b[i, :len(read)] = ref, read
        lb[i] = len(read)
    la = np.full(B, 4000, np.int32)
    args = [torch.from_numpy(v).to(cuda) for v in (a, b, la, lb)]
    from clique_tpu_torch.align import wfa_kernels as wk

    p_pen, p_pay = wk.wfa_mid_reference(*args, smax=4096, wildcards=True)
    assert bool((p_pen > 2048).all()) and bool((p_pen <= 4096).all())
    for force in (dict(), dict(cluster=0)):
        plans = _force_plan(monkeypatch, kinds=("mid",), **force)
        pen, pay = wk.wfa_mid(*args, smax=4096, wildcards=True)
        assert torch.equal(pen, p_pen) and torch.equal(pay, p_pay)
        assert [p.ring_global for p in plans] == [bool(force)]


def test_wfa_kernels_mark_bad_lengths_in_a_cluster(cuda, monkeypatch):
    """A pair whose lengths lie outside its rows is marked by every CTA of
    its cluster together (and by the persistent grid's CTAs), beside pairs
    that align."""
    from clique_tpu_torch.align import wfa_kernels as wk

    t = torch.full((4, 20), ord("A"), dtype=torch.uint8, device=cuda)
    t[3, 7] = ord("C")
    l1 = torch.tensor([5, 21, 4, 20], dtype=torch.int32, device=cuda)
    l2 = torch.tensor([5, 3, -1, 18], dtype=torch.int32, device=cuda)
    good = [0, 3]
    p_pen, p_ops = wk.wfa_fill_reference(t[good], t[good], l1[good],
                                         l2[good], smax=16)
    p_fwd, p_fin = wk.wfa_walk_reference(p_ops, p_pen, l1[good] - l2[good],
                                         model="affine", x=4, o=6, e=2)
    p_mid = wk.wfa_mid_reference(t[good], t[good], l1[good], l2[good],
                                 smax=16)
    for C in (2, 8, 0):
        _force_plan(monkeypatch, kinds=("align", "mid") if C == 0 else
                    ("align",), cluster=C)
        pen, _ops, fwd, fin, runs = wk.wfa_align(t, t, l1, l2, smax=16)
        assert pen.tolist() == [p_pen[0], -1, -1, p_pen[1]]
        assert runs[1:3, 0].tolist() == [0, 0]
        assert fin.tolist() == [p_fin[0], -3, -3, p_fin[1]]
        assert int(fwd[1:3].sum()) == 0 and torch.equal(fwd[good], p_fwd)
        pen, pay = wk.wfa_mid(t, t, l1, l2, smax=16)
        assert torch.equal(pen[good], p_mid[0]) and torch.equal(pay[good],
                                                                p_mid[1])
        assert pen.tolist()[1:3] == [-1, -1] and pay.tolist()[1:3] == [-1, -1]


def test_wfa_kernel_marks_bad_lengths(cuda):
    from clique_tpu_torch.align import wfa_kernels as wk

    t = torch.full((3, 20), ord("A"), dtype=torch.uint8, device=cuda)
    l1 = torch.tensor([5, 21, 4], dtype=torch.int32, device=cuda)
    l2 = torch.tensor([5, 3, -1], dtype=torch.int32, device=cuda)
    pen, _ops, fwd, fin, runs = wk.wfa_align(t, t, l1, l2, smax=16)
    assert pen.tolist() == [0, -1, -1] and fin.tolist() == [-1, -3, -3]
    assert int(fwd.sum()) == 0
    assert runs[:, 0].tolist() == [5 << 2, 0, 0] and int(runs[0, 1]) == 0


def test_wfa_kernels_empty_batch_counts_no_launch(cuda):
    """B = 0 launches nothing, so neither counter moves."""
    from clique_tpu_torch.align import wfa_kernels as wk

    t = torch.zeros((0, 16), dtype=torch.uint8, device=cuda)
    n = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = (wk.wfa_align_launches, wk.wfa_score_launches)
    pen, ops, fwd, fin, runs = wk.wfa_align(t, t, n, n, smax=8)
    sc = wk.wfa_score(t, t, n, n, smax=8)
    assert (wk.wfa_align_launches, wk.wfa_score_launches) == before
    assert pen.shape == sc.shape == fin.shape == (0,)
    assert ops.shape[1] == 0 and fwd.shape == (0, 9)
    assert runs.shape == (0, wk.runs_width("affine", 8, 4, 2, 1))


def _ont_raw(rng, ref):
    """A read of ref at the ONT raw-read model of the ont_raw_4kb
    configuration: 10% errors, substitutions, insertions and deletions
    23:31:46, one base each."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    out, i = [], 0
    while i < len(ref):
        u = rng.random()
        if u < 0.023:
            out.append(bases[(np.flatnonzero(bases == ref[i])[0]
                              + rng.integers(1, 4)) % 4])
        elif u < 0.054:
            out.extend((rng.choice(bases), ref[i]))
        elif u >= 0.1:
            out.append(ref[i])
        i += 1
    return np.array(out, np.uint8)


def _ont_pairs(rng, ref, B, W):
    """B ONT raw reads of `ref` (_ont_raw) as [B, W] rows with their
    lengths, the reference beside each."""
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        read = _ont_raw(rng, ref)[:W]
        a[i, :len(ref)], b[i, :len(read)] = ref, read
        lb[i] = len(read)
    return a, b, np.full(B, len(ref), np.int32), lb


@pytest.mark.parametrize("wildcards", [False, True])
@pytest.mark.parametrize("model", ["affine", "affine2p"])
def test_wfa_runs_short_pairs(cuda, model, wildcards):
    """The replay on the card over pairs of length 0 and 1 (empty
    skeletons, gap-only ones, one mismatch), beside longer pairs that
    start and end with a gap."""
    rng = np.random.default_rng(31)
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 60).tobytes()
    pairs = [(b"", b""), (b"", b"A"), (b"A", b""), (b"A", b"A"), (b"A", b"C"),
             (b"AC", b""), (b"", b"ACG"), (b"N", b"A"), (s, s[9:]),
             (s, s + b"ACGTA"), (s[4:], s), (s + b"TT", s)]
    W = 70
    a = np.zeros((len(pairs), W), np.uint8)
    b = np.zeros((len(pairs), W), np.uint8)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x, np.uint8)
        b[i, :len(y)] = np.frombuffer(y, np.uint8)
    la = np.array([len(x) for x, _ in pairs], np.int32)
    lb = np.array([len(y) for _, y in pairs], np.int32)
    args = [torch.from_numpy(v).to(cuda) for v in (a, b, la, lb)]
    pen = _check_wfa(args, 96, model, wildcards=wildcards)
    assert bool((pen <= 96).all())


def test_wfa_runs_leaf_shape(cuda):
    """A bialign leaf chunk's launch: B = 64, L = 512, smax x + o + e * L,
    ONT-like pairs of ~450 bases (10% errors, 23:31:46), with and without
    wildcards: every lane walked, its runs the host replay's."""
    rng = np.random.default_rng(41)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 450)
    host = _ont_pairs(rng, ref, 64, 512)
    args = [torch.from_numpy(v).to(cuda) for v in host]
    for wildcards in (False, True):
        pen = _check_wfa(args, 4 + 6 + 2 * 512, "affine",
                         wildcards=wildcards)
        assert bool((pen <= 4 + 6 + 2 * 512).all())


def test_wfa_runs_rung_shape(cuda):
    """A rung chunk of 4 kb reads that converge (2% substitutions and
    1 bp indels: M runs of hundreds of bases): B = 32, L = 4,096 at the
    1,024 rung, and two lanes censored there."""
    rng = np.random.default_rng(43)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(bases, 4000)
    B, W = 32, 4096
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        read = ref.copy()
        if i < B - 2:
            sub = rng.random(4000) < 0.02
            read[sub] = rng.choice(bases, int(sub.sum()))
            for p in sorted(rng.choice(3990, 6, replace=False))[::-1]:
                read = np.delete(read, p) if p % 2 else np.insert(read, p, 65)
        else:
            read = rng.choice(bases, 3000)           # censored at 1,024
        a[i, :4000], b[i, :len(read)] = ref, read
        lb[i] = len(read)
    args = [torch.from_numpy(v).to(cuda)
            for v in (a, b, np.full(B, 4000, np.int32), lb)]
    pen = _check_wfa(args, 1024, "affine", wildcards=True)
    assert int((pen > 1024).sum()) == 2


def test_wfa_bialign_runs_equal_the_host_replay(cuda, monkeypatch):
    """wfa_bialign_affine_pairs on ONT-like 3.6 kb pairs gives the same
    penalties and CIGARs with the runs of the card as with the card's
    fill and walk followed by the host replay (wfa_runs_reference over
    each leaf launch's skeletons)."""
    from clique_tpu_torch.align import wavefront as twf
    from clique_tpu_torch.align import wfa_kernels as wk

    rng = np.random.default_rng(47)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3600)
    refs = [ref.tobytes()] * 4
    reads = [_ont_raw(rng, ref).tobytes() for _ in range(4)]
    stats = twf.WfaAligner(device="cuda")
    got = twf.wfa_bialign_affine_pairs(refs, reads, wildcards=True,
                                       device="cuda", stats=stats)
    assert stats.cigars_from_card == stats.leaf_pairs > 8
    real = wk.wfa_align

    def replayed(*args, **kw):
        pen, ops, fwd, fin, _runs = real(*args, **kw)
        runs = wk.wfa_runs_reference(
            *args, fwd, fin, wildcards=kw.get("wildcards", False),
            width=wk.runs_width("affine", kw["smax"], kw.get("x", 4),
                                kw.get("e", 2), 0))
        return pen, ops, fwd, fin, runs

    monkeypatch.setattr(wk, "wfa_align", replayed)
    want = twf.wfa_bialign_affine_pairs(refs, reads, wildcards=True,
                                        device="cuda")
    assert got == want
    for (a, b), (pen, cig) in zip(zip(refs, reads), got):
        assert twf.cigar_penalty(cig, a, b, x=4, o=6, e=2,
                                 wildcards=True) == pen


def _check_mid(args, **kw):
    """wfa_mid on the card against wfa_mid_reference: penalties and split
    payloads; one launch counted."""
    from clique_tpu_torch.align import wfa_kernels as wk

    n = wk.wfa_mid_launches
    pen, pay = wk.wfa_mid(*args, **kw)
    torch.cuda.synchronize()
    assert wk.wfa_mid_launches == n + 1
    p_pen, p_pay = wk.wfa_mid_reference(*args, **kw)
    assert torch.equal(pen, p_pen) and torch.equal(pay, p_pay)
    return pen, pay


@pytest.mark.parametrize("option", [
    dict(), dict(wildcards=True), dict(smax=10),
], ids=["exact", "wildcards", "censored"])
def test_wfa_mid_matches_plain(cuda, option):
    """A ragged batch (identical pairs, long deletions, wildcard zones, a
    hopeless pair that censors)."""
    kw = dict(option)
    smax = kw.pop("smax", 96)
    args = [torch.from_numpy(a).to(cuda) for a in _wfa_pairs(7, 64, 120)]
    pen, pay = _check_mid(args, smax=smax, **kw)
    assert bool((pen > smax).any()) and bool((pay >= 0).any())
    assert bool(((pen > smax) == (pay < 0)).all())


def test_wfa_mid_global_rings(cuda):
    """L = 1,280, smax 2,300 (K = 2,295) at a mismatch of 300: the rings
    and payload planes (614 rows: M and PM 301 each) pass a cluster of 8
    CTAs and live in the global workspace."""
    from clique_tpu_torch.align import wfa_kernels as wk

    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, (6, 1280))
    b = a.copy()
    sub = rng.random(b.shape) < 0.12
    b[sub] = rng.choice(bases, int(sub.sum()))
    la = np.array([1280, 1200, 1000, 640, 1, 1280], np.int32)
    lb = np.array([1280, 1250, 900, 700, 1, 1100], np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
            for v in (a, b, la, lb)]
    n = wk.wfa_global_ring_launches
    pen, _pay = _check_mid(args, smax=2300, x=300)
    assert wk.wfa_global_ring_launches == n + 1
    assert bool((pen > 600).any())


def test_wfa_mid_marks_bad_lengths_and_empty_batch(cuda):
    from clique_tpu_torch.align import wfa_kernels as wk

    t = torch.full((3, 20), ord("A"), dtype=torch.uint8, device=cuda)
    l1 = torch.tensor([6, 21, 4], dtype=torch.int32, device=cuda)
    l2 = torch.tensor([6, 3, -1], dtype=torch.int32, device=cuda)
    pen, pay = wk.wfa_mid(t, t, l1, l2, smax=16)
    assert pen.tolist() == [0, -1, -1]
    assert pay.tolist() == [3 * 65536 + 3, -1, -1]
    e = torch.zeros((0, 16), dtype=torch.uint8, device=cuda)
    n = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = wk.wfa_mid_launches
    pen, pay = wk.wfa_mid(e, e, n, n, smax=8)
    assert wk.wfa_mid_launches == before and pen.shape == pay.shape == (0,)


def test_wfa_bialign_on_cuda_equals_cpu(cuda):
    """wfa_bialign_affine_pairs on the card (wfa_mid splits, wfa_align
    leaves) gives the CPU's list, pair for pair."""
    from clique_tpu_torch.align import wavefront as twf
    from clique_tpu_torch.align import wfa_kernels as wk

    a, b, la, lb = _wfa_pairs(9, 24, 700)
    refs = [a[i, :la[i]].tobytes() for i in range(len(la))]
    reads = [b[i, :lb[i]].tobytes() for i in range(len(lb))]
    n = wk.wfa_mid_launches
    for leaf in (64, 512):
        got = twf.wfa_bialign_affine_pairs(refs, reads, wildcards=True,
                                           leaf=leaf, device="cuda")
        assert got == twf.wfa_bialign_affine_pairs(
            refs, reads, wildcards=True, leaf=leaf, device="cpu")
    assert wk.wfa_mid_launches > n


@pytest.mark.parametrize("model", ["affine", "affine2p"])
def test_wfa_aligner_and_screen_on_cuda_equal_cpu(cuda, model):
    from clique_tpu_torch.align import wavefront as twf

    a, b, la, lb = _wfa_pairs(6, 96, 300)
    refs = [a[i, :la[i]].tobytes() for i in range(len(la))]
    reads = [b[i, :lb[i]].tobytes() for i in range(len(lb))]
    from clique_tpu_torch.align.pipeline import BatchAligner

    fb = {d: BatchAligner(AffineScoring.aligner_default(), 16, device=d)
          for d in ("cuda", "cpu")}
    card = twf.WfaAligner(model=model, device="cuda", dp_fallback=fb["cuda"])
    host = twf.WfaAligner(model=model, device="cpu", dp_fallback=fb["cpu"])
    got = card.align_pairs(refs, reads)
    want = host.align_pairs(refs, reads)
    assert got == want
    # the same lanes walked; their CIGARs built on the card, or replayed
    assert (card.cigars_from_card, card.cigars_replayed) == \
        (host.cigars_replayed, 0)
    assert host.cigars_from_card == 0 and card.cigars_from_card > 0
    s_got = twf.wfa_screen_candidates(refs, reads, model=model,
                                      device="cuda")
    s_want = twf.wfa_screen_candidates(refs, reads, model=model,
                                       device="cpu")
    assert s_got.tolist() == s_want.tolist()


@pytest.mark.parametrize("engine", ["wfa", "convex"])
def test_align_engine_golden_on_cuda(cuda, engine, tmp_path):
    from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                           _load_make_golden)

    from clique_tpu_torch.align import wfa_kernels as wk
    from clique_tpu_torch.align.pipeline import align_reads

    gd, layout, rm, r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                             tmp_path)
    out = str(tmp_path / "aligned.bam")
    n = wk.wfa_align_launches
    align_reads(layout, rm, out, read1=r1, batch_size=16, engine=engine,
                device="cuda")
    assert wk.wfa_align_launches > n
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, f"aligned_{engine}.bam"))


@pytest.mark.parametrize("n1,bounds,tile,limits", [
    (513, [1, 3, 10, 400, 401, 420, 513], 7, None),   # a part of two bands
    (513, [1, 385, 513], 100, None),           # dp_align's band boundary
    (513, [1, 513], 480, None),                # one part, C = 1
    (513, [1, 513], 480, (1, 1)),              # two bands on one warp
    (1201, [1, 1201], 100, (1, 3)),            # four bands on three CTAs
    (1201, [1, 385, 1201], 33, (2, 1)),        # bands in turn, two parts
    (3073, [1, 3073], 480, (1, 8))],           # eight CTAs, a band each
    ids=["uneven", "banded", "one-part", "in-turn", "in-turn-cluster",
         "in-turn-parts", "cluster-8"])
def test_length_sharded_align_kernels_match_plain(cuda, monkeypatch, n1,
                                                  bounds, tile, limits):
    """length_sharded_align over [cuda:0] * k (segment_fill and
    segment_walk, launched and counted) against the plain versions over
    [cpu] * k on the same inputs: results, and each part's traceback
    relaid as the plain fill's; ragged lengths with corners on every part,
    and a row marked for lengths outside the bucket. `limits` (warps a
    CTA, CTAs a cluster) shrink segment_plan's so that a part has more
    bands than the cluster has warps (the warps take them in turn) or its
    bands span C CTAs."""
    import functools

    from clique_tpu_torch.parallel import length_sharded_align

    if limits is not None:
        monkeypatch.setattr(dp_kernels, "segment_plan", functools.partial(
            dp_kernels.segment_plan, max_warps=limits[0],
            max_cluster=limits[1]))
        plan = dp_kernels.segment_plan(bounds[-1] - bounds[-2], tile, 168)
        assert plan[:2] == (limits[1], limits[0])
    rng = np.random.default_rng(len(bounds) + tile)
    B, n2 = 7, 481
    refs, reads, ref_lens, read_lens = _inputs(len(bounds), B, n1, n2, False)
    ref_lens[2:5] = [bounds[1] - 1, min(bounds[1], n1 - 1), bounds[-2]]
    read_lens[4] = 0
    reads[5, :200] = refs[5, 100:300]
    ref_lens[5], read_lens[5] = 480, 200
    ref_lens[6] = int(rng.integers(1, n1))
    params = tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")
    kw = dict(n1=n1, n2=n2, bounds=bounds, tile=tile, return_parts=True)
    k = len(bounds) - 1
    fills, walks = (dp_kernels.fill_mode_launches[m]
                    for m in ("row_split", "row_split_walk"))
    got = length_sharded_align([cuda] * k, refs, reads, ref_lens, read_lens,
                               params, **kw)
    assert dp_kernels.fill_mode_launches["row_split"] - fills == sum(
        p["fills"] for p in got[3])
    assert dp_kernels.fill_mode_launches["row_split_walk"] - walks == k
    want = length_sharded_align(["cpu"] * k, refs, reads, ref_lens,
                                read_lens, params, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    lens = [torch.from_numpy(a).to(cuda) for a in (ref_lens, read_lens)]
    for g, w in zip(got[3], want[3]):
        lo, hi = g["rows"]
        relaid = tbatch.segment_wavefront_to_rows(
            g["traceback"], *lens, row0=lo, n=hi - lo, n1=n1, n2=n2)
        assert torch.equal(relaid.cpu(), w["traceback"])
    ref_lens[3] = n1                      # outside the bucket: marked
    with pytest.raises(ValueError):
        length_sharded_align([cuda] * k, refs, reads, ref_lens, read_lens,
                             params, n1=n1, n2=n2, bounds=bounds, tile=tile)


def test_length_sharded_align_largest_cluster_matches_dp_align(cuda):
    """One part of 86 bands (n1 = 33,001): segment_plan's largest cluster
    (C = 8 CTAs of up to 12 warps), B = 40 alignments, more clusters than
    the card holds at once; results equal one dp_align call's on the card
    and the part's traceback equals dp_align's, ragged rows included."""
    from clique_tpu_torch.parallel import length_sharded_align

    B, n1, n2 = 40, 33001, 41
    refs, reads, ref_lens, read_lens = _inputs(86, B, n1, n2, False)
    ref_lens[2:6] = n1 - 1
    read_lens[2:4] = n2 - 1
    plan = dp_kernels.segment_plan(n1 - 1, n2 - 1,
                                   dp_kernels.segment_fill_regs())
    assert plan.C == 8 and plan.bands == 86 and B > 132 // plan.C
    params = tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")
    got = length_sharded_align([cuda], refs, reads, ref_lens, read_lens,
                               params, n1=n1, n2=n2, return_parts=True)
    args = [torch.from_numpy(a).to(cuda) for a in (refs, reads, ref_lens,
                                                   read_lens)]
    fused, wave = dp_kernels.dp_align(*args, params.to(cuda), n1=n1, n2=n2,
                                      special_mode="both",
                                      return_traceback=True)
    packed, n_ops, score = tbatch.unfuse_result(fused.cpu().numpy())
    assert np.array_equal(got[0].numpy(), score)
    assert np.array_equal(got[2].numpy(), n_ops)
    assert np.array_equal(got[1].numpy(), tbatch.unpack_ops(
        np.ascontiguousarray(packed), n1 + n2))
    kw = dict(row0=1, n=n1 - 1, n1=n1, n2=n2)
    assert torch.equal(
        tbatch.segment_wavefront_to_rows(got[3][0]["traceback"], *args[2:],
                                         **kw),
        tbatch.segment_wavefront_to_rows(wave, *args[2:], **kw))
