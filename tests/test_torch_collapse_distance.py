"""The port's tag distances (clique_tpu_torch.collapse.distance) against the
JAX package's (clique_tpu.collapse.distance, jax on the CPU).

Inputs are made from seeds with numpy and handed to both. Every result is
an integer, a byte or an index list, so every comparison is exact. On the
CPU the wrappers run their plain PyTorch versions; the kernels themselves
are held against those in tests/test_torch_cuda.py on the card.
"""

import numpy as np
import pytest
import torch

import clique_tpu.collapse.distance as jdist
from clique_tpu_torch.collapse import distance as tdist

ALPHABET = np.frombuffer(b"ACGTN-", dtype=np.uint8)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _jax_match_count(tags, allow):
    lut, n_classes = jdist._byte_classes([tags, allow])
    return np.asarray(jdist._match_count_kernel(lut[tags], lut[allow],
                                                n_classes=n_classes))


@pytest.mark.parametrize("shape", [(1, 1, 16), (37, 91, 16), (130, 257, 8),
                                   (64, 200, 17), (9, 33, 3)], ids=str)
def test_match_count_reference_matches_jax(shape):
    U, K, L = shape
    rng = np.random.default_rng(sum(shape))
    allow = rng.choice(ALPHABET, (K, L))
    tags = rng.choice(ALPHABET, (U, L))
    # some tags copied from the allowlist, some one byte off
    for u in range(0, U, 3):
        tags[u] = allow[rng.integers(K)]
        if u % 2:
            tags[u, rng.integers(L)] = rng.choice(ALPHABET)
    want = _jax_match_count(tags, allow)
    got = tdist.match_count_reference(torch.from_numpy(tags),
                                      torch.from_numpy(allow))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_count_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(3)
    tags = torch.from_numpy(rng.choice(ALPHABET, (20, 16)))
    allow = torch.from_numpy(rng.choice(ALPHABET, (50, 16)))
    n = tdist.match_count_launches
    got = tdist.match_count(tags, allow)
    assert tdist.match_count_launches == n       # no kernel launched
    assert torch.equal(got, tdist.match_count_reference(tags, allow))


def _edit_inputs(seed, P, L, zero_lens=True):
    rng = np.random.default_rng(seed)
    a = rng.choice(ALPHABET, (P, L))
    b = a.copy()
    la = rng.integers(0, L + 1, P).astype(np.int32)
    lb = np.clip(la + rng.integers(-3, 4, P), 0, L).astype(np.int32)
    for p in range(P):                 # a few edits of a into b
        for _ in range(int(rng.integers(0, 4))):
            b[p, rng.integers(L)] = rng.choice(ALPHABET)
    b[::5] = rng.choice(ALPHABET, b[::5].shape)
    if zero_lens:
        la[0], lb[1] = 0, 0
        la[2] = lb[2] = 0
    return a, b, la, lb


@pytest.mark.parametrize("L", [8, 32, 40, 64, 80])
def test_edit_distance_reference_matches_jax_kernel(L):
    a, b, la, lb = _edit_inputs(L, 64, L)
    want = np.asarray(jdist._edit_distance_kernel(a, b, la, lb, L1=L, L2=L))
    got = tdist.edit_distance_reference(*(torch.from_numpy(x)
                                          for x in (a, b, la, lb)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", [16, 32, 64])
def test_edit_distance_reference_matches_myers_host(L, monkeypatch):
    monkeypatch.setattr(tdist, "REFERENCE_CHUNK", 64)   # 300 pairs: 5 chunks
    a, b, la, lb = _edit_inputs(100 + L, 300, L)
    want = jdist._edit_distance_myers_host(a, b, la, lb)
    got = tdist.edit_distance_reference(*(torch.from_numpy(x)
                                          for x in (a, b, la, lb)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tdist._edit_distance_myers_host(a, b, la, lb), want)


def test_edit_distance_caps_at_255():
    L = 256
    a = np.full((2, L), ord("A"), np.uint8)
    b = np.full((2, L), ord("C"), np.uint8)
    la = np.array([L, 10], np.int32)
    lb = np.array([L, 0], np.int32)
    got = tdist.edit_distance(*(torch.from_numpy(x) for x in (a, b, la, lb)))
    assert got.tolist() == [255, 10]


def test_edit_distance_wrapper_refuses_rows_past_its_bound():
    L = tdist.EDIT_MAX_LEN + 1
    a = torch.zeros((2, L), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed"):
        tdist.edit_distance(a, a.clone(), lens, lens)
    # edit_distance_rows sends such rows to the wrapper, never to Myers
    with pytest.raises(ValueError, match="exceed"):
        tdist.edit_distance_rows(a.numpy(), a.numpy(), lens.numpy(),
                                 lens.numpy(), device="cpu")


@pytest.mark.parametrize("bad", [(-1, 3), (3, 33)], ids=["negative", "long"])
def test_edit_distance_wrapper_refuses_lengths_out_of_range(bad):
    a = torch.zeros((1, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lengths"):
        tdist.edit_distance(a, a.clone(), torch.tensor([bad[0]], dtype=torch.int32),
                            torch.tensor([bad[1]], dtype=torch.int32))


def test_match_count_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError, match="wide"):
        tdist.match_count(torch.zeros((2, 16), dtype=torch.uint8),
                          torch.zeros((2, 15), dtype=torch.uint8))
    with pytest.raises(ValueError, match="exceed"):
        L = tdist.MATCH_MAX_LEN + 1
        tdist.match_count(torch.zeros((2, L), dtype=torch.uint8),
                          torch.zeros((2, L), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tdist.match_count(torch.zeros((2, 16), dtype=torch.int32),
                          torch.zeros((2, 16), dtype=torch.int32))


@pytest.mark.parametrize("case", [
    dict(U=50, K=40, L=16, d=1, cu=2048, ck=16384),
    dict(U=200, K=300, L=16, d=2, cu=64, ck=100),
    dict(U=77, K=129, L=12, d=0, cu=32, ck=33),
    dict(U=30, K=30, L=8, d=3, cu=7, ck=11),
], ids=["one_chunk", "chunked", "exact", "wide_radius"])
def test_hamming_hits_matches_jax(case):
    rng = np.random.default_rng(case["U"] * 7 + case["K"])
    L = case["L"]
    allow = [rng.choice(BASES, L).tobytes() for _ in range(case["K"])]
    allow[1] = allow[0][:-1] + b"N"          # near-duplicate entries
    tags = [allow[0]]
    for u in range(case["U"]):
        t = bytearray(allow[rng.integers(len(allow))])
        for _ in range(int(rng.integers(0, 4))):
            t[rng.integers(L)] = int(rng.choice(ALPHABET))
        tags.append(bytes(t))
    want = jdist.hamming_hits(tags, allow, case["d"])
    got = tdist.hamming_hits(tags, allow, case["d"], device="cpu",
                             chunk_u=case["cu"], chunk_k=case["ck"])
    assert got == want
    assert any(len(h) > 1 for h in got) or case["d"] == 0


@pytest.mark.parametrize("L", [16, 32, 70])
def test_edit_distance_rows_matches_jax(L, monkeypatch):
    a, b, la, lb = _edit_inputs(7 * L, 500, L)
    want = jdist.edit_distance_rows(a, b, la, lb)
    got = tdist.edit_distance_rows(a, b, la, lb, device="cpu")
    np.testing.assert_array_equal(got, want)
    # the same rows through the plain version of the device path
    monkeypatch.setattr(tdist, "DEVICE_MIN_PAIRS", 0)
    np.testing.assert_array_equal(
        tdist.edit_distance_rows(a, b, la, lb, device="cpu"), want)


@pytest.mark.parametrize("force_device_path", [False, True])
def test_edit_distance_pairs_matches_jax(force_device_path, monkeypatch):
    rng = np.random.default_rng(11)
    seqs_a, seqs_b = [], []
    for i in range(400):
        n = int(rng.integers(0, 40))
        s = rng.choice(BASES, n).tobytes()
        t = bytearray(s)
        for _ in range(int(rng.integers(0, 3))):
            if t and rng.random() < 0.5:
                del t[rng.integers(len(t))]
            else:
                t.insert(int(rng.integers(len(t) + 1)), int(rng.choice(BASES)))
        seqs_a.append(s)
        seqs_b.append(bytes(t))
    want = jdist.edit_distance_pairs(seqs_a, seqs_b)
    if force_device_path:
        monkeypatch.setattr(tdist, "DEVICE_MIN_PAIRS", 0)
    got = tdist.edit_distance_pairs(seqs_a, seqs_b, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert tdist.edit_distance_pairs([], [], device="cpu").shape == (0,)


def _mutated_tags(seed, n, L, d):
    rng = np.random.default_rng(seed)
    base = [rng.choice(BASES, L).tobytes() for _ in range(max(1, n // 8))]
    tags = set(base)
    while len(tags) < n:
        t = bytearray(base[rng.integers(len(base))])
        for _ in range(int(rng.integers(1, d + 1))):
            t[rng.integers(L)] = int(rng.choice(BASES))
        tags.add(bytes(t))
    return sorted(tags)


@pytest.mark.parametrize("L,d", [(16, 1), (16, 2), (12, 2), (20, 3)])
def test_candidate_pairs_np_matches_jax(L, d):
    tags = _mutated_tags(L + d, 300, L, d)
    np.testing.assert_array_equal(tdist._candidate_pairs_np(tags, d),
                                  jdist._candidate_pairs_np(tags, d))


@pytest.mark.parametrize("L,d", [(16, 2), (20, 1), (40, 2)])
def test_candidate_pairs_count_restricted_matches_jax(L, d):
    tags = _mutated_tags(3 * L + d, 400, L, d)
    rng = np.random.default_rng(L)
    counts = np.where(rng.random(len(tags)) < 0.1, 20, 1)
    np.testing.assert_array_equal(
        tdist.candidate_pairs_array(tags, d, counts=counts, ratio=5.0),
        jdist.candidate_pairs_array(tags, d, counts=counts, ratio=5.0))


def test_candidate_pairs_ragged_matches_jax():
    rng = np.random.default_rng(21)
    tags = [rng.choice(BASES, int(rng.integers(10, 14))).tobytes()
            for _ in range(120)]
    tags += [t[:-1] for t in tags[:30]]
    assert tdist.candidate_pairs(tags, 2) == jdist.candidate_pairs(tags, 2)
    np.testing.assert_array_equal(tdist.candidate_pairs_array(tags, 2),
                                  jdist.candidate_pairs_array(tags, 2))


def test_piece_keys_and_join_pairs_match_jax():
    rng = np.random.default_rng(8)
    a = rng.choice(BASES, (200, 6))
    np.testing.assert_array_equal(tdist._piece_keys(a), jdist._piece_keys(a))
    assert tdist._piece_keys(rng.choice(BASES, (5, 9))) is None
    k0 = tdist._piece_keys(a[:, :2])
    k1 = tdist._piece_keys(a[::3, 2:4])
    for got, want in zip(tdist._join_pairs(k0, k1),
                         jdist._join_pairs(k0, k1)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2])
def test_candidates_to_allowlist_matches_jax(d):
    rng = np.random.default_rng(d)
    allow = [rng.choice(BASES, 16).tobytes() for _ in range(200)]
    tags = _mutated_tags(50 + d, 80, 16, d) + [allow[3][1:] + b"-"]
    assert tdist.candidates_to_allowlist(tags, allow, d) == \
        jdist.candidates_to_allowlist(tags, allow, d)


def test_cuda_device_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.hamming_hits([b"ACGT"], [b"ACGT"], 1, device="cuda")
