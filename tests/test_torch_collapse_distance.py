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


def test_match_hits_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(3)
    tags = torch.from_numpy(rng.choice(ALPHABET, (20, 16)))
    allow = torch.from_numpy(rng.choice(ALPHABET, (50, 16)))
    tags[::3] = allow[:7]
    n = tdist.match_hits_launches
    u, k = tdist.match_hits(tags, allow, 2)
    assert tdist.match_hits_launches == n       # no kernel launched
    want = tdist.match_hits_reference(tags, allow, 2)
    assert torch.equal(u, want[0]) and torch.equal(k, want[1])
    assert u.dtype == k.dtype == torch.int64 and len(u) >= 7


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


# --- an emulation of csrc/tag_distance.cu's edit_distance kernel ----------
#
# The Myers/Hyyro recurrence as the kernel runs it: a warp's 32 row blocks
# staged from the aligned 16-byte chunks, the pattern's bit planes by 8 x 8
# bit transposes, a column's mismatch mask as the OR of plane_k ^ (bit k of
# the text byte, replicated), two planes a word where a warp's patterns
# fit 16 rows, words of 32 bits (L <= 32) or 64 bits chained by their
# horizontal deltas, bands of 256 rows past L = 256 with each column's
# delta out of a band kept for the next, and the distance read from the
# last column's vertical deltas. numpy, over pairs.

U64 = np.uint64


def _transpose8(x):
    t = (x ^ (x >> U64(7))) & U64(0x00AA00AA00AA00AA)
    x = x ^ t ^ (t << U64(7))
    t = (x ^ (x >> U64(14))) & U64(0x0000CCCC0000CCCC)
    x = x ^ t ^ (t << U64(14))
    t = (x ^ (x >> U64(28))) & U64(0x00000000F0F0F0F0)
    return x ^ t ^ (t << U64(28))


def _staged_rows(rows, L, shift):
    """Each pair's row as its lane reads it from shared memory: the warp's
    bytes copied from the aligned 16-byte chunks of a tensor that starts
    `shift` bytes past an aligned address, the row at (offset + lane * L),
    then whatever follows it in the block (the next rows, or bytes no load
    wrote: here 0xA5)."""
    P = rows.shape[0]
    flat = rows.reshape(-1)
    out = np.zeros((P, 2 * 256 + L + 64), np.uint8)
    for p0 in range(0, P, 32):
        n = min(32, P - p0)
        start = shift + p0 * L
        c0 = start // 16 * 16
        chunks = (start + n * L - c0 + 15) // 16
        block = np.full(chunks * 16 + 512 + 64, 0xA5, np.uint8)
        for i in range(chunks * 16):
            g = c0 + i - shift
            if 0 <= g < P * L:
                block[i] = flat[g]
        off = start - c0
        for lane in range(n):
            at = off + lane * L
            out[p0 + lane] = block[at:at + out.shape[1]]
    return out


def _words(rows, i):
    """Little-endian 32-bit words of rows[:, i:i + 4]."""
    r = rows[:, i:i + 4].astype(np.uint32)
    return r[:, 0] | r[:, 1] << 8 | r[:, 2] << 16 | r[:, 3] << 24


def _planes(rows, r0, nwords, bits):
    """pl[k][w]: bit i is bit k of pattern byte r0 + w * bits + i."""
    dt = np.uint32 if bits == 32 else np.uint64
    pl = [[np.zeros(rows.shape[0], dt) for _ in range(nwords)]
          for _ in range(8)]
    for w in range(nwords):
        for g in range(bits // 8):
            i = r0 + w * bits + 8 * g
            y = _transpose8(_words(rows, i).astype(U64)
                            | _words(rows, i + 4).astype(U64) << U64(32))
            for k in range(8):
                pl[k][w] |= ((y >> U64(8 * k)) & U64(0xff)).astype(dt) \
                    << dt(8 * g)
    return pl


def _text_bits(tw, j):
    """m[k]: bit k of byte j of tw replicated (prmt of tw << (7 - k))."""
    out = []
    for k in range(8):
        top = ((tw << np.uint32(7 - k)) >> np.uint32(8 * j + 7)) & 1
        out.append(np.where(top == 1, np.uint32(0xFFFFFFFF), np.uint32(0)))
    return out


def _mismatch16(pl, tw, j):
    """The kernel's mismatch16: planes 2q and 2q + 1 in one word's halves,
    one prmt giving both their bits of byte j (low two bytes from
    tw << (7 - 2q), high two from tw << (6 - 2q)), the halves OR-ed."""
    ne = np.zeros(len(tw), np.uint32)
    for q in range(4):
        pp = (pl[2 * q][0] & np.uint32(0xFFFF)) | (pl[2 * q + 1][0]
                                                  << np.uint32(16))
        lo = ((tw << np.uint32(7 - 2 * q)) >> np.uint32(8 * j + 7)) & 1
        hi = ((tw << np.uint32(6 - 2 * q)) >> np.uint32(8 * j + 7)) & 1
        m2 = np.where(lo == 1, np.uint32(0xFFFF), np.uint32(0)) | \
            np.where(hi == 1, np.uint32(0xFFFF0000), np.uint32(0))
        ne |= pp ^ m2
    return ne | (ne >> np.uint32(16))


def _myers_word(ne, pv, mv, hin, bits):
    dt = ne.dtype.type
    one = dt(1)
    hneg = np.where(hin < 0, one, dt(0))
    hpos = np.where(hin > 0, one, dt(0))
    eq = ~ne
    xv = eq | mv
    e = eq | hneg
    xh = (((e & pv) + pv) ^ pv) | e
    ph = mv | ~(xh | pv)
    mh = pv & xh
    top = dt(bits - 1)
    hout = (ph >> top).astype(np.int64) - (mh >> top).astype(np.int64)
    ph = (ph << one) | hpos
    mh = (mh << one) | hneg
    return hout, mh | ~(xv | ph), ph & xv


def _rows_sum(pv, mv, n, bits):
    d = np.zeros(len(n), np.int64)
    for w in range(len(pv)):
        r = np.clip(n - w * bits, 0, bits)
        for i in range(bits):
            bit = pv[w].dtype.type(i)
            on = r > i
            d += on * (((pv[w] >> bit) & 1).astype(np.int64)
                       - ((mv[w] >> bit) & 1).astype(np.int64))
    return d


def edit_distance_emulated(a, b, la, lb, shift=0):
    """min(Levenshtein, 255) of each row pair the way the kernel gets it."""
    P, L = a.shape
    la = np.clip(la.astype(np.int64), 0, L)
    lb = np.clip(lb.astype(np.int64), 0, L)
    if L <= 256:
        bits = 32 if L <= 32 else 64
        W = max(1, -(-L // bits))
        sa, sb = _staged_rows(a, L, shift), _staged_rows(b, L, shift)
        band, bands = W, 1
    else:
        bits, band = 64, 4
        bands = -(-L // 256)
        pad = np.zeros((P, 256 * bands + 8 - L), np.uint8)
        sa = np.concatenate([a, pad], 1)       # bytes past L read as 0
        sb = np.concatenate([b, pad], 1)
    dt = np.uint32 if bits == 32 else np.uint64
    # words past a warp's longest pattern are not run
    warp_n = np.repeat([la[i:i + 32].max() for i in range(0, P, 32)], 32)[:P]
    d = lb.copy()
    h_in = np.ones((P, L), np.int64)                 # band 0: D(0, j) = j
    for bd in range(bands):
        r0 = 256 * bd
        live = la > r0
        nw = np.minimum(band, -(-(warp_n - r0) // bits)) if L <= 256 else \
            np.minimum(band, -(-(la - r0) // bits))
        pl = _planes(sa, r0, band, bits)
        pv = [np.full(P, ~dt(0), dt) for _ in range(band)]
        mv = [np.zeros(P, dt) for _ in range(band)]
        h_out = np.zeros((P, L), np.int64)
        # warps whose patterns all fit 16 rows: two planes a word
        half = (bits == 32) & (warp_n <= 16)
        for j in range(int(lb.max(initial=0))):
            act = live & (j < lb)
            tw = _words(sb, j - j % 4)
            m = _text_bits(tw, j % 4)
            hin = h_in[:, j]
            for w in range(band):
                run = act & (w < nw)
                ne = np.zeros(P, dt)
                for k in range(8):
                    mk = m[k].astype(np.int32).astype(np.int64).astype(dt)
                    ne |= pl[k][w] ^ mk
                if bits == 32:
                    ne = np.where(half, _mismatch16(pl, tw, j % 4), ne)
                hout, npv, nmv = _myers_word(ne, pv[w], mv[w], hin, bits)
                pv[w] = np.where(run, npv, pv[w])
                mv[w] = np.where(run, nmv, mv[w])
                hin = np.where(run, hout, hin)
            h_out[:, j] = hin
        d += np.where(live, _rows_sum(pv, mv, la - r0, bits), 0)
        h_in = h_out
    return np.minimum(d, 255).astype(np.uint8)


EMULATION_WIDTHS = [8, 16, 32, 33, 64, 65, 80, 256, 257, 300]


@pytest.mark.parametrize("L", EMULATION_WIDTHS)
def test_edit_distance_kernel_emulation_matches_jax_kernel(L):
    """Every byte value 0-255 in the rows (the zero padding included),
    la or lb = 0, equal rows, pairs past the 255 cap, lb shorter than la,
    two misaligned row blocks, a last warp of fewer than 32 pairs; at
    L = 32 a first warp of patterns of at most 16 bytes (two planes a
    word)."""
    rng = np.random.default_rng(1000 + L)
    P = 200 if L <= 80 else 70
    a = rng.integers(0, 256, (P, L), dtype=np.uint8)
    a[: 256 // L + 1].reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    b = a.copy()
    mut = rng.random((P, L)) < 0.1
    b[mut] = rng.integers(0, 256, int(mut.sum()), dtype=np.uint8)
    b[::5] = rng.integers(0, 256, b[::5].shape, dtype=np.uint8)
    b[1::6] = rng.choice(np.array([0, 255, 65], np.uint8), b[1::6].shape)
    la = rng.integers(0, L + 1, P).astype(np.int32)
    lb = np.clip(la + rng.integers(-5, 6, P), 0, L).astype(np.int32)
    la[0], lb[1], la[2], lb[2], la[3], lb[3] = 0, 0, 0, 0, L, L
    la[4], lb[4] = L, max(0, L - 40)
    a[5], b[5], la[5], lb[5] = 0, 0, L, L                  # equal rows of 0
    a[6], b[6], la[6], lb[6] = 7, 9, L, L                  # d = L
    if L == 32:
        la[:32] = np.minimum(la[:32], 16)
    want = np.asarray(jdist._edit_distance_kernel(a, b, la, lb, L1=L, L2=L))
    if L > 255:
        assert want[6] == 255
    for shift in (0, 7):
        np.testing.assert_array_equal(
            edit_distance_emulated(a, b, la, lb, shift), want)


def test_transpose8_gives_bit_planes():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (50, 8), dtype=np.uint8)
    y = _transpose8(x.view("<u8")[:, 0])
    for k in range(8):
        plane = (y >> U64(8 * k)) & U64(0xff)
        want = ((x >> k) & 1).astype(np.uint64) << np.arange(8, dtype=U64)
        np.testing.assert_array_equal(plane, want.sum(1))


def test_edit_distance_caps_at_255():
    L = 256
    a = np.full((2, L), ord("A"), np.uint8)
    b = np.full((2, L), ord("C"), np.uint8)
    la = np.array([L, 10], np.int32)
    lb = np.array([L, 0], np.int32)
    got = tdist.edit_distance(*(torch.from_numpy(x) for x in (a, b, la, lb)))
    assert got.tolist() == [255, 10]


@pytest.mark.parametrize("L", [300, 1000])
def test_edit_distance_wide_rows_match_jax_kernel(L):
    """Rows past the kernel's local-memory row: the wrapper, and the
    device path of edit_distance_rows, equal the JAX kernel at any width,
    distances capped at 255."""
    a, b, la, lb = _edit_inputs(L, 6, L)
    a[4], b[4], la[4], lb[4] = ord("A"), ord("C"), L, L     # d = L > 255
    la[5], lb[5] = L, L - 40
    want = np.asarray(jdist._edit_distance_kernel(a, b, la, lb, L1=L, L2=L))
    got = tdist.edit_distance(*(torch.from_numpy(x) for x in (a, b, la, lb)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[4] == 255
    np.testing.assert_array_equal(
        tdist.edit_distance_rows(a, b, la, lb, device="cpu"), want)


def test_edit_distance_pairs_past_256_bytes_matches_jax():
    seqs_a, seqs_b = [b"A" * 300, b"ACGT" * 70], [b"C" * 300, b"ACGA" * 70]
    want = jdist.edit_distance_pairs(seqs_a, seqs_b)
    got = tdist.edit_distance_pairs(seqs_a, seqs_b, device="cpu")
    assert want.tolist() == got.tolist() == [255, 70]


@pytest.mark.parametrize("bad", [(-1, 3), (3, 33)], ids=["negative", "long"])
def test_edit_distance_wrapper_refuses_lengths_out_of_range(bad):
    a = torch.zeros((1, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lengths"):
        tdist.edit_distance(a, a.clone(), torch.tensor([bad[0]], dtype=torch.int32),
                            torch.tensor([bad[1]], dtype=torch.int32))


def test_match_hits_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError, match="wide"):
        tdist.match_hits(torch.zeros((2, 16), dtype=torch.uint8),
                         torch.zeros((2, 15), dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="one byte"):
        tdist.match_hits(torch.zeros((2, 0), dtype=torch.uint8),
                         torch.zeros((2, 0), dtype=torch.uint8), 1)
    with pytest.raises(TypeError):
        tdist.match_hits(torch.zeros((2, 16), dtype=torch.int32),
                         torch.zeros((2, 16), dtype=torch.int32), 1)


# allowlist alphabets past 4 and past 16 byte classes
MANY = np.frombuffer(b"ACGTNRYKMSWBDHVacgtn", dtype=np.uint8)
HAMMING_CASES = {
    "one_chunk": dict(U=50, K=40, L=16, d=1, cu=2048, ck=16384),
    "chunked": dict(U=200, K=300, L=16, d=2, cu=64, ck=100),
    "exact": dict(U=77, K=129, L=12, d=0, cu=32, ck=33),
    "wide_radius": dict(U=30, K=30, L=8, d=3, cu=7, ck=11),
    # ACGT allowlist, tags carrying bytes no entry holds
    "foreign_tag_bytes": dict(U=120, K=200, L=16, d=2, cu=64, ck=64,
                              noise=b"N-"),
    "allowlist_with_n_gap": dict(U=80, K=150, L=16, d=1, cu=32, ck=64,
                                 allow=ALPHABET),
    "many_classes": dict(U=80, K=150, L=24, d=3, cu=32, ck=64, allow=MANY,
                         noise=MANY),
    "l300_d50": dict(U=40, K=60, L=300, d=50, cu=16, ck=32, mut=60),
    # need = L - d = 280 > 255: the capped count passes no pair
    "l300_d20_need_over_255": dict(U=40, K=60, L=300, d=20, cu=16, ck=32),
}


def _hamming_case(case):
    """Seeded allowlist and tags: entries from `allow` (ACGT by default)
    with a near-duplicate pair, tags copied from entries with up to `mut`
    substitutions drawn from `noise` (ACGTN- by default)."""
    rng = np.random.default_rng(case["U"] * 7 + case["K"])
    L = case["L"]
    letters = case.get("allow", BASES)
    noise = np.frombuffer(case["noise"], np.uint8) \
        if isinstance(case.get("noise"), bytes) \
        else case.get("noise", ALPHABET)
    allow = [rng.choice(letters, L).tobytes() for _ in range(case["K"])]
    allow[1] = allow[0][:-1] + b"N"          # near-duplicate entries
    tags = [allow[0]]
    for u in range(case["U"]):
        t = bytearray(allow[rng.integers(len(allow))])
        for _ in range(int(rng.integers(0, case.get("mut", 3) + 1))):
            t[rng.integers(L)] = int(rng.choice(noise))
        tags.append(bytes(t))
    return tags, allow


def _jax_hamming_hits(tags, allow, d):
    """jdist.hamming_hits; past 255 columns its `L - matches`
    (distance.py:295) is a uint8 subtraction that NumPy 2 refuses, so there
    the same kernel (_match_count_kernel over _byte_classes) and the same
    radius test run here in int64."""
    L = len(allow[0])
    if L <= 255:
        return jdist.hamming_hits(tags, allow, d)
    t = np.frombuffer(b"".join(tags), np.uint8).reshape(-1, L)
    a = np.frombuffer(b"".join(allow), np.uint8).reshape(-1, L)
    m = _jax_match_count(t, a).astype(np.int64)
    return [np.flatnonzero(L - row <= d).tolist() for row in m]


@pytest.mark.parametrize("name", list(HAMMING_CASES))
def test_hamming_hits_matches_jax(name):
    case = HAMMING_CASES[name]
    tags, allow = _hamming_case(case)
    want = _jax_hamming_hits(tags, allow, case["d"])
    got = tdist.hamming_hits(tags, allow, case["d"], device="cpu",
                             chunk_u=case["cu"], chunk_k=case["ck"])
    assert got == want
    if case["L"] - case["d"] > 255:
        assert not any(got)
    else:
        assert any(len(h) > 1 for h in got) or case["d"] == 0


def _popcount(x):
    return sum((x >> i) & 1 for i in range(32))


def _packed_test_hits(tags, allow, d):
    """The kernel's per-pair test in torch, on pack_hit_inputs's encoding:
    XOR of the words, each field folded onto its top bit, AND with the
    tag's live mask, popcount against the budget; nothing where L - d
    exceeds 255, as the wrapper launches nothing there."""
    U, L = tags.shape
    K = allow.shape[0]
    if L - d > 255:
        return torch.zeros(0, dtype=torch.int64), torch.zeros(
            0, dtype=torch.int64)
    tw, tm, budgets, aw, bits = tdist.pack_hit_inputs(tags, allow, d)
    assert tw.dtype == tm.dtype == aw.dtype == torch.int32
    assert aw.shape[0] % 4 == 0 and not aw[K:].any()
    low = (1 << 32) - 1
    x = (tw.long()[:, None, :] ^ aw[:K].long()[None, :, :]) & low
    for s in (1, 2, 4)[:{2: 1, 4: 2, 8: 3}[bits]]:
        x = (x | (x << s)) & low
    cnt = _popcount(x & (tm.long() & low)[:, None, :]).sum(-1)
    return torch.nonzero(cnt <= budgets[:, None].long(), as_tuple=True)


@pytest.mark.parametrize("name", list(HAMMING_CASES))
def test_packed_hit_test_matches_reference(name):
    """Holds the fused kernel's encoding here, where the kernel cannot run:
    the packed test gives match_count_reference's radius test's pairs."""
    case = HAMMING_CASES[name]
    tags, allow = _hamming_case(case)
    L = case["L"]
    t = torch.from_numpy(np.frombuffer(b"".join(tags), np.uint8)
                         .reshape(-1, L).copy())
    a = torch.from_numpy(np.frombuffer(b"".join(allow), np.uint8)
                         .reshape(-1, L).copy())
    got = _packed_test_hits(t, a, case["d"])
    want = tdist.match_hits_reference(t, a, case["d"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _tw, _tm, _b, _aw, bits = tdist.pack_hit_inputs(t, a, case["d"])
    classes = len(set(b"".join(allow)))
    assert bits == (2 if classes <= 4 else 4 if classes <= 16 else 8)


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
