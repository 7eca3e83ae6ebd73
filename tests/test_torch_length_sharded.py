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


# --- csrc/dp_align_split.cu's schedules, emulated ---------------------------
#
# segment_fill: a cluster of C CTAs of W warps an alignment (segment_plan),
# band j on warp j mod (C W), each band's last row handed to the next band
# through a ring of R entries in the consumer's CTA (written across CTAs
# where the two warps lie in different CTAs), with the produced and
# consumed counts, the chunks of SEGMENT_RING_CHUNK entries and the
# producer's wait while the ring is full. The warps are generators stepped
# in a seeded random order; each warp step is the kernel's: 32 lanes of 12
# rows, the row above a strip from the lane before it at the step before.
# The cell is the plain version's (three_way: up on strict >, then left on
# strict >, else diag) in float32.

_LANES, _STRIP = tbatch.BAND_STRIPS, tbatch.STRIP_ROWS
_BAND = _LANES * _STRIP
_K = dp_kernels.SEGMENT_RING_CHUNK
_NEG = np.float32(-100000.0)


class _Stuck(Exception):
    pass


def _three_way(up, left, diag):
    up_gt_left = up > left
    up_wins = up_gt_left & (up > diag)
    left_wins = ~up_gt_left & (left > diag)
    return (np.where(up_wins, up, np.where(left_wins, left, diag)),
            np.where(up_wins, 1, np.where(left_wins, 2, 0)))


class _FillEmulation:
    """One tile of one part, one alignment, as the kernel runs it."""

    def __init__(self, ref, read, l1, l2, p, halo, tb, carry, corner, *,
                 row0, n, y0, y1, plan, stats):
        self.ref, self.read, self.l1, self.l2, self.p = ref, read, l1, l2, p
        self.halo, self.tb, self.carry, self.corner = halo, tb, carry, corner
        self.row0, self.n, self.y0, self.y1 = row0, n, y0, y1
        self.C, self.W, self.R = plan.C, plan.W, plan.R
        self.T = plan.C * plan.W
        self.rows = min(l1 - row0 + 1, n)
        self.ye = min(y1 - 1, l2)
        self.ncol = self.ye - y0 + 2
        self.nbands = -(-self.rows // _BAND)
        # each CTA's rings and counts
        self.ring = np.zeros((self.C, self.W, self.R, 3), np.float32)
        self.seq = np.full((self.C, self.W, self.R), -1)
        self.prod = np.zeros((self.C, self.W), np.int64)
        self.cons = np.zeros((self.C, self.W), np.int64)
        self.halo_out = np.zeros((y1 - y0 + 1, 3), np.float32)
        self.stats = stats

    def border(self, k):
        return (self.p[3] + np.float32(k) * self.p[4]) * self.p[5]

    def top(self, e):
        """Band 0's row above at column y0 - 1 + e."""
        if self.halo is not None:
            return self.halo[e]
        y = self.y0 - 1 + e
        if y == 0:
            return np.array([0.0, _NEG, _NEG], np.float32)
        g = self.border(y)
        return np.array([_NEG, g, g], np.float32)

    def fetch(self, rank, lw, base, c):
        need = min((c + 1) * _K, self.ncol)
        while self.prod[rank, lw] < base + need:
            yield False
        chunk = np.zeros((_K, 3), np.float32)
        for q in range(_K):
            e = c * _K + q
            if e < self.ncol:
                slot = (base + e) % self.R
                assert self.seq[rank, lw, slot] == base + e, "a stale entry"
                chunk[q] = self.ring[rank, lw, slot]
        self.cons[rank, lw] = base + need
        return chunk

    def room(self, g, obase, qend):
        """Lane 31 waits until the entries below qend fit the ring."""
        orank, olw = divmod(g, self.W)
        while self.cons[orank, olw] < obase + min(qend, self.ncol) - self.R:
            self.stats["full"] += 1
            yield False

    def put(self, g, obase, q, vals, src_rank):
        orank, olw = divmod(g, self.W)
        slot = (obase + q) % self.R
        assert self.seq[orank, olw, slot] < self.cons[orank, olw], (
            "an entry overwritten before it was consumed")
        self.ring[orank, olw, slot] = vals
        self.seq[orank, olw, slot] = obase + q
        self.stats["cross"] += orank != src_rank

    def publish(self, g, obase, qend):
        if qend >= 1:
            orank, olw = divmod(g, self.W)
            self.prod[orank, olw] = obase + min(qend, self.ncol)

    def warp(self, g):
        rank, lw = divmod(g, self.W)
        lanes = np.arange(_LANES)
        p = self.p
        ext_n, x1_n = p[4] * np.float32(1.0), p[3] + p[4] * np.float32(1.0)
        ext_t, x1_t = p[4] * p[5], p[3] + p[4] * p[5]
        h_band, h_lane = (self.n - 1) // _BAND, (self.n - 1) % _BAND // _STRIP
        h_r = (self.n - 1) % _STRIP
        halo_on = self.halo_out is not None and self.rows == self.n
        for band in range(g, self.nbands, self.T):
            self.stats["bands"].append((band, g))
            xl0 = band * _BAND + lanes * _STRIP + 1
            x0 = self.row0 - 1 + xl0
            active = xl0 <= self.rows
            nact = min(32, -(-(self.rows - band * _BAND) // _STRIP))
            xl = xl0[:, None] + np.arange(_STRIP)[None, :]
            real = xl <= self.rows
            rb = np.where(real, self.ref[np.clip(xl - 1, 0, self.n - 1)], 0)
            rsp = real & ((rb == 78) | (rb < 58))
            if self.y0 == 1:
                g0 = self.border(x0[:, None] + np.arange(_STRIP)[None, :])
                M = np.where(real, _NEG, np.float32(0)).astype(np.float32)
                D = np.where(real, g0, np.float32(0)).astype(np.float32)
                I = D.copy()
            else:
                c = self.carry[np.clip(xl - 1, 0, self.n - 1)]
                M, D, I = (np.where(real, c[..., z], np.float32(0))
                           .astype(np.float32) for z in range(3))
            base = (band - 1) // self.T * self.ncol if band > 0 else 0
            obase = band // self.T * self.ncol
            og = (band + 1) % self.T
            hand_on = band + 1 < self.nbands
            u = np.zeros((_LANES, 3), np.float32)
            u[1:] = np.stack([M[:-1, -1], D[:-1, -1], I[:-1, -1]], axis=1)
            if band > 0:
                chunk = yield from self.fetch(rank, lw, base, 0)
                u[0] = chunk[0]
            else:
                u[0] = self.top(0)
            if hand_on:
                yield from self.room(og, obase, 1)
                self.put(og, obase, 0, [M[31, -1], D[31, -1], I[31, -1]],
                         rank)
            if halo_on and band == h_band:
                self.halo_out[0] = [M[h_lane, h_r], D[h_lane, h_r],
                                    I[h_lane, h_r]]
            steps = self.ye - self.y0 + nact
            for t in range(steps):
                e = t + 1
                if t == 0 or e % _K == 0:   # a chunk starts: its waits
                    t_end = min((e // _K + 1) * _K - 1, steps)
                    if band > 0 and e % _K == 0 and e < self.ncol:
                        chunk = yield from self.fetch(rank, lw, base, e // _K)
                    if hand_on:
                        yield from self.room(og, obase, t_end - 30)
                v = np.zeros((_LANES, 3), np.float32)
                v[1:] = np.stack([M[:-1, -1], D[:-1, -1], I[:-1, -1]], axis=1)
                if band > 0:
                    v[0] = chunk[e % _K]
                elif e < self.ncol:
                    v[0] = self.top(e)
                y = self.y0 + t - lanes
                idx = np.nonzero(active & (y >= self.y0) & (y <= self.ye))[0]
                if idx.size:
                    self.step(idx, y[idx], t, x0, xl0, M, D, I, u,
                                         v, rb, rsp, (ext_n, x1_n, ext_t,
                                                      x1_t), hand_on, og,
                                         obase, rank, halo_on and band ==
                                         h_band, h_lane, h_r)
                if hand_on and t + 1 == t_end:     # a chunk ends
                    self.publish(og, obase, t_end - 30)
                yield True
            if hand_on:
                self.publish(og, obase, self.ncol)

    def step(self, idx, y, t, x0, xl0, M, D, I, u, v, rb, rsp, gaps, hand_on,
             og, obase, rank, halo_band, h_lane, h_r):
        p = self.p
        ext_n, x1_n, ext_t, x1_t = gaps
        ry = self.read[y - 1].astype(np.int64)
        ysp = (ry == 78) | (ry < 58)
        ms_eq = np.where(ysp, p[2], p[0]).astype(np.float32)
        ms_ne = np.where(ysp, p[2], p[1]).astype(np.float32)
        last_col = y == self.l2
        dm, dd, di = u[idx, 0], u[idx, 1], u[idx, 2]
        pm, pd, pi = v[idx, 0], v[idx, 1], v[idx, 2]
        byte = np.zeros((idx.size, _STRIP), np.int64)
        for r in range(_STRIP):
            x = x0[idx] + r
            lm, ld, li = M[idx, r], D[idx, r], I[idx, r]
            ms = np.where(rsp[idx, r], p[2],
                          np.where(rb[idx, r] == ry, ms_eq, ms_ne))
            term = last_col | (x == self.l1)
            ext = np.where(term, ext_t, ext_n)
            x1 = np.where(term, x1_t, x1_n)
            nm, m_dir = _three_way(dd + ms, di + ms, dm + ms)
            nd, d_dir = _three_way(pd + ext, pi + x1, pm + x1)
            ni, i_dir = _three_way(ld + x1, li + ext, lm + x1)
            hit = last_col & (x == self.l1)
            if hit.any():
                k = np.nonzero(hit)[0][0]
                self.corner[:] = [nm[k], nd[k], ni[k]]
            M[idx, r], D[idx, r], I[idx, r] = nm, nd, ni
            dm, dd, di, pm, pd, pi = lm, ld, li, nm, nd, ni
            byte[:, r] = m_dir | (d_dir << 2) | (i_dir << 4)
        xl = xl0[idx, None] + np.arange(_STRIP)[None, :]
        real = xl <= self.rows
        self.tb[(xl - 1)[real], np.broadcast_to(y[:, None] - 1,
                                                xl.shape)[real]] = byte[real]
        q = y - self.y0 + 1
        if hand_on and idx[-1] == 31:
            self.put(og, obase, int(q[-1]), [M[31, -1], D[31, -1],
                                              I[31, -1]], rank)
        if halo_band and h_lane in idx:
            k = int(np.nonzero(idx == h_lane)[0][0])
            self.halo_out[q[k]] = [M[h_lane, h_r], D[h_lane, h_r],
                                   I[h_lane, h_r]]
        for k in np.nonzero(y == self.y1 - 1)[0]:
            lane = idx[k]
            for r in range(_STRIP):
                if xl0[lane] + r <= self.rows:
                    self.carry[xl0[lane] + r - 1] = [M[lane, r], D[lane, r],
                                                     I[lane, r]]
        u[idx] = v[idx]

    def run(self, rng):
        """Step the warps in a random order, each at a speed of its own
        (a round steps warp g with probability speed[g]), until every band
        is done; a round in which every warp was tried and none moved is a
        deadlock."""
        live = [(self.warp(g), s) for g, s in
                enumerate(rng.uniform(0.15, 1.0, self.T))]
        while live:
            moved, tried_all = False, True
            for i in rng.permutation(len(live)):
                gen, speed = live[i]
                if rng.random() > speed:
                    tried_all = False
                    continue
                try:
                    moved |= next(gen) is not False
                except StopIteration:
                    live[i] = None
                    moved = True
            live = [w for w in live if w is not None]
            if live and not moved and tried_all:
                raise _Stuck("every warp waits")


def _emulated_fill(plan_kw, stats, seed):
    """A drop-in for batch.fill_segment_reference that runs the kernel's
    schedule for each alignment over segment_plan(**plan_kw)."""
    rng = np.random.default_rng(seed)

    def fill(refs, reads, ref_lens, read_lens, params, halo, tb, carry,
             corner, *, row0, n1, n2, y0, y1):
        B, n = tb.shape[0], tb.shape[1]
        plan = plan_kw.get("plan") or dp_kernels.segment_plan(
            n, y1 - y0, 168, **plan_kw)
        stats["plans"].add(tuple(plan[:3]))
        halo_out = torch.zeros((B, y1 - y0 + 1, 3))
        p = params.numpy().astype(np.float32)
        for b in range(B):
            l1, l2 = int(ref_lens[b]), int(read_lens[b])
            assert 0 <= l1 <= n1 - 1 and 0 <= l2 <= n2 - 1
            if l1 < row0 or l2 < y0:
                continue
            em = _FillEmulation(
                refs[b].numpy(), reads[b].numpy(), l1, l2, p,
                None if halo is None else halo[b].numpy(), tb[b].numpy(),
                carry[b].numpy(), corner[b].numpy(), row0=row0, n=n, y0=y0,
                y1=y1, plan=plan, stats=stats)
            em.run(rng)
            halo_out[b] = torch.from_numpy(em.halo_out)
            assert sorted(j for j, _g in stats["bands"]) == list(
                range(em.nbands))
            assert all(g == j % em.T for j, g in stats["bands"])
            stats["bands"].clear()
        return halo_out

    return fill


def _ragged(rng, B, n1, n2, bounds):
    refs = rng.choice(ALPHABET, (B, n1 - 1)).astype(np.uint8)
    reads = rng.choice(ALPHABET, (B, n2 - 1)).astype(np.uint8)
    ref_lens = rng.integers(0, n1, B).astype(np.int32)
    read_lens = rng.integers(0, n2, B).astype(np.int32)
    ref_lens[0], read_lens[0] = n1 - 1, n2 - 1
    ref_lens[1], read_lens[1] = bounds[1] - 1, n2 - 1     # a part boundary
    m = min(n1, n2) - 1                                    # a diagonal path
    refs[2, :m] = reads[2, :m]
    ref_lens[2], read_lens[2] = m, m
    return refs, reads, ref_lens, read_lens


@pytest.mark.parametrize("n1,n2,parts,tile,limits", [
    (1200, 13, 1, 7, (1, 1)),      # four bands on one warp
    (1200, 13, 1, 7, (1, 3)),      # four bands on three CTAs of a warp
    (1200, 9, 2, 1, (1, 1)),       # tiles of one column, bands in turn
    (1200, 41, 5, 40, (2, 1)),     # five parts of 240 rows
    (800, 25, 1, 40, (2, 2)),      # every band in flight over two CTAs
    (800, 25, 2, 7, (1, 2)),
    (800, 13, 5, 1, (1, 1)),
    (200, 25, 2, 7, None)],        # a part of one partial band
    ids=["warp-4bands", "cta3-4bands", "tile1", "parts5", "cluster2",
         "parts2", "parts5-tile1", "partial"])
def test_fill_schedule_emulation_matches_jax(monkeypatch, n1, n2, parts,
                                             tile, limits):
    """The kernel's fill schedule over segment_plan (bands in turn on
    C x W warps, rings with back-pressure, cross-CTA writes) in place of
    the plain fill: length_sharded_align's scores, ops and n_ops equal
    the JAX package's align_batch_device, and every part's traceback,
    byte for byte, the plain fill_segment_reference's."""
    from clique_tpu.align.batch import align_batch_device
    from clique_tpu.align.batch import scoring_to_params as jax_params
    from clique_tpu.align.scoring import AffineScoring as JaxAffine

    rng = np.random.default_rng(n1 + 10 * n2 + parts + tile)
    B = 4
    bounds = split_rows(n1, parts, False)
    refs, reads, ref_lens, read_lens = _ragged(rng, B, n1, n2, bounds)
    params = np.asarray(jax_params(JaxAffine.aligner_default()))
    kw = dict(n1=n1, n2=n2, tile=tile, return_parts=True)
    want = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                                read_lens, params, **kw)
    stats = {"plans": set(), "bands": [], "full": 0, "cross": 0}
    plan_kw = {} if limits is None else dict(max_warps=limits[0],
                                             max_cluster=limits[1])
    monkeypatch.setattr(tbatch, "fill_segment_reference",
                        _emulated_fill(plan_kw, stats, n1 + tile))
    got = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                               read_lens, params, **kw)
    single, _ = align_batch_device(refs, reads, ref_lens, read_lens,
                                   np.maximum(ref_lens, read_lens), params,
                                   n1=n1, n2=n2)
    _assert_same(got, (single.score, single.ops, single.n_ops))
    for g, w in zip(got[3], want[3]):
        assert torch.equal(g["traceback"], w["traceback"])
    if limits is not None and limits[1] > 1 and max(
            c for c, _w, _r in stats["plans"]) > 1:
        assert stats["cross"] > 0


def test_fill_schedule_emulation_ring_back_pressure(monkeypatch):
    """Rings of two chunks (32 entries) against tiles of 60 columns with
    every band in flight: the producers wait while the rings are full
    (counted), and the results are still the plain fill's."""
    rng = np.random.default_rng(5)
    B, n1, n2, parts = 3, 1000, 61, 1
    bounds = split_rows(n1, parts, False)
    refs, reads, ref_lens, read_lens = _ragged(rng, B, n1, n2, bounds)
    kw = dict(n1=n1, n2=n2, tile=60, return_parts=True)
    want = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                                read_lens, _params(), **kw)
    plan = dp_kernels.SegmentPlan(C=2, W=2, R=32, smem=0, bands=3, regs=168)
    stats = {"plans": set(), "bands": [], "full": 0, "cross": 0}
    monkeypatch.setattr(tbatch, "fill_segment_reference",
                        _emulated_fill({"plan": plan}, stats, 9))
    got = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                               read_lens, _params(), **kw)
    _assert_same(got, want[:3])
    assert torch.equal(got[3][0]["traceback"], want[3][0]["traceback"])
    assert stats["full"] > 0 and stats["cross"] > 0


def test_fill_schedule_in_turn_needs_a_whole_row():
    """Why segment_plan gives warps that take bands in turn a ring of a
    whole tile row: with one warp, three bands and a ring of two chunks
    for a 60-column tile, band 0 waits for band 1 to consume, and band 1
    can start only when band 0 is done."""
    rng = np.random.default_rng(3)
    n, w = 1000, 60
    ref = rng.choice(ALPHABET, n).astype(np.uint8)
    read = rng.choice(ALPHABET, w).astype(np.uint8)
    p = _params().numpy()
    args = (ref, read, n, w, p, None, np.zeros((n, w), np.uint8),
            np.zeros((n, 3), np.float32), np.zeros(3, np.float32))
    kw = dict(row0=1, n=n, y0=1, y1=w + 1)
    stats = {"bands": [], "full": 0, "cross": 0}
    bad = dp_kernels.SegmentPlan(C=1, W=1, R=32, smem=0, bands=3, regs=168)
    with pytest.raises(_Stuck):
        _FillEmulation(*args, plan=bad, stats=stats, **kw).run(rng)
    plan = dp_kernels.segment_plan(n, w, 168, max_warps=1, max_cluster=1)
    assert plan.R >= w + 1
    _FillEmulation(*args, plan=plan, stats=stats, **kw).run(rng)


@pytest.mark.parametrize("regs", [96, 128, 168, 200, 255])
def test_segment_plan_covers_every_band_once(regs):
    """Over parts of 1 to 300 bands and tiles of 1 to 16,384 columns: C <=
    8 CTAs of W warps within the registers (8 a thread at a time) and the
    kernel's launch bounds, shared memory within an H100 block's, every
    band of the part on exactly one warp (band j on warp j mod C W), all in
    flight over the fewest warps a CTA where 8 CTAs of the W warps hold
    them, else rings of a whole tile row."""
    wmax = min(12, 65536 // (32 * (-(-regs // 8) * 8)))
    for bands in (1, 2, 11, 12, 13, 21, 43, 86, 96, 97, 120, 300):
        for w in (1, 7, 40, 255, 256, 512, 1023, 2048, 16384):
            n = bands * 384 - 5
            try:
                plan = dp_kernels.segment_plan(n, w, regs)
            except ValueError:
                # only where warps take bands in turn and no ring of a
                # whole row fits even one warp a CTA
                assert bands > 8 * wmax and dp_kernels.segment_smem_bytes(
                    w, 1, 1 << w.bit_length()) > 232448
                continue
            T = plan.C * plan.W
            assert plan.bands == bands and 1 <= plan.C <= 8
            assert 1 <= plan.W <= wmax and plan.smem <= 232448
            assert plan.smem == dp_kernels.segment_smem_bytes(w, plan.W,
                                                              plan.R)
            assert plan.R >= 32 and plan.R & (plan.R - 1) == 0
            owners = [j % T for j in range(bands)]
            assert sorted({(j, g) for j, g in enumerate(owners)}) == [
                (j, j % T) for j in range(bands)]
            if bands <= 8 * wmax:
                assert T >= bands            # every band in flight
                # spread over the most CTAs: no fewer warps a CTA would do
                assert plan.W == -(-bands // 8)
                assert (plan.C - 1) * plan.W < bands
            else:
                assert plan.R >= w + 1 and plan.C == 8
            if T < bands:
                assert plan.R >= w + 1


# segment_walk: a warp over windows of SEGMENT_WALK_STEPS steps of a band,
# SEGMENT_WALK_SLOTS of them in shared memory, the next ones fetched ahead
# (the steps below the current window; in a band's top strip the end of
# the band above), each a copy that lands late; a window in no slot is a
# miss and waits for a copy of its own.

_S, _NS = dp_kernels.SEGMENT_WALK_STEPS, dp_kernels.SEGMENT_WALK_SLOTS


class _WalkEmulation:
    def __init__(self, wave, n, n2):
        self.wave, self.n, self.n2 = wave, n, n2
        self.tj, self.tt, self.tn = [-1] * _NS, [-1] * _NS, [-1] * _NS
        self.busy = [False] * _NS
        self.data = [None] * _NS
        self.cur, self.cj, self.ct0, self.ct1 = 0, -1, 0, 0
        self.top_asked = False
        self.stats = {"reads": 0, "misses": 0, "ahead": 0, "copies": 0}

    def lanes(self, j):
        strips = -(-self.n // _STRIP)
        return min(32, strips - 32 * j)

    def rs(self, j):
        return -(-self.lanes(j) * _STRIP // 16) * 16

    def base(self, j):
        return j * (self.n2 + 30) * self.rs(0)

    def wait(self, s):
        j, t0, steps = self.tj[s], self.tt[s], self.tn[s]
        lo = self.base(j) + t0 * self.rs(j)
        self.data[s] = self.wave[lo:lo + steps * self.rs(j)].copy()
        self.busy[s] = False

    def issue(self, s, j, t0):
        if self.busy[s]:
            self.wait(s)
        steps = min(_S, self.n2 - 2 + self.lanes(j) - t0)
        assert steps > 0
        self.tj[s], self.tt[s], self.tn[s] = j, t0, steps
        self.data[s] = None                 # lands when waited for
        self.busy[s] = True
        self.stats["copies"] += 1

    def holds(self, s, j, t):
        return self.tj[s] == j and self.tt[s] <= t < self.tt[s] + self.tn[s]

    def plan(self, top, y):
        want = []
        if top:
            want.append((self.cj - 1, max(0, y + self.lanes(self.cj - 1) - 2
                                          - (_S - 1))))
        for i in range(1, _NS):
            t0 = self.ct0 - i * _S
            if len(want) < _NS - 1 and t0 + _S > 0:
                want.append((self.cj, max(0, t0)))
        keep = {self.cur}
        have = []
        for j, t0 in want:
            found = [s for s in range(_NS) if s != self.cur
                     and (self.tj[s], self.tt[s]) == (j, t0)]
            have.append(bool(found))
            keep.update(found)
        for (j, t0), h in zip(want, have):
            if not h:
                free = [s for s in range(_NS) if s not in keep]
                idle = [s for s in free if not self.busy[s]]
                s = (idle or free)[0]
                keep.add(s)
                self.issue(s, j, t0)
                self.stats["ahead"] += 1

    def use(self, j, t, y):
        held = [k for k in range(_NS) if self.holds(k, j, t)]
        if held:
            s = held[0]
        else:
            self.stats["misses"] += 1
            empty = [k for k in range(_NS) if k != self.cur
                     and self.tj[k] < 0]
            s = empty[0] if empty else (1 if self.cur == 0 else 0)
            self.issue(s, j, max(0, t - (_S - 1)))
        if self.busy[s]:
            self.wait(s)
        self.cur, self.cj = s, j
        self.ct0, self.ct1 = self.tt[s], self.tt[s] + self.tn[s]
        self.top_asked = False
        self.plan(False, y)

    def byte(self, x, y, row0):
        """The byte of cell (x, y); before it, the kernel's checks: the
        window (at the walk's first cell only that), then the top strip."""
        xl = x - row0 + 1
        j, xr = divmod(xl - 1, _BAND)
        t = y + xr // _STRIP - 1
        first = self.cj < 0
        if j != self.cj or not self.ct0 <= t < self.ct1:
            self.use(j, t, y)
        if not first and not self.top_asked and j > 0 and xr < _STRIP:
            self.top_asked = True
            self.plan(True, y)
        s = self.cur
        assert not self.busy[s] and self.holds(s, j, t), "a stale window"
        self.stats["reads"] += 1
        return int(self.data[s][(t - self.ct0) * self.rs(j) + xr])


def _walk_part(em, state, ops, l1, l2, params, corner, row0, n):
    """The walk kernel's steps for one alignment over one part (state and
    ops in place, as walk_segment_reference)."""
    own = (row0 <= l1 < row0 + n) or (l1 == 0 and row0 == 1)
    if own:
        c = torch.from_numpy(corner)[None].clone()
        if l1 == 0 or l2 == 0:
            g = float(tbatch._border(torch.tensor(l1 + l2), params))
            c[0] = torch.tensor([0.0, -100000.0, -100000.0]) if (
                l1 == 0 and l2 == 0) else torch.tensor([-100000.0, g, g])
        z0, score = tbatch.corner_to_z0_score(c)
        x, y, z = l1, l2, int(z0[0])
        sb = int(score.view(torch.int32)[0])
    else:
        x, y, z, sb = (int(v) for v in state)
        if x <= 0 or y <= 0:
            return
    while x >= row0 and y > 0:
        b = em.byte(x, y, row0)
        ops[x + y] = z
        x -= z != 2
        y -= z != 1
        z = (b >> (2 * z)) & 3
    if x > 0 and y > 0:
        state[:] = torch.tensor([x, y, z, sb], dtype=torch.int32)
        return
    ops[1:x + y + 1] = tbatch.OP_DEL if x > 0 else tbatch.OP_INS
    state[:] = torch.tensor([0, 0, z, sb], dtype=torch.int32)


def _rows_to_wave(rows, n, n2):
    """A part's traceback [n, n2 - 1] in the kernels' layout."""
    x = torch.arange(1, n + 1)[:, None].expand(n, n2 - 1)
    y = torch.arange(1, n2)[None, :].expand(n, n2 - 1)
    off = tbatch.wavefront_offset(x, y, n1=n + 1, n2=n2).reshape(-1)
    wave = np.zeros(tbatch.traceback_bytes(n + 1, n2), np.uint8)
    wave[off.numpy()] = rows.reshape(-1).numpy()
    return wave


@pytest.mark.parametrize("parts", [1, 3])
def test_walk_prefetch_covers_every_step(monkeypatch, parts):
    """The walk kernel's windows emulated over each part's traceback (in
    the kernels' layout), from the state the part below handed on: each
    step reads its byte from a landed window whose tag holds it (the
    emulation asserts it), the state and ops equal
    walk_segment_reference's, and a window the prediction missed is
    counted: one where a walk starts in a part, and none at the band
    crossings of a path near the diagonal. Paths: band crossings, paths
    that leave a part upward, all-deletion and all-insertion borders,
    corners on row 0 and column 0, the origin."""
    rng = np.random.default_rng(41 + parts)
    B, n1, n2 = 7, 1300, 1001
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = rng.choice(bases, (B, n1 - 1)).astype(np.uint8)
    reads = rng.choice(bases, (B, n2 - 1)).astype(np.uint8)
    reads[0] = refs[0, :n2 - 1]          # near the diagonal
    flip = rng.random(n2 - 1) < 0.03
    reads[0, flip] = rng.choice(bases, int(flip.sum()))
    # 1: mostly deletions (40 columns over 1,299 rows); 2: a corner on row
    # 0 (insertions only); 3: on column 0 (deletions only); 4: mostly
    # insertions; 5: a long random path; 6: the origin
    ref_lens = np.array([1000, 1299, 0, 900, 5, 1299, 0], np.int32)
    read_lens = np.array([1000, 40, 600, 0, 1000, 1000, 0], np.int32)
    walks = []
    plain = dp_kernels.walk_segment

    def recorded(bufs, rl, dl, params, state, ops, *, row0, **kw):
        before = (state.clone(), ops.clone())
        plain(bufs, rl, dl, params, state, ops, row0=row0, **kw)
        walks.append((bufs, row0, before, (state.clone(), ops.clone())))

    monkeypatch.setattr(dp_kernels, "walk_segment", recorded)
    got = length_sharded_align(["cpu"] * parts, refs, reads, ref_lens,
                               read_lens, _params(), n1=n1, n2=n2,
                               bounds=split_rows(n1, parts, True))
    assert [w[1] for w in walks] == split_rows(n1, parts, True)[
        -2::-1].tolist()
    starts = misses = 0
    for bufs, row0, (state, ops), (state_p, ops_p) in walks:
        n = bufs.carry.shape[1]
        for b in range(B):
            em = _WalkEmulation(_rows_to_wave(bufs.tb[b], n, n2), n, n2)
            _walk_part(em, state[b], ops[b], int(ref_lens[b]),
                       int(read_lens[b]), _params(), bufs.corner[b].numpy(),
                       row0, n)
            starts += em.stats["reads"] > 0
            misses += em.stats["misses"]
            if b == 0:
                assert em.stats["misses"] == (em.stats["reads"] > 0), (
                    row0, em.stats)
        assert torch.equal(state, state_p)
        assert torch.equal(ops, ops_p)
    assert starts <= misses <= starts + 4
    _assert_same(got, _dp_align(refs, reads, ref_lens, read_lens, n1, n2))


def test_split_tile():
    """The default tile: the whole row for one part, else the power of
    two nearest sqrt((n2 - 1) ramp / (k - 1)) for the ramp of the tallest
    part's bands; at B=2, n1=n2=16,385 the widths whose walls were least
    in the sweep on the card (PERF.md §6)."""
    from clique_tpu_torch.parallel.mesh import split_tile

    n2 = 16385
    assert split_tile(n2, 16384, 1) == 16384
    assert split_tile(n2, 8064, 2) == 4096
    assert split_tile(n2, 4224, 4) == 2048
    assert split_tile(n2, 2304, 8) == 1024
    assert split_tile(40, 415, 2) == 39          # never past the row
    assert split_tile(3, 1, 5) == 2              # the whole (short) row
