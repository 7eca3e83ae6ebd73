"""Batched 3-plane affine-gap DP (PyTorch).

Counterpart of clique_tpu/align/batch.py::align_batch_device in every mode
but the TPU-only ones (the Pallas route, the wave, fetch-fuse):

- global fills with per-element lengths, the `both`, `ref_n_only` and
  `none` special-byte rules, tie order up > left > diag (diag wins ties)
  or keep-last (`tie_order="last"`, the inversion-aware fill's), a full
  band or a band of half-width `bandwidth` around f64 band centers; the
  traceback walk from the (l1, l2) corner and the op epilogue fused into
  one uint8 row per alignment;
- local (Waterman-Eggert) fills with the full band and tie order
  up > left > diag (the inversion screen's), per-plane zero flags and the
  running 3D argmax, walked from the argmax cell until a border or a zero
  cell.

`fill_reference`, `walk_reference`, `fill_local_reference` and
`walk_local_reference` are the plain PyTorch versions; the hand-written
CUDA kernels (align/dp_kernels.py, csrc/) compute the same bytes. Each
kernel fuses its fill and its walk and keeps its traceback in a wavefront
layout of interior cells (`traceback_bytes`); `wavefront_to_tb` lays the
global one out as fill_reference's, `local_wavefront_to_tb` the local one
(one byte a cell, the zero flags inside it) as fill_local_reference's.
`align_batch` and `align_batch_local` run the kernels on CUDA tensors and
the plain versions on CPU tensors.

Exactness: every scoring constant is dyadic and every intermediate a sum
of < 2^18-magnitude dyadics, so float32 decisions are exact on any backend
(clique_tpu/align/batch.py:18-21) and results compare byte for byte.

The host numpy helpers at the end are copies of clique_tpu/align/batch.py's
(that module imports jax); each keeps its body and cites its source line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from clique_tpu_torch.align.scoring import MAX_NEG_SCORE, AffineScoring

# direction codes (== source plane), same as align/cpu.py
DIAG, UP, LEFT = 0, 1, 2
# a packed traceback byte with all three planes set to UP (fresh-matrix value)
_TB_FRESH = UP | (UP << 2) | (UP << 4)

# op codes emitted by the traceback walk
OP_MATCH, OP_DEL, OP_INS, OP_DONE = 0, 1, 2, 3

SPECIAL_MODES = ("both", "ref_n_only", "none")
TIE_ORDERS = ("ref", "last")

# the most traceback bytes (B * traceback_bytes(n1, n2) for a global
# fill, B * local_traceback_bytes(n1, n2, device) for a local one) one
# launch may hold: callers split larger batches into groups. One long
# read's whole-read sub-DP at n1 = n2 = 4096 takes 16.8 MB.
MAX_TRACEBACK_BYTES = 2 << 30

# The kernels' traceback layout (csrc/dp_common.cuh), which stores interior
# cells only, in wavefront order: lane k of a warp owns the strip of
# STRIP_ROWS rows 12k+1..12k+12 of a row band of 32 strips and computes
# column y at step t = y + k - 1; a band's step is one row of the lanes'
# 12-byte strips side by side, padded to 16 bytes, and band j of nl strips
# holds n2 - 2 + nl steps. A global byte holds the three planes'
# directions; a local byte holds, for each plane z, the direction where
# plane z is not 0.0 and LOCAL_ZERO where it is.
STRIP_ROWS = 12
BAND_STRIPS = 32
LOCAL_ZERO = 3


def _strips(n1: int) -> int:
    return -(-(n1 - 1) // STRIP_ROWS)


def _row_bytes(nl):
    return (nl * STRIP_ROWS + 15) // 16 * 16


def traceback_bytes(n1: int, n2: int) -> int:
    """Traceback bytes of one global alignment in the kernel's layout."""
    nb = -(-_strips(n1) // BAND_STRIPS)
    nl = _strips(n1) - BAND_STRIPS * (nb - 1)
    return ((nb - 1) * (n2 + 30) * _row_bytes(BAND_STRIPS)
            + (n2 - 2 + nl) * _row_bytes(nl))


def local_traceback_bytes(n1: int, n2: int, device) -> int:
    """Traceback bytes of one local alignment on `device`: the kernel's
    layout on the card (one byte an interior cell, the zero flags inside
    it); fill_local_reference's traceback and zero flags on the CPU."""
    if torch.device(device).type == "cuda":
        return traceback_bytes(n1, n2)
    return 2 * (n1 + n2 - 1) * n1


def wavefront_offset(x, y, *, n1: int, n2: int):
    """Byte offset of interior cell (x, y) in the kernels' layout (int64
    tensors of equal shape, x >= 1, y >= 1)."""
    rows = BAND_STRIPS * STRIP_ROWS
    j, xr = (x - 1) // rows, (x - 1) % rows
    nl = torch.clamp(_strips(n1) - BAND_STRIPS * j, max=BAND_STRIPS)
    t = y + xr // STRIP_ROWS - 1
    return j * (n2 + 30) * _row_bytes(BAND_STRIPS) + t * _row_bytes(nl) + xr


def _wavefront_index(ref_lens, read_lens, n1: int, n2: int):
    """For every interior cell (1 <= x <= l1, 1 <= y <= l2) of rows whose
    lengths lie in the bucket: (b, x, y, byte offset in the row's layout)."""
    dev = ref_lens.device
    l1 = ref_lens.to(torch.int64)[:, None, None]
    l2 = read_lens.to(torch.int64)[:, None, None]
    ok = (l1 >= 0) & (l1 <= n1 - 1) & (l2 >= 0) & (l2 <= n2 - 1)
    x = torch.arange(1, n1, device=dev)[None, :, None]
    y = torch.arange(1, n2, device=dev)[None, None, :]
    bi, xi, yi = torch.nonzero(ok & (x <= l1) & (y <= l2), as_tuple=True)
    xi, yi = xi + 1, yi + 1
    return bi, xi, yi, wavefront_offset(xi, yi, n1=n1, n2=n2)


def _check_wave(wave, n1: int, n2: int):
    B = wave.shape[0]
    if tuple(wave.shape) != (B, traceback_bytes(n1, n2)):
        raise ValueError(f"the traceback must be [{B}, "
                         f"{traceback_bytes(n1, n2)}], got "
                         f"{list(wave.shape)}")


def tb_to_wavefront(tb, ref_lens, read_lens, *, n1: int, n2: int):
    """fill_reference's traceback [B, n1+n2-1, n1] -> the global kernel's
    layout [B, traceback_bytes(n1, n2)]: interior cells at their wavefront
    offsets; every other byte is 0 (the kernel leaves them unwritten)."""
    out = torch.zeros((tb.shape[0], traceback_bytes(n1, n2)),
                      dtype=torch.uint8, device=tb.device)
    bi, xi, yi, off = _wavefront_index(ref_lens, read_lens, n1, n2)
    out[bi, off] = tb[bi, xi + yi, xi]
    return out


def wavefront_to_tb(wave, ref_lens, read_lens, *, n1: int, n2: int):
    """The global kernel's traceback [B, traceback_bytes(n1, n2)] laid out
    as fill_reference's [B, n1+n2-1, n1]: interior cells from the kernel,
    _TB_FRESH everywhere else (rows whose lengths lie outside the bucket are
    fresh throughout), so it compares with fill_reference cell by cell."""
    _check_wave(wave, n1, n2)
    tb = torch.full((wave.shape[0], n1 + n2 - 1, n1), _TB_FRESH,
                    dtype=torch.uint8, device=wave.device)
    bi, xi, yi, off = _wavefront_index(ref_lens, read_lens, n1, n2)
    tb[bi, xi + yi, xi] = wave[bi, off]
    return tb


def local_tb_to_wavefront(tb, zflags, ref_lens, read_lens, *, n1: int,
                          n2: int):
    """fill_local_reference's traceback and zero flags [B, n1+n2-1, n1] ->
    the local kernel's layout [B, traceback_bytes(n1, n2)]: an interior
    cell's byte holds, for each plane z, (tb >> 2z) & 3 where bit z of its
    zero flags is clear and LOCAL_ZERO where it is set; every other byte is
    0 (the kernel leaves them unwritten)."""
    out = torch.zeros((tb.shape[0], traceback_bytes(n1, n2)),
                      dtype=torch.uint8, device=tb.device)
    bi, xi, yi, off = _wavefront_index(ref_lens, read_lens, n1, n2)
    t = tb[bi, xi + yi, xi].to(torch.int64)
    zf = zflags[bi, xi + yi, xi].to(torch.int64)
    byte = torch.zeros_like(t)
    for z in range(3):
        field = torch.where((zf >> z) & 1 == 1, LOCAL_ZERO, (t >> 2 * z) & 3)
        byte |= field << 2 * z
    out[bi, off] = byte.to(torch.uint8)
    return out


def local_wavefront_to_tb(wave, ref_lens, read_lens, *, n1: int, n2: int):
    """The local kernel's traceback [B, traceback_bytes(n1, n2)] -> (tb,
    zflags) [B, n1+n2-1, n1] laid out as fill_local_reference's. On
    interior cells the zero flags are exact, and so is each plane's
    direction where its flag is clear (a plane that holds 0.0 reads UP).
    Every other cell is _TB_FRESH with all three flags set (rows whose
    lengths lie outside the bucket throughout)."""
    _check_wave(wave, n1, n2)
    shape = (wave.shape[0], n1 + n2 - 1, n1)
    tb = torch.full(shape, _TB_FRESH, dtype=torch.uint8, device=wave.device)
    zflags = torch.full(shape, 7, dtype=torch.uint8, device=wave.device)
    bi, xi, yi, off = _wavefront_index(ref_lens, read_lens, n1, n2)
    byte = wave[bi, off].to(torch.int64)
    t = torch.zeros_like(byte)
    zf = torch.zeros_like(byte)
    for z in range(3):
        field = (byte >> 2 * z) & 3
        zero = field == LOCAL_ZERO
        t |= torch.where(zero, UP, field) << 2 * z
        zf |= zero.to(torch.int64) << z
    tb[bi, xi + yi, xi] = t.to(torch.uint8)
    zflags[bi, xi + yi, xi] = zf.to(torch.uint8)
    return tb, zflags


class BatchAlignment(NamedTuple):
    """Result of a batched fill + traceback (clique_tpu batch.py:53-61)."""

    score: torch.Tensor       # [B] f32 alignment score
    start_z: torch.Tensor     # [B] i32 starting plane
    ops: torch.Tensor         # [B, T] uint8 op codes, OP_DONE-padded
    n_ops: torch.Tensor       # [B] i32 number of valid ops
    ops_packed: torch.Tensor  # [B, ceil(T/4)] uint8, 4 ops per byte


class LocalBatchAlignment(NamedTuple):
    """Waterman-Eggert result (clique_tpu batch.py:64-78): the ops cover
    the local segment from (ref_start, read_start), where the walk stopped,
    to (ref_end, read_end), the 3D argmax cell."""

    score: torch.Tensor       # [B] f32
    start_z: torch.Tensor     # [B] i32 starting plane at the argmax cell
    ops: torch.Tensor         # [B, T] uint8
    n_ops: torch.Tensor       # [B] i32
    ops_packed: torch.Tensor  # [B, ceil(T/4)] uint8
    ref_start: torch.Tensor   # [B] i32
    read_start: torch.Tensor  # [B] i32
    ref_end: torch.Tensor     # [B] i32
    read_end: torch.Tensor    # [B] i32


def scoring_to_params(scoring: AffineScoring, device) -> torch.Tensor:
    """float32 [6] scoring vector (clique_tpu batch.py:655-661)."""
    scoring.assert_dyadic()
    return torch.tensor(
        [scoring.match_score, scoring.mismatch_score,
         scoring.special_character_score, scoring.gap_open,
         scoring.gap_extend, scoring.final_gap_multiplier],
        dtype=torch.float32, device=device)


def params_from_jax(np_params, device) -> torch.Tensor:
    """Carry the JAX package's scoring vector (as numpy) across."""
    arr = np.asarray(np_params, dtype=np.float32)
    if arr.shape != (6,):
        raise ValueError(f"scoring params must have shape (6,), got "
                         f"{arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def _check_lens(ref_lens, read_lens, n1: int, n2: int):
    if ref_lens.numel() and (int(ref_lens.min()) < 0
                             or int(ref_lens.max()) > n1 - 1):
        raise ValueError(f"ref_lens must lie in [0, {n1 - 1}]")
    if read_lens.numel() and (int(read_lens.min()) < 0
                              or int(read_lens.max()) > n2 - 1):
        raise ValueError(f"read_lens must lie in [0, {n2 - 1}]")


def check_modes(special_mode: str, tie_order: str, bandwidth,
                band_centers):
    if special_mode not in SPECIAL_MODES:
        raise ValueError(f"special_mode must be one of {SPECIAL_MODES}")
    if tie_order not in TIE_ORDERS:
        raise ValueError(f"tie_order must be one of {TIE_ORDERS}")
    if (bandwidth is None) != (band_centers is None):
        raise ValueError("a band needs both bandwidth and band_centers")


def _three_way_max(up, left, diag):
    """three_way_max_and_direction (clique_tpu batch.py:81-88): up on
    strict >, then left on strict >, else diag (ties -> diag)."""
    up_gt_left = up > left
    up_wins = up_gt_left & (up > diag)
    left_wins = ~up_gt_left & (left > diag)
    val = torch.where(up_wins, up, torch.where(left_wins, left, diag))
    direction = torch.where(up_wins, UP, torch.where(left_wins, LEFT, DIAG))
    return val, direction.to(torch.uint8)


def _max_last3(a, b, c, dir_a, dir_b, dir_c):
    """Rust `max_by` keep-LAST over the candidate list [a, b, c]: c wins
    ties against everything, b against a (clique_tpu batch.py:91-100)."""
    ab = torch.maximum(a, b)
    val = torch.maximum(ab, c)
    direction = torch.where(c >= ab, dir_c,
                            torch.where(b >= a, dir_b, dir_a))
    return val, direction.to(torch.uint8)


def _shift_down(arr):
    """[B, X] -> value at index x-1 (x axis), zero-filled at x=0."""
    return torch.nn.functional.pad(arr[:, :-1], (1, 0))


def _border(k, params):
    """The gap border of row or column k >= 1: (go + k * ge) * fgm."""
    return (params[3] + k.to(torch.float32) * params[4]) * params[5]


def _match_score(rx, ry, special_mode, m_s, mm_s, sp_s):
    """The substitution score of reference bytes rx against read bytes ry
    under a special-byte rule (clique_tpu batch.py:241-250)."""
    if special_mode == "ref_n_only":
        # rust-bio-compat rule (alignment_functions.rs:55): only a
        # reference-side N scores as a guaranteed match
        special = rx == 78
    elif special_mode == "none":
        # InversionScoring has no wildcard rule
        special = torch.zeros_like(rx, dtype=torch.bool)
    else:
        special = (rx == 78) | (ry == 78) | (rx < 58) | (ry < 58)
    return torch.where(special, sp_s, torch.where(rx == ry, m_s, mm_s))


def _cell(diag, up, left, ms, lge, params, *, tie_order, local, zero, neg):
    """One cell's three planes from its neighbours' (M, D, I): the diagonal
    (x-1, y-1), up (x-1, y) and left (x, y-1) ones; ms the substitution
    score, lge the gap extension with the terminal-gap multiplier applied.
    Returns ((M, dir), (D, dir), (I, dir)) (clique_tpu batch.py:252-285)."""
    (dm, dd, di), (um, ud, ui), (lm, ld, li) = diag, up, left
    go, ge = params[3], params[4]
    x1 = go + lge
    mm_val = dm + ms
    if local:
        mm_val = torch.maximum(torch.maximum(zero, mm_val), ms)
    if tie_order == "last":
        # inversion-aware fill (clique_tpu batch.py:265-277), global only:
        # keep-last ties, each plane with its own candidate order; the m
        # plane is floored at MAX_NEG_SCORE
        mm_val = torch.maximum(mm_val, neg)
        return (_max_last3(mm_val, dd + ms, di + ms, DIAG, UP, LEFT),
                _max_last3(ud + lge, ui + x1, um + x1, UP, LEFT, DIAG),
                _max_last3(ld + x1, li + lge, lm + x1, UP, LEFT, DIAG))
    # local gap planes extend with the unscaled ge but open with x1, which
    # keeps the terminal-gap multiplier (:279-281)
    ext = ge if local else lge
    return (_three_way_max(dd + ms, di + ms, mm_val),
            _three_way_max(ud + ext, ui + x1, um + x1),
            _three_way_max(ld + x1, li + ext, lm + x1))


def _fill(refs, reads, ref_lens, read_lens, params, *, n1, n2,
          special_mode, tie_order, bandwidth, band_centers, local):
    """The anti-diagonal scan of align_batch_device (clique_tpu
    batch.py:221-374) in every non-Pallas mode. Returns (tb, corner) for a
    global fill, (tb, zflags, best, best_xd) for a local one."""
    check_modes(special_mode, tie_order, bandwidth, band_centers)
    _check_lens(ref_lens, read_lens, n1, n2)
    dev = reads.device
    B = reads.shape[0]
    D = n1 + n2 - 1
    f32 = torch.float32
    m_s, mm_s, sp_s, ge, fgm = (params[i] for i in (0, 1, 2, 4, 5))
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    neg = torch.full((), MAX_NEG_SCORE, dtype=f32, device=dev)

    xs = torch.arange(n1, dtype=torch.int64, device=dev)
    x = xs[None, :]
    l1 = ref_lens.to(torch.int64)[:, None]
    l2 = read_lens.to(torch.int64)[:, None]
    # ref byte per DP row, pre-shifted: row x scores ref[x-1]
    rx = torch.nn.functional.pad(refs[:, :n1 - 1].to(torch.int32), (1, 0))
    rx = rx.expand(B, n1)
    reads_i = reads.to(torch.int32)
    W = reads.shape[1]
    if bandwidth is not None:
        # band rows are constant across diagonals (clique_tpu batch.py
        # :287-290): interior cells lie in [lo, hi)
        c = band_centers[:, :n1].to(torch.int64)
        bw = bandwidth.to(torch.int64)[:, None]
        band_lo = torch.clamp(c - bw, min=1)
        band_hi = torch.minimum(l2 + 1, c + bw)
    else:
        band_lo, band_hi = 1, l2 + 1

    zeros = torch.zeros((B, n1), dtype=f32, device=dev)
    pm, pp1, pp2 = zeros, zeros, zeros          # diagonal d-1
    p2m, p2p1, p2p2 = zeros, zeros, zeros       # diagonal d-2
    tb = torch.empty((B, D, n1), dtype=torch.uint8, device=dev)
    corner = torch.zeros((B, 3), dtype=f32, device=dev)
    corner_d = (l1 + l2)[:, 0]
    fresh = torch.tensor(_TB_FRESH, dtype=torch.uint8, device=dev)
    if local:
        zflags = torch.empty((B, D, n1), dtype=torch.uint8, device=dev)
        best_val = torch.full((B,), 4.0 * MAX_NEG_SCORE, dtype=f32,
                              device=dev)
        best_x = torch.zeros((B,), dtype=torch.int64, device=dev)
        best_d = torch.zeros((B,), dtype=torch.int64, device=dev)
        best_col = torch.zeros((B, 3), dtype=f32, device=dev)
        far_neg = torch.full((), 2.0 * MAX_NEG_SCORE, dtype=f32, device=dev)

    for d in range(D):
        y = d - x                                               # [1, n1]
        # read byte at y-1 for every lane (only interior lanes use it)
        ry = reads_i.index_select(1, (y[0] - 1).clamp(0, max(W - 1, 0)))
        ms = _match_score(rx, ry, special_mode, m_s, mm_s, sp_s)
        gm = torch.where((x == l1) | (y == l2), fgm, one)
        (m_val, m_dir), (d_val, d_dir), (i_val, i_dir) = _cell(
            [_shift_down(p) for p in (p2m, p2p1, p2p2)],
            [_shift_down(p) for p in (pm, pp1, pp2)], (pm, pp1, pp2), ms,
            ge * gm, params, tie_order=tie_order, local=local, zero=zero,
            neg=neg)

        interior = (x >= 1) & (x <= l1) & (y >= band_lo) & (y < band_hi)
        is_x_border = (x == 0) & (y >= 1) & (y <= l2)
        is_y_border = (y == 0) & (x >= 1) & (x <= l1)
        is_origin = (x == 0) & (y == 0)

        xb = _border(y, params)
        yb = _border(x, params)

        m_out = torch.where(
            interior, m_val,
            torch.where(is_origin, zero,
                        torch.where(is_x_border | is_y_border, neg, zero)))
        gap_border = torch.where(
            is_x_border, xb,
            torch.where(is_y_border, yb, torch.where(is_origin, neg, zero)))
        p1_out = torch.where(interior, d_val, gap_border)
        p2_out = torch.where(interior, i_val, gap_border)

        tb[:, d, :] = torch.where(
            interior, m_dir | (d_dir << 2) | (i_dir << 4), fresh)

        if local:
            # per-plane zero flags on every cell's output value (:336-338)
            zflags[:, d, :] = ((m_out == 0).to(torch.uint8)
                               | ((p1_out == 0).to(torch.uint8) << 1)
                               | ((p2_out == 0).to(torch.uint8) << 2))
            # running 3D argmax (:339-358): strictly greater replaces, so
            # ties keep the earlier diagonal, then the smaller x (argmax
            # returns the first maximal lane)
            valid = (x <= l1) & (y >= 0) & (y <= l2)
            cell = torch.maximum(m_out, torch.maximum(p1_out, p2_out))
            cell = torch.where(valid, cell, far_neg)
            lane = torch.argmax(cell, dim=1)
            dmax = torch.gather(cell, 1, lane[:, None])[:, 0]
            dcol = torch.cat([torch.gather(v, 1, lane[:, None])
                              for v in (m_out, p1_out, p2_out)], dim=1)
            replace = dmax > best_val
            best_val = torch.where(replace, dmax, best_val)
            best_x = torch.where(replace, lane, best_x)
            best_d = torch.where(replace, d, best_d)
            best_col = torch.where(replace[:, None], dcol, best_col)
        else:
            # capture the (l1, l2) corner when its diagonal comes by
            corner_col = torch.cat([torch.gather(v, 1, l1)
                                    for v in (m_out, p1_out, p2_out)], dim=1)
            corner = torch.where((corner_d == d)[:, None], corner_col,
                                 corner)

        p2m, p2p1, p2p2 = pm, pp1, pp2
        pm, pp1, pp2 = m_out, p1_out, p2_out
    if local:
        best = torch.cat([best_val[:, None], best_col], dim=1)
        best_xd = torch.stack([best_x, best_d], dim=1).to(torch.int32)
        return tb, zflags, best, best_xd
    return tb, corner


def fill_reference(refs, reads, ref_lens, read_lens, params, *, n1: int,
                   n2: int, special_mode: str, tie_order: str = "ref",
                   bandwidth=None, band_centers=None):
    """Plain anti-diagonal fill: the global branches of align_batch_device
    (clique_tpu batch.py:221-330, local=False).

    refs [B|1, >= n1-1] uint8 (one row = uniform-reference batch), reads
    [B, >= n2-1] uint8, lens [B] int32 (ref_lens <= n1-1, read_lens <=
    n2-1), params f32 [6]. special_mode "both", "ref_n_only" or "none";
    tie_order "ref" (up > left > diag) or "last" (keep-last). A partial
    band takes bandwidth int32 [B] (half-width per row) and band_centers
    int32 [B, >= n1] (band_centers_f64); None for both is the full band.
    Returns tb uint8 [B, D, n1] (D = n1+n2-1; one 6-bit traceback byte per
    cell, _TB_FRESH outside the interior and the band) and corner f32
    [B, 3] (the M/D/I scores at (l1, l2))."""
    return _fill(refs, reads, ref_lens, read_lens, params, n1=n1, n2=n2,
                 special_mode=special_mode, tie_order=tie_order,
                 bandwidth=bandwidth, band_centers=band_centers, local=False)


def fill_local_reference(refs, reads, ref_lens, read_lens, params, *,
                         n1: int, n2: int, special_mode: str = "both"):
    """Plain Waterman-Eggert fill: the local branch of align_batch_device
    (clique_tpu batch.py:221-374, local=True) with the full band and tie
    order up > left > diag. Inputs as fill_reference.
    Returns tb uint8 [B, D, n1], zflags uint8 [B, D, n1] (bit z set where
    plane z's value is 0.0), best f32 [B, 4] (the argmax value, then the
    M/D/I values at the argmax cell) and best_xd int32 [B, 2] (its x and
    its diagonal)."""
    return _fill(refs, reads, ref_lens, read_lens, params, n1=n1, n2=n2,
                 special_mode=special_mode, tie_order="ref", bandwidth=None,
                 band_centers=None, local=True)


def corner_to_z0_score(corner):
    """Starting plane = argmax over the corner, later plane wins ties
    (Rust max_by keeps the last max; clique_tpu batch.py:495-501)."""
    z0 = torch.where(
        corner[:, 2] >= torch.maximum(corner[:, 0], corner[:, 1]), 2,
        torch.where(corner[:, 1] >= corner[:, 0], 1, 0)).to(torch.int32)
    score = torch.gather(corner, 1, z0[:, None].long())[:, 0]
    return z0, score


def fuse_result(ops_packed, n_ops, score, coords=None):
    """One uint8 row per alignment: n_ops i32 LE, score f32 LE, then the
    packed ops (clique_tpu batch.py:504-515); a local result carries its
    four coordinates (ref_start, read_start, ref_end, read_end, i32 LE)
    between the score and the ops. Host side: unfuse_result."""
    B = n_ops.shape[0]
    parts = [n_ops.to(torch.int32).contiguous().view(torch.uint8),
             score.to(torch.float32).contiguous().view(torch.uint8)]
    if coords is not None:
        parts.append(coords.to(torch.int32).contiguous().view(torch.uint8))
    return torch.cat([p.reshape(B, -1) for p in parts] + [ops_packed],
                     dim=1)


def _ops_epilogue(ops_d, score, z0, *, n1: int, n2: int):
    """Stable left-compaction of the walked ops and 2-bit packing
    (clique_tpu batch.py:610-635)."""
    B, Dw = ops_d.shape
    n_ops = (ops_d != OP_DONE).sum(dim=1).to(torch.int32)
    T = n1 + n2
    order = torch.argsort((ops_d == OP_DONE).to(torch.int32), dim=1,
                          stable=True)
    ops_compact = torch.gather(ops_d, 1, order)
    if Dw < T:
        ops_fwd = torch.nn.functional.pad(ops_compact, (0, T - Dw),
                                          value=OP_DONE)
    else:
        ops_fwd = ops_compact[:, :T]
    T4 = -(-T // 4) * 4
    o = torch.nn.functional.pad(ops_fwd, (0, T4 - T), value=OP_DONE)
    o = o.reshape(B, T4 // 4, 4)
    ops_packed = (o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4)
                  | (o[:, :, 3] << 6)).to(torch.uint8)
    return BatchAlignment(score=score, start_z=z0, ops=ops_fwd, n_ops=n_ops,
                          ops_packed=ops_packed)


def walk_reference(tb, corner, ref_lens, read_lens, *, n1: int, n2: int):
    """Plain traceback walk + epilogue + fuse.

    Walks every alignment from its (l1, l2) corner over the traceback tb
    [B, D, n1], one diagonal per step from d = D-1 down to 0, with the
    semantics of _finish_from_packed_traceback (clique_tpu
    batch.py:565-607): in the core the op is the current plane and the
    next plane is (tb >> 2z) & 3; along the borders it runs OP_DEL / OP_INS.
    Returns (BatchAlignment, fused uint8 [B, 8 + ceil(T/4)]), T = n1+n2."""
    _check_lens(ref_lens, read_lens, n1, n2)
    dev = tb.device
    B = tb.shape[0]
    D = n1 + n2 - 1
    z0, score = corner_to_z0_score(corner)
    x = ref_lens.to(torch.int64)
    y = read_lens.to(torch.int64)
    z = z0.to(torch.int64)
    ops_d = torch.full((B, D), OP_DONE, dtype=torch.uint8, device=dev)
    for d in range(D - 1, -1, -1):
        active = (x + y == d) & ((x > 0) | (y > 0))
        in_core = (x > 0) & (y > 0)
        step_core = active & in_core
        on_x = active & (x > 0)
        op = torch.where(step_core, z,
                         torch.where(on_x, OP_DEL,
                                     torch.where(active & (y > 0), OP_INS,
                                                 OP_DONE)))
        byte = torch.gather(tb[:, d, :], 1, x.clamp(0, n1 - 1)[:, None])
        direction = (byte[:, 0].to(torch.int64) >> (2 * z)) & 3
        dx = torch.where(step_core, (z != 2).to(torch.int64),
                         on_x.to(torch.int64))
        dy = torch.where(step_core, (z != 1).to(torch.int64),
                         (active & (x <= 0) & (y > 0)).to(torch.int64))
        z = torch.where(step_core, direction, z)
        x = x - dx
        y = y - dy
        ops_d[:, d] = op.to(torch.uint8)
    res = _ops_epilogue(ops_d, score, z0, n1=n1, n2=n2)
    return res, fuse_result(res.ops_packed, res.n_ops, res.score)


def walk_local_reference(tb, zflags, best, best_xd, *, n1: int, n2: int):
    """Plain local walk + epilogue + fuse: _finish_local (clique_tpu
    batch.py:450-492). Walks from the argmax cell (best_xd) in the plane
    that wins the argmax cell's values (later plane wins ties), emitting
    the current plane as the op, until the walk leaves the core (x = 0 or
    y = 0) or meets a cell whose current plane is 0.0 (zflags); no
    trailing D/I runs. Returns (LocalBatchAlignment, fused uint8
    [B, 24 + ceil(T/4)]) with the coordinates in the fused row."""
    dev = tb.device
    B = tb.shape[0]
    D = n1 + n2 - 1
    z0, score = corner_to_z0_score(best[:, 1:4])
    end_x = best_xd[:, 0].to(torch.int64)
    end_y = best_xd[:, 1].to(torch.int64) - end_x
    x, y, z = end_x, end_y, z0.to(torch.int64)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ops_d = torch.full((B, D), OP_DONE, dtype=torch.uint8, device=dev)
    for d in range(D - 1, -1, -1):
        on_diag = (x + y == d) & ~done
        in_core = (x > 0) & (y > 0)
        xi = x.clamp(0, n1 - 1)[:, None]
        zb = torch.gather(zflags[:, d, :], 1, xi)[:, 0].to(torch.int64)
        at_zero = ((zb >> z) & 1) == 1
        emit = on_diag & in_core & ~at_zero
        stop = on_diag & (~in_core | at_zero)
        byte = torch.gather(tb[:, d, :], 1, xi)[:, 0].to(torch.int64)
        direction = (byte >> (2 * z)) & 3
        ops_d[:, d] = torch.where(emit, z, OP_DONE).to(torch.uint8)
        x = x - (emit & (z != 2)).to(torch.int64)
        y = y - (emit & (z != 1)).to(torch.int64)
        z = torch.where(emit, direction, z)
        done = done | stop
    res = _ops_epilogue(ops_d, score, z0, n1=n1, n2=n2)
    i32 = torch.int32
    local = LocalBatchAlignment(
        score=res.score, start_z=res.start_z, ops=res.ops, n_ops=res.n_ops,
        ops_packed=res.ops_packed, ref_start=x.to(i32),
        read_start=y.to(i32), ref_end=end_x.to(i32), read_end=end_y.to(i32))
    coords = torch.stack([local.ref_start, local.read_start, local.ref_end,
                          local.read_end], dim=1)
    return local, fuse_result(res.ops_packed, res.n_ops, res.score, coords)


def fill_segment_reference(refs, reads, ref_lens, read_lens, params, halo,
                           tb, carry, corner, *, row0: int, n1: int, n2: int,
                           y0: int, y1: int):
    """Plain fill of one column tile of one part of a row-split alignment
    (parallel/mesh.py::length_sharded_align): the cells of rows
    row0..row0+n-1 and columns y0..y1-1 (1 <= y0 < y1 <= n2) of every
    alignment, as fill_reference computes them with the full band, special
    mode "both" and tie order up > left > diag, by an anti-diagonal scan of
    the tile whose top row and left column are given.

    refs [B, >= n] u8: the part's own reference bytes (row row0 + j scores
    refs[:, j]); reads [B, >= n2-1] u8; lens [B] i32 (ref_lens <= n1-1,
    read_lens <= n2-1); params f32 [6]. halo f32 [B, y1-y0+1, 3]: row
    row0-1's (M, D, I) at columns y0-1..y1-1, from the part above; None
    for row0 == 1 (row 0's border). Updated in place: tb u8 [B, n, n2-1]
    (cell (x, y) at [x - row0, y - 1]: the tile's interior cells written,
    every other byte left as it is, _TB_FRESH from segment_buffers),
    carry f32 [B, n, 3] (the part's rows at column y0-1 in, at column y1-1
    out; not read for y0 == 1, column 0's border) and corner f32 [B, 3]
    (the planes at (l1, l2) where that cell lies in the tile). Returns the
    halo this part hands on: row row0+n-1 at columns y0-1..y1-1, f32
    [B, y1-y0+1, 3]."""
    _check_lens(ref_lens, read_lens, n1, n2)
    dev = reads.device
    B, n = tb.shape[0], tb.shape[1]
    w = y1 - y0
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    neg = torch.full((), MAX_NEG_SCORE, dtype=f32, device=dev)
    xl = torch.arange(n + 1, device=dev)[None, :]     # lane xl: row row0-1+xl
    x = row0 - 1 + xl
    l1 = ref_lens.to(torch.int64)[:, None]
    l2 = read_lens.to(torch.int64)[:, None]
    rx = torch.nn.functional.pad(refs[:, :n].to(torch.int32), (1, 0))
    reads_i = reads.to(torch.int32)
    if halo is None:          # row 0: the origin, then the x border
        ys = torch.arange(y0 - 1, y1, device=dev)
        gap = torch.where(ys == 0, neg, _border(ys, params))
        top = torch.stack([torch.where(ys == 0, zero, neg), gap, gap],
                          dim=1).expand(B, -1, -1)
    else:
        top = halo
    if y0 == 1:               # column 0: the y border
        gap = _border(x[0, 1:], params)
        left = torch.stack([neg.expand(n), gap, gap], dim=1).expand(B, -1, -1)
    else:
        left = carry.clone()
    # the (l1, l2) cell's lane and diagonal, where it lies in the tile
    at_tile = ((l1 >= row0) & (l1 < row0 + n) & (l2 >= y0) & (l2 < y1))
    corner_lane = (l1 - row0 + 1).clamp(0, n)
    corner_e = corner_lane + l2 - y0 + 1
    halo_out = torch.empty((B, w + 1, 3), dtype=f32, device=dev)
    prev = prev2 = [torch.zeros((B, n + 1), dtype=f32, device=dev)] * 3
    for e in range(n + w + 1):
        yl = e - xl
        y = y0 - 1 + yl
        ry = reads_i.index_select(1, (y[0] - 1).clamp(0, reads.shape[1] - 1))
        ms = _match_score(rx, ry, "both", params[0], params[1], params[2])
        gm = torch.where((x == l1) | (y == l2), params[5], one)
        cells = _cell([_shift_down(p) for p in prev2],
                      [_shift_down(p) for p in prev], prev, ms,
                      params[4] * gm, params, tie_order="ref", local=False,
                      zero=zero, neg=neg)
        interior = ((xl >= 1) & (yl >= 1) & (yl <= w) & (x <= l1)
                    & (y <= l2))
        cur = [torch.where(interior, v, zero) for v, _d in cells]
        for z in range(3):
            if e <= w:            # lane 0: the top row at column y0-1+e
                cur[z][:, 0] = top[:, e, z]
            if 1 <= e <= n:       # lane e: the left column at row row0-1+e
                cur[z][:, e] = left[:, e - 1, z]
        lo, hi = max(1, e - w), min(n, e - 1)   # lanes with 1 <= yl <= w
        if lo <= hi:
            lanes = torch.arange(lo, hi + 1, device=dev)
            rows, cols = lanes - 1, y0 - 2 + e - lanes
            byte = (cells[0][1] | (cells[1][1] << 2)
                    | (cells[2][1] << 4))[:, lo:hi + 1]
            tb[:, rows, cols] = torch.where(interior[:, lo:hi + 1], byte,
                                            tb[:, rows, cols])
        col = torch.cat([torch.gather(v, 1, corner_lane) for v in cur], dim=1)
        corner.copy_(torch.where(at_tile & (corner_e == e), col, corner))
        if e >= n:                # lane n: the halo at column y0-1+e-n
            halo_out[:, e - n] = torch.stack([v[:, n] for v in cur], dim=1)
        if w < e <= w + n:        # lane e-w at column y1-1
            carry[:, e - w - 1] = torch.stack([v[:, e - w] for v in cur],
                                              dim=1)
        prev2, prev = prev, cur
    return halo_out


def walk_segment_reference(tb, corner, ref_lens, read_lens, params, state,
                           ops, *, row0: int, n1: int, n2: int):
    """Plain walk of one part of a row-split alignment over its traceback
    tb [B, n, n2-1] (fill_segment_reference's; corner its corner planes),
    with walk_reference's semantics. state i32 [B, 4] (x, y, plane, score
    bits) comes from the part below and is updated in place: an alignment
    whose corner (l1, l2) lies in rows row0..row0+n-1 (l1 == 0: the first
    part) starts here from its corner's argmax plane; one that enters with
    x > 0 and y > 0 goes on from there; either walks until its path leaves
    the part upward (its state is then the cell it reached) or reaches
    row 0 or column 0, where the border run is added and the state becomes
    (0, 0, plane, score bits). Any other state (-1: not started, or done)
    passes through. ops u8 [B, n1+n2-1] (in place, OP_DONE where no part
    wrote): the op of the step from cell (x, y) at [x + y], as
    walk_reference's ops_d, so the parts' ops join by position."""
    _check_lens(ref_lens, read_lens, n1, n2)
    dev = tb.device
    B, n = tb.shape[0], tb.shape[1]
    i64 = torch.int64
    l1, l2 = ref_lens.to(i64), read_lens.to(i64)
    own = ((l1 >= row0) & (l1 < row0 + n)) | ((l1 == 0) & (row0 == 1))
    neg = torch.full((B,), MAX_NEG_SCORE, dtype=torch.float32, device=dev)
    origin = (l1 == 0) & (l2 == 0)
    gap = torch.where(origin, neg, _border(l1 + l2, params))
    closed = torch.stack([torch.where(origin, 0.0, neg), gap, gap], dim=1)
    z0, score = corner_to_z0_score(
        torch.where(((l1 == 0) | (l2 == 0))[:, None], closed, corner))
    x = torch.where(own, l1, state[:, 0].to(i64))
    y = torch.where(own, l2, state[:, 1].to(i64))
    z = torch.where(own, z0.to(i64), state[:, 2].to(i64))
    sb = torch.where(own, score.view(torch.int32), state[:, 3])
    b = torch.arange(B, device=dev)
    while True:
        step = (x >= row0) & (y > 0)
        if not bool(step.any()):
            break
        byte = tb[b, (x - row0).clamp(0, n - 1),
                  (y - 1).clamp(0, n2 - 2)].to(i64)
        ops[b[step], (x + y)[step]] = z[step].to(torch.uint8)
        direction = (byte >> (2 * z)) & 3
        x = x - (step & (z != 2)).to(i64)
        y = y - (step & (z != 1)).to(i64)
        z = torch.where(step, direction, z)
    j = torch.arange(ops.shape[1], device=dev)[None, :]
    dels = ((y == 0) & (x > 0))[:, None] & (j >= 1) & (j <= x[:, None])
    ins = ((x == 0) & (y > 0))[:, None] & (j >= 1) & (j <= y[:, None])
    ops[dels] = OP_DEL
    ops[ins] = OP_INS
    done = (x == 0) | (y == 0)
    state[:, 0] = torch.where(done, 0, x).to(torch.int32)
    state[:, 1] = torch.where(done, 0, y).to(torch.int32)
    state[:, 2] = z.to(torch.int32)
    state[:, 3] = sb


def segment_wavefront_to_rows(wave, ref_lens, read_lens, *, row0: int,
                              n: int, n1: int, n2: int, cols=None):
    """A part's traceback in the segment kernel's layout [B,
    traceback_bytes(n + 1, n2)] (rows row0..row0+n-1 as rows 1..n of the
    dp_align layout) laid out as fill_segment_reference's [B, n, n2-1]:
    interior cells from the kernel, _TB_FRESH elsewhere (and throughout
    rows whose lengths lie outside the bucket). cols=(y0, y1) keeps the
    columns y0..y1-1 only: [B, n, y1-y0]."""
    y0, y1 = cols or (1, n2)
    dev = wave.device
    x = torch.arange(1, n + 1, device=dev)[None, :, None]
    y = torch.arange(y0, y1, device=dev)[None, None, :]
    off = wavefront_offset(x, y, n1=n + 1, n2=n2).reshape(-1)
    l1 = ref_lens.to(torch.int64)[:, None, None]
    l2 = read_lens.to(torch.int64)[:, None, None]
    ok = (l1 >= 0) & (l1 <= n1 - 1) & (l2 >= 0) & (l2 <= n2 - 1)
    interior = ok & (row0 - 1 + x <= l1) & (y <= l2)
    vals = wave[:, off].reshape(wave.shape[0], n, y1 - y0)
    return torch.where(interior, vals, torch.tensor(_TB_FRESH,
                                                    dtype=torch.uint8,
                                                    device=dev))


def align_batch(refs, reads, ref_lens, read_lens, params, *, n1: int,
                n2: int, special_mode: str, tie_order: str = "ref",
                bandwidth=None, band_centers=None,
                return_traceback: bool = False, stream=None):
    """Fill + walk for one length bucket: the counterpart of
    align_batch_device(local=False) in every non-Pallas mode.

    Inputs as fill_reference. On CUDA tensors the fused fill + walk kernel
    runs on `stream` (default: the current stream); on CPU tensors the
    plain versions run. Returns (fused uint8 [B, 8 + ceil((n1+n2)/4)], tb
    or None), tb in the kernel's wavefront layout (wavefront_to_tb);
    unfuse_result recovers (ops_packed, n_ops, score) on the host, and
    check_marked_rows(n_ops) raises for a row whose lengths lay outside
    [0, n1-1] x [0, n2-1] (on CPU tensors the fill raises first)."""
    from clique_tpu_torch.align import dp_kernels

    return dp_kernels.dp_align(refs, reads, ref_lens, read_lens, params,
                               n1=n1, n2=n2, special_mode=special_mode,
                               tie_order=tie_order, bandwidth=bandwidth,
                               band_centers=band_centers,
                               return_traceback=return_traceback,
                               stream=stream)


def align_batch_local(refs, reads, ref_lens, read_lens, params, *, n1: int,
                      n2: int, special_mode: str = "both", stream=None):
    """Local fill + walk for one length bucket: the counterpart of
    align_batch_device(local=True). Inputs as fill_local_reference. On
    CUDA tensors the fused local kernel runs on `stream`; on CPU tensors
    the plain versions run. Returns the fused uint8
    [B, 24 + ceil((n1+n2)/4)] rows; unfuse_result(..., local=True) recovers
    (ops_packed, n_ops, score, coords) on the host, and check_marked_rows
    raises for a row whose lengths lay outside the bucket."""
    from clique_tpu_torch.align import dp_kernels

    return dp_kernels.dp_align_local(refs, reads, ref_lens, read_lens, params,
                                     n1=n1, n2=n2, special_mode=special_mode,
                                     stream=stream)[0]


# --- host-side helpers (copies of clique_tpu/align/batch.py) -----------------

def unfuse_result(buf: np.ndarray, local: bool = False):
    """Host inverse of fuse_result: (ops_packed, n_ops, score) views, and
    with `local` also the coordinates int32 [..., 4] (ref_start,
    read_start, ref_end, read_end). The global form is a copy of
    clique_tpu/align/batch.py:518."""
    n_ops = np.ascontiguousarray(buf[..., 0:4]).view(np.int32)[..., 0]
    score = np.ascontiguousarray(buf[..., 4:8]).view(np.float32)[..., 0]
    if local:
        coords = np.ascontiguousarray(buf[..., 8:24]).view(np.int32)
        return buf[..., 24:], n_ops, score, coords
    return buf[..., 8:], n_ops, score


def check_marked_rows(n_ops: np.ndarray):
    """Raise for fused rows the CUDA walk marked with n_ops -1: their
    lengths lay outside the bucket. The plain versions raise the same
    ValueError at call time (_check_lens); the kernels cannot without a
    device sync, so the host raises when it reads the row back."""
    bad = np.flatnonzero(np.asarray(n_ops) < 0)
    if len(bad):
        raise ValueError(f"{len(bad)} alignment(s) had lengths outside "
                         f"their bucket (first: row {int(bad[0])})")


def unpack_ops(ops_packed: np.ndarray, T: int) -> np.ndarray:
    """Host-side unpack of 2-bit op codes -> [B, T] uint8.
    Copy of clique_tpu/align/batch.py:664."""
    B = ops_packed.shape[0]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    u = (ops_packed[:, :, None] >> shifts[None, None, :]) & 3
    return u.reshape(B, -1)[:, :T].astype(np.uint8)


def pad_batch(seqs, pad_to: Optional[int] = None):
    """list[bytes] -> (uint8 array [B, L], int32 lens [B]).
    Copy of clique_tpu/align/batch.py:674."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(pad_to if pad_to is not None else (max(lens) if len(lens) else 0))
    out = np.zeros((len(seqs), max(L, 1)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = np.frombuffer(
            s if isinstance(s, bytes) else bytes(s), dtype=np.uint8)
    return out, lens


def band_centers_f64(ref_lens: np.ndarray, read_lens: np.ndarray,
                     n1: int) -> np.ndarray:
    """Reference-exact band centers int32 [B, n1]: the f64 truncation
    `((x / (len1+1)) * (len2+1)) as i64` of alignment_matrix.rs:414, which
    can land one below the exact quotient (x=1, len1=48, len2=146 gives 2,
    not 3). Copy of clique_tpu/align/batch.py:638."""
    x = np.arange(n1, dtype=np.float64)[None, :]
    d1 = ref_lens.astype(np.float64)[:, None] + 1.0
    d2 = read_lens.astype(np.float64)[:, None] + 1.0
    return ((x / d1) * d2).astype(np.int32)


def ops_to_alignments_batch(ops: np.ndarray, n_ops: np.ndarray,
                            refs_arr: np.ndarray, reads_arr: np.ndarray):
    """Vectorized expansion of a whole batch of op sequences.
    Copy of clique_tpu/align/batch.py:685.

    ops [B, T] uint8 (OP_DONE-padded), n_ops [B], refs_arr [B, Lr],
    reads_arr [B, Ld] -> (aligned_ref [B, T] uint8, aligned_read [B, T]
    uint8, valid [B, T] bool). Rows are GAP/0-padded past n_ops; callers
    slice row[:n_ops[b]].
    """
    from clique_tpu_torch.utils.seq import GAP

    B, T = ops.shape
    valid = ops != OP_DONE
    r_step = valid & (ops != OP_INS)
    d_step = valid & (ops != OP_DEL)
    r_idx = np.cumsum(r_step, axis=1, dtype=np.int32)
    d_idx = np.cumsum(d_step, axis=1, dtype=np.int32)
    np.subtract(r_idx, 1, out=r_idx)
    np.subtract(d_idx, 1, out=d_idx)
    np.clip(r_idx, 0, refs_arr.shape[1] - 1, out=r_idx)
    np.clip(d_idx, 0, reads_arr.shape[1] - 1, out=d_idx)
    # flat fancy gather is faster than take_along_axis at these shapes;
    # int32 index arithmetic avoids an int64 upcast pass
    rows = np.arange(B, dtype=np.int32)[:, None]
    ref_g = refs_arr.ravel()[r_idx + rows * np.int32(refs_arr.shape[1])]
    read_g = reads_arr.ravel()[d_idx + rows * np.int32(reads_arr.shape[1])]
    aligned_ref = np.where(r_step, ref_g, GAP).astype(np.uint8)
    aligned_read = np.where(d_step, read_g, GAP).astype(np.uint8)
    aligned_ref[~valid] = 0
    aligned_read[~valid] = 0
    return aligned_ref, aligned_read, valid


def cigar_from_ops_row(ops_row: np.ndarray, n: int):
    """Run-length encode one op row into [(count, op)] (M/D/I).
    Copy of clique_tpu/align/batch.py:718."""
    from clique_tpu_torch.align.cpu import simplify_cigar

    ops_row = ops_row[:n]
    if n == 0:
        return []
    change = np.nonzero(np.diff(ops_row))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [n]))
    return [(int(e - s), "MDI"[ops_row[s]]) for s, e in zip(starts, ends)]


def cigar_runs_from_ops_batch(ops: np.ndarray, n_ops: np.ndarray):
    """Flat run-length encoding of a whole [B, T] op matrix in one pass:
    (counts int32 [R], opcodes uint8 [R] with 0=M 1=D 2=I, bounds int64
    [B+1] into the run arrays). Copy of clique_tpu/align/batch.py:731."""
    B, T = ops.shape
    z64 = np.zeros(1, dtype=np.int64)
    if B == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint8), z64)
    j = np.arange(T, dtype=np.int64)
    valid = j[None, :] < n_ops[:, None]
    o = np.where(valid, ops, 255).astype(np.int16)
    prev = np.empty_like(o)
    prev[:, 0] = -1                       # row start always opens a run
    prev[:, 1:] = o[:, :-1]
    start = valid & (o != prev)
    rows, cols = np.nonzero(start)
    if len(rows) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint8),
                np.zeros(B + 1, dtype=np.int64))
    ends = np.empty_like(cols)
    ends[:-1] = cols[1:]
    row_last = np.empty(len(rows), dtype=bool)
    row_last[:-1] = rows[1:] != rows[:-1]
    row_last[-1] = True
    ends[row_last] = n_ops[rows[row_last]]
    counts = (ends - cols).astype(np.int32)
    opcodes = ops[rows, cols].astype(np.uint8)
    bounds = np.searchsorted(rows, np.arange(B + 1)).astype(np.int64)
    return counts, opcodes, bounds


def cigars_from_runs(counts, opcodes, bounds):
    """Per-row [(count, op)] tuple lists from cigar_runs_from_ops_batch
    output. Copy of clique_tpu/align/batch.py:764."""
    counts_l = counts.tolist()
    ops_l = opcodes.tolist()
    bounds_l = bounds.tolist()
    sym = "MDI"
    return [[(c, sym[v]) for c, v in
             zip(counts_l[s:e], ops_l[s:e])]
            for s, e in zip(bounds_l[:-1], bounds_l[1:])]


def cigars_from_ops_batch(ops: np.ndarray, n_ops: np.ndarray):
    """Run-length encode a whole [B, T] op matrix into per-row
    [(count, op)] lists with one flat pass. Copy of
    clique_tpu/align/batch.py:776."""
    return cigars_from_runs(*cigar_runs_from_ops_batch(ops, n_ops))


def ops_to_alignment(ops: np.ndarray, n_ops: int, ref: bytes, read: bytes):
    """Expand a forward op sequence into (ref_aligned, read_aligned, cigar).
    Copy of clique_tpu/align/batch.py:784."""
    from clique_tpu_torch.align.cpu import simplify_cigar
    from clique_tpu_torch.utils.seq import GAP

    ops = ops[:n_ops]
    r_idx = np.cumsum(ops != OP_INS)      # consumed ref bases after each op
    d_idx = np.cumsum(ops != OP_DEL)      # consumed read bases
    ref_a = np.frombuffer(ref, dtype=np.uint8)
    read_a = np.frombuffer(read, dtype=np.uint8)

    aln1 = np.where(ops != OP_INS, ref_a[np.clip(r_idx - 1, 0, None)], GAP).astype(np.uint8)
    aln2 = np.where(ops != OP_DEL, read_a[np.clip(d_idx - 1, 0, None)], GAP).astype(np.uint8)

    cigar = simplify_cigar([(1, "MDI"[o]) for o in ops])
    return aln1.tobytes(), aln2.tobytes(), cigar
