"""Wrappers of the hand-written DP kernels (csrc/dp_align.cu,
dp_align_local.cu).

Counterpart of clique_tpu/align/pallas_kernel.py and the XLA modes of
clique_tpu/align/batch.py::align_batch_device: `dp_align` replaces the
Pallas fill (`_fill_kernel` via `pallas_fill`), the banded, keep-last and
`special_mode="none"` branches of the XLA scan, and the XLA walk, epilogue
and result fusion that follow a global fill, in one kernel;
`dp_align_local` the scan's Waterman-Eggert branch and the walk, epilogue
and fusion of `_finish_local`, in another. `fill_segment` and
`walk_segment` (csrc/dp_align_split.cu) are the two halves of one
alignment whose rows are split into parts
(parallel/mesh.py::length_sharded_align, where the JAX package shards the
scan's lanes over its mesh): one column tile of one part's rows with the
row above it handed in and its last row handed on, and the walk over one
part's rows from the state the part below handed on.

On CUDA tensors each wrapper checks its inputs, allocates its outputs with
torch.empty, launches its kernel on the given stream (default: the current
stream of the tensors' device) and raises if the launch fails. On CPU
tensors it runs the plain PyTorch versions from align/batch.py. Any other
device raises. `align_launches` and `align_local_launches` count kernel
launches and nothing else; `fill_mode_launches` splits the launches by
mode.

Lengths are data, not shape. The plain versions check them and raise
ValueError when one lies outside [0, n1-1] / [0, n2-1]. A kernel cannot
raise without a device sync per launch, so it marks such a row instead: a
fused row with n_ops -1, a NaN score and no ops (and no traceback).
batch.check_marked_rows raises the same ValueError when the host reads the
fused rows back, and BatchAligner calls it on every group it pulls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from clique_tpu_torch.align import batch as _batch

align_launches = 0
align_local_launches = 0
# launches by mode: dp_align's with a partial band, keep-last ties,
# special_mode "none" and more than one band of rows (n1 - 1 > 384),
# dp_align_local's with more than one band, on the warps of its CTA, and
# the row-split fill's and walk's (fill_segment, walk_segment)
FILL_MODES = ("banded", "tie_last", "special_none", "row_bands",
              "local_row_bands", "row_split", "row_split_walk")
fill_mode_launches = dict.fromkeys(FILL_MODES, 0)
_SPECIAL_CODES = {"none": 0, "ref_n_only": 1, "both": 2}
# shared memory an H100 block may use (dynamic + static)
_SMEM_LIMIT = 232448


def reset_counts() -> None:
    global align_launches, align_local_launches
    align_launches = 0
    align_local_launches = 0
    for k in FILL_MODES:
        fill_mode_launches[k] = 0


def _check(t, name, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch_stream(stream, device, inputs):
    """The stream to launch on; inputs allocated on other streams are
    marked as used by it, so the caching allocator does not hand their
    memory out again before the kernel has read them."""
    s = stream if stream is not None else torch.cuda.current_stream(device)
    if s.device != device:
        raise ValueError(f"stream is on {s.device}, tensors on {device}")
    for t in inputs:
        t.record_stream(s)
    return s


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _check_fill_inputs(refs, reads, ref_lens, read_lens, params, n1, n2,
                       special_mode, tie_order, bandwidth, band_centers):
    dev = _device_of(reads)
    _check(reads, "reads", torch.uint8, 2, dev)
    B = reads.shape[0]
    _check(refs, "refs", torch.uint8, 2, dev)
    _check(ref_lens, "ref_lens", torch.int32, 1, dev)
    _check(read_lens, "read_lens", torch.int32, 1, dev)
    _check(params, "params", torch.float32, 1, dev)
    if refs.shape[0] not in (1, B):
        raise ValueError(f"refs must have 1 or {B} rows, got {refs.shape[0]}")
    if n1 < 2 or n2 < 2:
        raise ValueError("n1 and n2 must be >= 2")
    if refs.shape[1] < n1 - 1 or reads.shape[1] < n2 - 1:
        raise ValueError(f"refs/reads must be at least {n1 - 1}/{n2 - 1} "
                         f"wide, got {refs.shape[1]}/{reads.shape[1]}")
    if ref_lens.shape[0] != B or read_lens.shape[0] != B:
        raise ValueError("ref_lens/read_lens must have one entry per read")
    if params.shape[0] != 6:
        raise ValueError("params must have 6 entries")
    _batch.check_modes(special_mode, tie_order, bandwidth, band_centers)
    if bandwidth is not None:
        _check(bandwidth, "bandwidth", torch.int32, 1, dev)
        _check(band_centers, "band_centers", torch.int32, 2, dev)
        if bandwidth.shape[0] != B or band_centers.shape[0] != B:
            raise ValueError("bandwidth/band_centers need one row per read")
        if band_centers.shape[1] != n1:
            raise ValueError(f"band_centers must be [{B}, {n1}], got "
                             f"{list(band_centers.shape)}")
    return dev, B


def dp_align(refs, reads, ref_lens, read_lens, params, *, n1: int, n2: int,
             special_mode: str, tie_order: str = "ref", bandwidth=None,
             band_centers=None, return_traceback: bool = False, stream=None):
    """Global fill + walk + epilogue + fuse of one length bucket in one
    kernel: refs [B|1, >= n1-1] u8, reads [B, >= n2-1] u8, lens [B] i32,
    params [6] f32, and for a partial band bandwidth [B] i32 and
    band_centers [B, n1] i32 -> (fused u8 [B, 8 + ceil((n1+n2)/4)], tb or
    None). Semantics of align/batch.py::walk_reference(fill_reference(...))
    (its fused output). With return_traceback the traceback comes back in
    the kernel's wavefront layout, u8 [B, batch.traceback_bytes(n1, n2)];
    the kernel stores interior cells only, and batch.wavefront_to_tb lays
    them out as fill_reference's [B, n1+n2-1, n1]."""
    global align_launches
    dev, B = _check_fill_inputs(refs, reads, ref_lens, read_lens, params,
                                n1, n2, special_mode, tie_order, bandwidth,
                                band_centers)
    if dev.type == "cpu":
        tb, corner = _batch.fill_reference(
            refs, reads, ref_lens, read_lens, params, n1=n1, n2=n2,
            special_mode=special_mode, tie_order=tie_order,
            bandwidth=bandwidth, band_centers=band_centers)
        _res, fused = _batch.walk_reference(tb, corner, ref_lens, read_lens,
                                            n1=n1, n2=n2)
        return fused, (_batch.tb_to_wavefront(tb, ref_lens, read_lens,
                                              n1=n1, n2=n2)
                       if return_traceback else None)

    from clique_tpu_torch import _build

    lib = _build.load()
    smem = lib.clique_dp_align_smem_bytes(n1, n2)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n1 + n2 = {n1 + n2} needs {smem} B of shared "
                         "memory for the walk, more than an H100 block has")
    s = _launch_stream(stream, dev, [t for t in (
        refs, reads, ref_lens, read_lens, params, bandwidth, band_centers)
        if t is not None])
    tb_bytes = lib.clique_dp_align_tb_bytes(n1, n2)
    if tb_bytes != _batch.traceback_bytes(n1, n2):
        raise RuntimeError("the kernel's traceback layout and batch.py's "
                           "differ")
    scratch_floats = lib.clique_dp_align_scratch_floats(n1, n2)
    with torch.cuda.stream(s):
        fused = torch.empty((B, 8 + -(-(n1 + n2) // 4)), dtype=torch.uint8,
                            device=dev)
        tb = torch.empty((B, tb_bytes), dtype=torch.uint8, device=dev)
        scratch = torch.empty((B, scratch_floats), dtype=torch.float32,
                              device=dev) if scratch_floats else None
    if B == 0:
        return fused, (tb if return_traceback else None)
    ref_stride = 0 if refs.shape[0] == 1 else refs.shape[1]
    with torch.cuda.device(dev):      # the launch goes to the current device
        err = lib.clique_dp_align(
            refs.data_ptr(), ref_stride, reads.data_ptr(), reads.shape[1],
            ref_lens.data_ptr(), read_lens.data_ptr(), params.data_ptr(),
            bandwidth.data_ptr() if bandwidth is not None else None,
            band_centers.data_ptr() if band_centers is not None else None,
            tb.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            fused.data_ptr(), B, n1, n2, _SPECIAL_CODES[special_mode],
            int(tie_order == "last"), s.cuda_stream)
    _raise_on(err, "dp_align")
    align_launches += 1
    for mode, on in (("banded", bandwidth is not None),
                     ("tie_last", tie_order == "last"),
                     ("special_none", special_mode == "none"),
                     ("row_bands", scratch is not None)):
        if on:
            fill_mode_launches[mode] += 1
    return fused, (tb if return_traceback else None)


def dp_align_local(refs, reads, ref_lens, read_lens, params, *, n1: int,
                   n2: int, special_mode: str = "both",
                   return_traceback: bool = False, stream=None):
    """Waterman-Eggert fill + argmax + walk + epilogue + fuse of one length
    bucket in one kernel (full band, tie order up > left > diag): refs,
    reads, lens and params as dp_align without the band -> (fused u8
    [B, 24 + ceil((n1+n2)/4)], tb or None). Semantics of
    align/batch.py::walk_local_reference(fill_local_reference(...)) (its
    fused output). With return_traceback the traceback comes back in the
    kernel's wavefront layout, u8 [B, batch.traceback_bytes(n1, n2)], one
    byte an interior cell with the zero flags inside it;
    batch.local_wavefront_to_tb decodes it."""
    global align_local_launches
    dev, B = _check_fill_inputs(refs, reads, ref_lens, read_lens, params,
                                n1, n2, special_mode, "ref", None, None)
    if dev.type == "cpu":
        tb, zflags, best, best_xd = _batch.fill_local_reference(
            refs, reads, ref_lens, read_lens, params, n1=n1, n2=n2,
            special_mode=special_mode)
        _res, fused = _batch.walk_local_reference(tb, zflags, best, best_xd,
                                                  n1=n1, n2=n2)
        return fused, (_batch.local_tb_to_wavefront(
            tb, zflags, ref_lens, read_lens, n1=n1, n2=n2)
            if return_traceback else None)

    from clique_tpu_torch import _build

    lib = _build.load()
    smem = lib.clique_dp_align_local_smem_bytes(n1, n2)
    if smem > _SMEM_LIMIT - 1024:
        raise ValueError(f"n1 + n2 = {n1 + n2} needs {smem} B of shared "
                         "memory for the walk, more than an H100 block has")
    s = _launch_stream(stream, dev, (refs, reads, ref_lens, read_lens,
                                     params))
    tb_bytes = lib.clique_dp_align_tb_bytes(n1, n2)
    if tb_bytes != _batch.traceback_bytes(n1, n2):
        raise RuntimeError("the kernel's traceback layout and batch.py's "
                           "differ")
    scratch_floats = lib.clique_dp_align_local_scratch_floats(n1, n2)
    with torch.cuda.stream(s):
        fused = torch.empty((B, 24 + -(-(n1 + n2) // 4)), dtype=torch.uint8,
                            device=dev)
        tb = torch.empty((B, tb_bytes), dtype=torch.uint8, device=dev)
        scratch = torch.empty((B, scratch_floats), dtype=torch.float32,
                              device=dev) if scratch_floats else None
    if B == 0:
        return fused, (tb if return_traceback else None)
    ref_stride = 0 if refs.shape[0] == 1 else refs.shape[1]
    with torch.cuda.device(dev):
        err = lib.clique_dp_align_local(
            refs.data_ptr(), ref_stride, reads.data_ptr(), reads.shape[1],
            ref_lens.data_ptr(), read_lens.data_ptr(), params.data_ptr(),
            tb.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            fused.data_ptr(), B, n1, n2, _SPECIAL_CODES[special_mode],
            s.cuda_stream)
    _raise_on(err, "dp_align_local")
    align_local_launches += 1
    if scratch is not None:
        fill_mode_launches["local_row_bands"] += 1
    return fused, (tb if return_traceback else None)


class SegmentBuffers(NamedTuple):
    """What one part of a row-split alignment keeps between its launches
    (rows row0..row0+n-1 of B alignments, n2 columns)."""

    tb: torch.Tensor       # its rows' traceback: on the card u8 [B,
    #                        batch.traceback_bytes(n + 1, n2)] (dp_align's
    #                        layout of rows 1..n), on the CPU u8 [B, n,
    #                        n2 - 1] (fill_segment_reference's)
    carry: torch.Tensor    # f32 [B, n, 3]: its rows at the last column filled
    corner: torch.Tensor   # f32 [B, 3]: the (l1, l2) planes it owns


# the fill kernel's constants (csrc/dp_align_split.cu), which its C entry
# re-checks: warps a CTA at most (its launch bounds), CTAs a cluster at
# most (the portable size), ring entries between progress counts, and the
# ring entries a warp gets where every band of the part is in flight
SEGMENT_MAX_WARPS = 12
SEGMENT_MAX_CLUSTER = 8
SEGMENT_RING_CHUNK = 16
SEGMENT_RING_ENTRIES = 256
# the walk kernel's windows: steps a window, windows it holds (one walked,
# the others fetched ahead)
SEGMENT_WALK_STEPS = 32
SEGMENT_WALK_SLOTS = 4


class SegmentPlan(NamedTuple):
    """How segment_fill runs one part's tile: a cluster of C CTAs of W
    warps an alignment, band j of the part on warp j mod (C * W) (warp g
    is warp g mod W of CTA g // W), each warp's ring of R entries."""

    C: int
    W: int
    R: int
    smem: int      # dynamic shared memory of a CTA (bytes)
    bands: int     # the part's 384-row bands
    regs: int      # the kernel's registers a thread (ptxas)


def segment_smem_bytes(w: int, W: int, R: int) -> int:
    """Shared memory of a fill CTA (csrc/dp_align_split.cu's
    split_smem_bytes): the tile's read bytes, W rings of R 16-byte
    entries, W produced and W consumed counts."""
    return -(-w // 16) * 16 + W * R * 16 + 8 * W


def segment_plan(n: int, w: int, regs: int, *,
                 max_warps: int = SEGMENT_MAX_WARPS,
                 max_cluster: int = SEGMENT_MAX_CLUSTER) -> SegmentPlan:
    """The launch of segment_fill for a part of n rows and a tile of w
    columns, for a kernel of `regs` registers a thread: W warps a CTA, at
    most what an SM's 65,536 registers hold (allocated 8 a thread at a
    time) and max_warps, and C <= max_cluster CTAs (smaller limits: tests
    of the schedule). Every band of the part is in flight at once where
    max_cluster CTAs of those warps hold them, spread over as many CTAs as
    the cluster may have (fewer warps an SM step faster: PERF.md §6):
    W = ceil(bands / max_cluster), C = ceil(bands / W). Each warp's ring
    then holds SEGMENT_RING_ENTRIES entries. Where warps must take bands
    in turn, the ring holds a whole row of the tile (w + 1 entries, so
    that every wait is on a lower band), and W shrinks until the rings fit
    the shared memory. Raises ValueError when no plan fits. The kernel's C
    entry refuses a plan that breaks these rules."""
    if n < 1 or w < 1 or regs < 1:
        raise ValueError("a plan needs n, w and regs >= 1")
    bands = -(-n // (_batch.BAND_STRIPS * _batch.STRIP_ROWS))
    wmax = min(max_warps, SEGMENT_MAX_WARPS,
               65536 // (32 * (-(-regs // 8) * 8)))
    if wmax < 1 or not 1 <= max_cluster <= SEGMENT_MAX_CLUSTER:
        raise ValueError(f"no warp of {regs} registers a thread fits a "
                         f"CTA of at most {max_warps} warps in clusters of "
                         f"at most {max_cluster}")
    W = min(wmax, -(-bands // max_cluster))
    C = min(max_cluster, -(-bands // W))
    entries = w + 1 if bands > C * W else min(w + 1, SEGMENT_RING_ENTRIES)
    R = max(2 * SEGMENT_RING_CHUNK, 1 << (entries - 1).bit_length())
    while W > 1 and segment_smem_bytes(w, W, R) > _SMEM_LIMIT:
        W -= 1
    smem = segment_smem_bytes(w, W, R)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a tile of {w} columns over a part of {bands} "
                         f"bands needs rings of {R} entries, more shared "
                         "memory than an H100 block has: use narrower "
                         "tiles")
    return SegmentPlan(C, W, R, smem, bands, regs)


def segment_fill_regs() -> int:
    """The fill kernel's registers a thread (ptxas's count, read from the
    loaded library)."""
    from clique_tpu_torch import _build

    regs = _build.load().clique_dp_segment_fill_regs()
    if regs <= 0:
        raise RuntimeError("cannot read segment_fill's register count")
    return regs


def segment_buffers(B: int, n: int, n2: int, device) -> SegmentBuffers:
    """The buffers of one part of n rows on `device`."""
    dev = torch.device(device)
    if dev.type == "cpu":
        tb = torch.full((B, n, n2 - 1), _batch._TB_FRESH, dtype=torch.uint8)
    else:
        tb = torch.empty((B, _batch.traceback_bytes(n + 1, n2)),
                         dtype=torch.uint8, device=dev)
    return SegmentBuffers(
        tb, torch.zeros((B, n, 3), dtype=torch.float32, device=dev),
        torch.zeros((B, 3), dtype=torch.float32, device=dev))


def _check_segment(bufs, ref_lens, read_lens, params, dev, B, row0, n1, n2):
    """Check one part's buffers, lens and params; returns its rows n."""
    _check(bufs.carry, "carry", torch.float32, 3, dev)
    n = bufs.carry.shape[1]
    _check(bufs.corner, "corner", torch.float32, 2, dev)
    _check(bufs.tb, "tb", torch.uint8, 3 if dev.type == "cpu" else 2, dev)
    _check(ref_lens, "ref_lens", torch.int32, 1, dev)
    _check(read_lens, "read_lens", torch.int32, 1, dev)
    _check(params, "params", torch.float32, 1, dev)
    tb_shape = ((B, n, n2 - 1) if dev.type == "cpu"
                else (B, _batch.traceback_bytes(n + 1, n2)))
    if (tuple(bufs.carry.shape) != (B, n, 3)
            or tuple(bufs.corner.shape) != (B, 3)
            or tuple(bufs.tb.shape) != tb_shape):
        raise ValueError(f"the part's buffers must be tb {list(tb_shape)}, "
                         f"carry [{B}, {n}, 3] and corner [{B}, 3]")
    if ref_lens.shape[0] != B or read_lens.shape[0] != B:
        raise ValueError("ref_lens/read_lens must have one entry per read")
    if params.shape[0] != 6:
        raise ValueError("params must have 6 entries")
    if n < 1 or row0 < 1 or row0 + n > n1 or n2 < 2:
        raise ValueError(f"rows {row0}..{row0 + n - 1} do not lie in "
                         f"1..{n1 - 1}")
    return n


def fill_segment(refs, reads, ref_lens, read_lens, params, halo,
                 bufs: SegmentBuffers, *, row0: int, n1: int, n2: int,
                 y0: int, y1: int, hand_on: bool = True, stream=None):
    """One column tile of one part of a row-split alignment: the cells of
    rows row0..row0+n-1 (n = bufs.carry.shape[1]) and columns y0..y1-1 of
    B alignments (full band, special mode "both", tie order up > left >
    diag). refs [B, >= n] u8 holds the part's own reference bytes (row
    row0 + j scores refs[:, j]); reads [B, >= n2-1] u8; lens [B] i32
    (lengths of the whole alignments); params [6] f32; halo f32
    [B, y1-y0+1, 3], row row0-1's planes at columns y0-1..y1-1 from the
    part above (None for row0 == 1). Writes the tile's traceback, the
    carry column and the corner into bufs; returns the halo this part
    hands on (row row0+n-1 at columns y0-1..y1-1, [B, y1-y0+1, 3] f32), or
    None without hand_on (the last part). Semantics of
    batch.fill_segment_reference, which runs on CPU tensors. On the card
    the launch follows segment_plan for this part and tile; a plan the
    card cannot run raises."""
    dev = _device_of(reads)
    _check(reads, "reads", torch.uint8, 2, dev)
    _check(refs, "refs", torch.uint8, 2, dev)
    B = reads.shape[0]
    n = _check_segment(bufs, ref_lens, read_lens, params, dev, B, row0, n1,
                       n2)
    if refs.shape[0] != B or refs.shape[1] < n or reads.shape[1] < n2 - 1:
        raise ValueError(f"refs/reads must be [{B}, >= {n}] / [{B}, >= "
                         f"{n2 - 1}], got {list(refs.shape)} / "
                         f"{list(reads.shape)}")
    if not 1 <= y0 < y1 <= n2:
        raise ValueError(f"the tile's columns [{y0}, {y1}) must lie in "
                         f"[1, {n2})")
    if (halo is None) != (row0 == 1):
        raise ValueError("a halo comes in exactly when row0 > 1")
    if halo is not None:
        _check(halo, "halo", torch.float32, 3, dev)
        if tuple(halo.shape) != (B, y1 - y0 + 1, 3):
            raise ValueError(f"halo must be [{B}, {y1 - y0 + 1}, 3], got "
                             f"{list(halo.shape)}")
    if dev.type == "cpu":
        out = _batch.fill_segment_reference(
            refs, reads, ref_lens, read_lens, params, halo, bufs.tb,
            bufs.carry, bufs.corner, row0=row0, n1=n1, n2=n2, y0=y0, y1=y1)
        return out if hand_on else None

    from clique_tpu_torch import _build

    lib = _build.load()
    plan = segment_plan(n, y1 - y0, segment_fill_regs())
    if lib.clique_dp_segment_smem_bytes(y1 - y0, plan.W,
                                        plan.R) != plan.smem:
        raise RuntimeError("the fill kernel's shared memory and "
                           "segment_plan's differ")
    s = _launch_stream(stream, dev, [t for t in (
        refs, reads, ref_lens, read_lens, params, halo, *bufs)
        if t is not None])
    with torch.cuda.stream(s):
        out = torch.empty((B, y1 - y0 + 1, 3), dtype=torch.float32,
                          device=dev) if hand_on else None
    with torch.cuda.device(dev):
        err = lib.clique_dp_segment_fill(
            refs.data_ptr(), refs.shape[1], reads.data_ptr(), reads.shape[1],
            ref_lens.data_ptr(), read_lens.data_ptr(), params.data_ptr(),
            halo.data_ptr() if halo is not None else None,
            out.data_ptr() if out is not None else None,
            bufs.carry.data_ptr(), bufs.tb.data_ptr(),
            bufs.corner.data_ptr(), B, n1, n2, row0, n, y0, y1, plan.C,
            plan.W, plan.R, s.cuda_stream)
    _raise_on(err, f"fill_segment ({plan})")
    fill_mode_launches["row_split"] += 1
    return out


def walk_segment(bufs: SegmentBuffers, ref_lens, read_lens, params, state,
                 ops, *, row0: int, n1: int, n2: int, stream=None):
    """The walk over one part of a row-split alignment (rows
    row0..row0+n-1, n = bufs.carry.shape[1]) after all its tiles were
    filled: state i32 [B, 4] (x, y, plane, score bits; -1 not started)
    from the part below and ops u8 [B, n1+n2-1] (the op of the step from
    cell (x, y) at [x + y], OP_DONE elsewhere), both updated in place.
    Semantics of batch.walk_segment_reference, which runs on CPU tensors;
    where that raises for lengths outside the bucket, the kernel sets the
    row's state to (-2, -2, 0, NaN bits) and writes no op."""
    dev = _device_of(ref_lens)
    B = ref_lens.shape[0]
    _check_segment(bufs, ref_lens, read_lens, params, dev, B, row0, n1, n2)
    _check(state, "state", torch.int32, 2, dev)
    _check(ops, "ops", torch.uint8, 2, dev)
    if (tuple(state.shape) != (B, 4)
            or tuple(ops.shape) != (B, n1 + n2 - 1)):
        raise ValueError(f"state and ops must be [{B}, 4] and [{B}, "
                         f"{n1 + n2 - 1}]")
    if dev.type == "cpu":
        _batch.walk_segment_reference(bufs.tb, bufs.corner, ref_lens,
                                      read_lens, params, state, ops,
                                      row0=row0, n1=n1, n2=n2)
        return

    from clique_tpu_torch import _build

    lib = _build.load()
    s = _launch_stream(stream, dev, [ref_lens, read_lens, params, state,
                                     ops, *bufs])
    with torch.cuda.device(dev):
        err = lib.clique_dp_segment_walk(
            bufs.tb.data_ptr(), bufs.corner.data_ptr(), ref_lens.data_ptr(),
            read_lens.data_ptr(), params.data_ptr(), state.data_ptr(),
            ops.data_ptr(), B, n1, n2, row0, bufs.carry.shape[1],
            s.cuda_stream)
    _raise_on(err, "walk_segment")
    fill_mode_launches["row_split_walk"] += 1
