"""Wrappers of the hand-written DP kernels (csrc/dp_align.cu,
dp_align_local.cu).

Counterpart of clique_tpu/align/pallas_kernel.py and the XLA modes of
clique_tpu/align/batch.py::align_batch_device: `dp_align` replaces the
Pallas fill (`_fill_kernel` via `pallas_fill`), the banded, keep-last and
`special_mode="none"` branches of the XLA scan, and the XLA walk, epilogue
and result fusion that follow a global fill, in one kernel;
`dp_align_local` the scan's Waterman-Eggert branch and the walk, epilogue
and fusion of `_finish_local`, in another.

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

import torch

from clique_tpu_torch.align import batch as _batch

align_launches = 0
align_local_launches = 0
# launches by mode: dp_align's with a partial band, keep-last ties,
# special_mode "none" and more than one band of rows (n1 - 1 > 384), and
# dp_align_local's with more than one band, on the warps of its CTA
FILL_MODES = ("banded", "tie_last", "special_none", "row_bands",
              "local_row_bands")
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
