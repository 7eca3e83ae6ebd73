"""Wrappers of the hand-written DP kernels (csrc/dp_fill.cu, dp_walk.cu).

Counterpart of clique_tpu/align/pallas_kernel.py: `dp_fill` replaces the
Pallas fill (`_fill_kernel` via `pallas_fill`), `dp_walk` the XLA walk,
epilogue and result fusion that follow it in clique_tpu/align/batch.py.

On CUDA tensors each wrapper checks its inputs, allocates its outputs with
torch.empty, launches its kernel on the given stream (default: the current
stream of the tensors' device) and raises if the launch fails. On CPU
tensors it runs the plain PyTorch version from align/batch.py. Any other
device raises. `fill_launches` / `walk_launches` count kernel launches and
nothing else.

Lengths are data, not shape. The plain versions check them and raise
ValueError when one lies outside [0, n1-1] / [0, n2-1]. A kernel cannot
raise without a device sync per launch, so it marks such a row instead:
the fill stores a NaN corner and a fresh traceback row, the walk a fused
row with n_ops -1, a NaN score and no ops. batch.check_marked_rows raises
the same ValueError when the host reads the fused rows back, and
BatchAligner calls it on every group it pulls.
"""

from __future__ import annotations

import torch

from clique_tpu_torch.align import batch as _batch

fill_launches = 0
walk_launches = 0


def reset_counts() -> None:
    global fill_launches, walk_launches
    fill_launches = 0
    walk_launches = 0


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


def dp_fill(refs, reads, ref_lens, read_lens, params, *, n1: int, n2: int,
            special_mode: str, stream=None):
    """Fill one length bucket: refs [B|1, >= n1-1] u8, reads [B, >= n2-1]
    u8, lens [B] i32, params [6] f32 -> (tb u8 [B, n1+n2-1, n1], corner
    f32 [B, 3]). Semantics of align/batch.py::fill_reference."""
    global fill_launches
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
    if special_mode not in _batch.SPECIAL_MODES:
        raise ValueError(f"special_mode must be one of {_batch.SPECIAL_MODES}")
    if dev.type == "cpu":
        return _batch.fill_reference(refs, reads, ref_lens, read_lens,
                                     params, n1=n1, n2=n2,
                                     special_mode=special_mode)

    from clique_tpu_torch import _build

    lib = _build.load()
    D = n1 + n2 - 1
    if n1 > lib.clique_dp_fill_max_n1():
        raise ValueError(f"n1={n1} exceeds the fill kernel's "
                         f"{lib.clique_dp_fill_max_n1()} rows")
    smem = lib.clique_dp_fill_smem_bytes(n1, n2)
    if smem > 232448:
        raise ValueError(f"n1={n1}, n2={n2} need {smem} B of shared memory, "
                         "more than an H100 block has")
    s = _launch_stream(stream, dev, (refs, reads, ref_lens, read_lens,
                                     params))
    with torch.cuda.stream(s):
        tb = torch.empty((B, D, n1), dtype=torch.uint8, device=dev)
        corner = torch.empty((B, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return tb, corner
    ref_stride = 0 if refs.shape[0] == 1 else refs.shape[1]
    with torch.cuda.device(dev):      # the launch goes to the current device
        err = lib.clique_dp_fill(
            refs.data_ptr(), ref_stride, reads.data_ptr(), reads.shape[1],
            ref_lens.data_ptr(), read_lens.data_ptr(), params.data_ptr(),
            tb.data_ptr(), corner.data_ptr(), B, n1, n2,
            1 if special_mode == "both" else 0, s.cuda_stream)
    _raise_on(err, "dp_fill")
    fill_launches += 1
    return tb, corner


def dp_walk(tb, corner, ref_lens, read_lens, *, n1: int, n2: int,
            stream=None):
    """Walk + epilogue + fuse: tb u8 [B, n1+n2-1, n1], corner f32 [B, 3],
    lens [B] i32 -> fused u8 [B, 8 + ceil((n1+n2)/4)]. Semantics of
    align/batch.py::walk_reference (its fused output)."""
    global walk_launches
    dev = _device_of(tb)
    _check(tb, "tb", torch.uint8, 3, dev)
    B = tb.shape[0]
    _check(corner, "corner", torch.float32, 2, dev)
    _check(ref_lens, "ref_lens", torch.int32, 1, dev)
    _check(read_lens, "read_lens", torch.int32, 1, dev)
    D = n1 + n2 - 1
    if tuple(tb.shape) != (B, D, n1):
        raise ValueError(f"tb must be [{B}, {D}, {n1}], got "
                         f"{list(tb.shape)}")
    if tuple(corner.shape) != (B, 3):
        raise ValueError(f"corner must be [{B}, 3]")
    if ref_lens.shape[0] != B or read_lens.shape[0] != B:
        raise ValueError("ref_lens/read_lens must have one entry per row")
    if dev.type == "cpu":
        _res, fused = _batch.walk_reference(tb, corner, ref_lens, read_lens,
                                            n1=n1, n2=n2)
        return fused

    from clique_tpu_torch import _build

    lib = _build.load()
    T = n1 + n2
    s = _launch_stream(stream, dev, (tb, corner, ref_lens, read_lens))
    with torch.cuda.stream(s):
        fused = torch.empty((B, 8 + -(-T // 4)), dtype=torch.uint8,
                            device=dev)
        scratch = torch.empty((T, max(B, 1)), dtype=torch.uint8, device=dev)
    if B == 0:
        return fused
    with torch.cuda.device(dev):
        err = lib.clique_dp_walk(
            tb.data_ptr(), corner.data_ptr(), ref_lens.data_ptr(),
            read_lens.data_ptr(), scratch.data_ptr(), fused.data_ptr(),
            B, n1, n2, s.cuda_stream)
    _raise_on(err, "dp_walk")
    walk_launches += 1
    return fused
