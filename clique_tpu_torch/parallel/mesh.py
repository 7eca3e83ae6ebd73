"""Multi-device align steps over a list of devices.

Counterpart of clique_tpu/parallel/mesh.py. The JAX package lays a 1-D
`data` mesh over its chips; here a "mesh" is a list of torch devices (a
device may repeat), and both of its steps are ported:

- `sharded_align_step` splits a batch into one contiguous shard a device,
  each aligned by the port's dp_align (the fused fill + walk kernel of
  csrc/dp_align.cu on a CUDA device, its plain version on the CPU). The
  shards are dispatched on every device before any result is read back.
- `length_sharded_align` splits each alignment's DP rows into one part a
  device, for alignments too big for one device. Where the JAX function
  shards the scan's lanes and XLA exchanges a halo every diagonal, each
  part here fills its rows one column tile at a time (fill_segment:
  csrc/dp_align_split.cu on a CUDA device, its plain version on the CPU),
  with the row above handed down from the part above once per tile, in a
  skewed schedule on one CUDA stream a part; then the walk climbs from the
  corner's part upward, one part after another (walk_segment). Each part
  holds only its own rows' traceback.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Optional

import numpy as np
import torch

from clique_tpu_torch.align import batch as dbatch
from clique_tpu_torch.align import dp_kernels


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The devices of a data-parallel step: the first n_devices CUDA
    devices (all of them for None). sharded_align_step takes any list of
    devices; the CPU tests pass n entries of the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for, but no CUDA device "
                           "is available")
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        assert len(devices) >= n_devices, (
            f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return devices


def _host_inputs(refs, reads, ref_lens, read_lens, params):
    """The step's inputs (numpy arrays or tensors) as CPU tensors of the
    kernels' types."""
    return tuple(
        (x.cpu() if torch.is_tensor(x)
         else torch.from_numpy(np.array(x))).to(dtype)
        for x, dtype in ((refs, torch.uint8), (reads, torch.uint8),
                         (ref_lens, torch.int32), (read_lens, torch.int32),
                         (params, torch.float32)))


def sharded_align_step(mesh: List[torch.device], refs, reads, ref_lens,
                       read_lens, params, *, n1: int, n2: int):
    """One data-parallel align step: the batch split over the devices of
    `mesh` (contiguous shards, as P("data") lays them), the scoring params
    [6] f32 copied to each, every shard a dp_align launch (full band,
    special mode "both", as align_batch_device's defaults). refs [B, n1-1],
    reads [B, n2-1] u8, lens [B] i32 (numpy arrays or tensors). Returns
    (scores [B] f32, ops [B, n1 + n2] u8, n_ops [B] i32) as CPU tensors in
    batch order."""
    refs, reads, ref_lens, read_lens, params = _host_inputs(
        refs, reads, ref_lens, read_lens, params)
    B = read_lens.shape[0]
    bounds = np.linspace(0, B, len(mesh) + 1).astype(int)
    fused = []
    for dev, lo, hi in zip(mesh, bounds[:-1], bounds[1:]):
        fused.append(dp_kernels.dp_align(
            *(t[lo:hi].to(dev) for t in (refs, reads, ref_lens, read_lens)),
            params.to(dev), n1=n1, n2=n2, special_mode="both")[0])
    buf = torch.cat([f.cpu() for f in fused]).numpy()
    ops_packed, n_ops, score = dbatch.unfuse_result(buf)
    dbatch.check_marked_rows(n_ops)
    ops = dbatch.unpack_ops(np.ascontiguousarray(ops_packed), n1 + n2)
    return (torch.from_numpy(score.copy()), torch.from_numpy(ops),
            torch.from_numpy(n_ops.copy()))


def split_tile(n2: int, part_rows: int, parts: int) -> int:
    """Default columns a part fills a launch. A launch of a part of b
    bands takes about w + ramp steps for a tile of w columns, ramp = 31 +
    (b - 1) (31 + SEGMENT_RING_CHUNK) (each band starts once the band above
    has handed it a chunk); k parts in a skewed pipeline take (n2 - 1) / w
    + k - 1 launches in turn, so the fill is least near w = sqrt((n2 - 1)
    ramp / (k - 1)), here the nearest power of two; one part takes the
    whole row in one launch. Chosen from the walls of a sweep of tiles at
    k = 1, 2, 4, 8 on an H100 (PERF.md §6)."""
    cols = n2 - 1
    if parts == 1:
        return cols
    band = dbatch.BAND_STRIPS * dbatch.STRIP_ROWS
    bands = -(-part_rows // band)
    ramp = 31 + (bands - 1) * (31 + dp_kernels.SEGMENT_RING_CHUNK)
    w = math.sqrt(cols * ramp / (parts - 1))
    return max(1, min(cols, 1 << round(math.log2(max(w, 1.0)))))


def split_rows(n1: int, parts: int, on_card: bool) -> np.ndarray:
    """Default boundaries of `parts` parts over the DP rows 1..n1-1: part i
    owns rows [bounds[i], bounds[i + 1]). On the card they fall on
    multiples of dp_align's 384-row bands where there are as many bands as
    parts (each part's traceback is then whole bands of dp_align's), else
    the rows are cut evenly (np.linspace, as sharded_align_step cuts a
    batch)."""
    rows = n1 - 1
    if parts > rows:
        raise ValueError(f"{parts} parts cannot split {rows} rows")
    band = dbatch.BAND_STRIPS * dbatch.STRIP_ROWS
    bands = -(-rows // band)
    if on_card and bands >= parts:
        cut = np.linspace(0, bands, parts + 1).astype(np.int64) * band
    else:
        cut = np.linspace(0, rows, parts + 1).astype(np.int64)
    cut[-1] = rows
    return cut + 1


def _mesh_devices(mesh):
    """(the mesh's devices, whether they are CUDA devices): all of one
    kind, CPU or CUDA, "cuda" alone meaning the current device."""
    devs = [torch.device(d) for d in mesh]
    kinds = {d.type for d in devs}
    if not devs or len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh is a list of CPU devices or of CUDA "
                         f"devices, got {devs}")
    if "cuda" not in kinds:
        return devs, False
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was given, but no CUDA device is "
                           "available")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.index is None else d for d in devs], True


def _handed_on(t, event, src, dst, dev):
    """t, made on stream src up to `event`, as a tensor that stream dst on
    `dev` may read: the same tensor on the same device, else a copy to
    `dev` (peer to peer between GPUs) on src after `event`, which dst
    waits for. On the CPU (no streams) t itself."""
    if dst is None:
        return t
    dst.wait_event(event)
    if t.device == dev:
        return t
    with torch.cuda.stream(src), torch.cuda.stream(dst):
        return t.to(dev, non_blocking=True)


def _marks(streams):
    """A timing mark on each stream: CUDA events (None on the CPU, where
    the host clock's reading stands in)."""
    if streams[0] is None:
        return time.perf_counter()
    out = []
    for s in streams:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(s)
        out.append(ev)
    return out


def _elapsed_ms(a, b):
    """Per stream, the ms from mark a to mark b (after a sync)."""
    if not isinstance(a, list):
        return [(b - a) * 1e3]
    return [x.elapsed_time(y) for x, y in zip(a, b)]


def length_sharded_align(mesh: List[torch.device], refs, reads, ref_lens,
                         read_lens, params, *, n1: int, n2: int,
                         bounds=None, tile: Optional[int] = None,
                         return_parts: bool = False):
    """One batch of alignments with each alignment's DP rows split over the
    devices of `mesh`: part i owns rows [bounds[i], bounds[i + 1]) of
    every alignment (default: split_rows), with only their reference bytes
    and traceback. Semantics of align_batch_device with the JAX function's
    arguments: the full band, special mode "both", tie order up > left >
    diag. refs [B, n1-1], reads [B, n2-1] u8, lens [B] i32, params [6]
    f32 (numpy arrays or tensors). A mesh is all CUDA devices (the
    kernels) or all CPU devices (their plain versions); a device may
    repeat.

    Fill: the columns are cut into tiles of `tile` columns (default:
    split_tile for the tallest part, halved on the card while a part's
    segment_plan does not fit); at step s part i fills tile s - i, once part i - 1 has handed it that
    tile's halo (its last row at the tile's columns and the one before),
    each part on a CUDA stream of its own, the halo copied to the next
    part's device (peer to peer between GPUs) and ordered by CUDA events.
    Walk: from the part that owns each alignment's corner upward, the
    state (cell, plane, score) handed from part to part with the ops
    written so far, which then go through batch._ops_epilogue.

    Returns (scores [B] f32, ops [B, n1 + n2] u8, n_ops [B] i32) as CPU
    tensors in batch order. With return_parts also a list of one dict a
    part (device, rows, its traceback and its bytes, the halo bytes handed
    to it and whether they crossed devices, its fill launches, the
    segment_plan of its full tiles on the card, None on the CPU, and the
    tile width)
    and the times {"fill_ms": the longest part's fill, "walk_ms": the
    walk launches' sum} (CUDA events on a CUDA mesh, the host clock on the
    CPU). Lengths outside the bucket raise ValueError: on the CPU from the
    plain versions, on the card when the host reads back the rows the walk
    marked (batch.check_marked_rows)."""
    devs, cuda = _mesh_devices(mesh)
    refs, reads, ref_lens, read_lens, params = _host_inputs(
        refs, reads, ref_lens, read_lens, params)
    B, k = read_lens.shape[0], len(devs)
    if n1 < 2 or n2 < 2:
        raise ValueError("n1 and n2 must be >= 2")
    if tuple(refs.shape) != (B, n1 - 1) or tuple(reads.shape) != (B, n2 - 1):
        raise ValueError(f"refs/reads must be [{B}, {n1 - 1}] / [{B}, "
                         f"{n2 - 1}], got {list(refs.shape)} / "
                         f"{list(reads.shape)}")
    bounds = [int(b) for b in (split_rows(n1, k, cuda) if bounds is None
                               else bounds)]
    if (len(bounds) != k + 1 or bounds[0] != 1 or bounds[-1] != n1
            or any(a >= b for a, b in zip(bounds, bounds[1:]))):
        raise ValueError(f"bounds must rise from 1 to {n1} in {k} steps, "
                         f"got {bounds}")
    rows = [b - a for a, b in zip(bounds, bounds[1:])]
    regs = dp_kernels.segment_fill_regs() if cuda else None
    if tile is None:
        tile = split_tile(n2, max(rows), k)
        while cuda and tile > 1 and not all(
                _plan_fits(n, tile, regs) for n in rows):
            tile //= 2
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    tiles = [(y0, min(y0 + tile, n2)) for y0 in range(1, n2, tile)]

    parts = []
    for dev, lo, hi in zip(devs, bounds[:-1], bounds[1:]):
        stream = torch.cuda.Stream(dev) if cuda else None
        with (torch.cuda.stream(stream) if cuda
              else contextlib.nullcontext()):
            inputs = [t.to(dev) for t in (refs[:, lo - 1:hi - 1].contiguous(),
                                          reads, ref_lens, read_lens,
                                          params)]
            bufs = dp_kernels.segment_buffers(B, hi - lo, n2, dev)
        plan = (dp_kernels.segment_plan(hi - lo, min(tile, n2 - 1), regs)
                if cuda else None)
        parts.append(dict(device=dev, row0=lo, n=hi - lo, stream=stream,
                          inputs=inputs, bufs=bufs, halo_bytes=0,
                          copied=False, fills=0, plan=plan))
    streams = [p["stream"] for p in parts]

    fill0 = _marks(streams)
    handed = [None] * k        # each part's newest halo and its event
    for s in range(len(tiles) + k - 1):
        # the last part first: each takes its halo before the part above
        # makes the next one
        for i in reversed(range(k)):
            if not 0 <= s - i < len(tiles):
                continue
            p = parts[i]
            halo = None
            if i > 0:
                t, event = handed[i - 1]
                halo = _handed_on(t, event, streams[i - 1], p["stream"],
                                  p["device"])
                p["halo_bytes"] += halo.numel() * halo.element_size()
                p["copied"] = p["copied"] or t.device != p["device"]
            y0, y1 = tiles[s - i]
            out = dp_kernels.fill_segment(
                *p["inputs"], halo, p["bufs"], row0=p["row0"], n1=n1, n2=n2,
                y0=y0, y1=y1, hand_on=i + 1 < k, stream=p["stream"])
            p["fills"] += 1
            if out is not None:
                handed[i] = (out, _event(p["stream"]))
    fill1 = _marks(streams)
    del handed

    with (torch.cuda.stream(streams[-1]) if cuda
          else contextlib.nullcontext()):
        state = torch.full((B, 4), -1, dtype=torch.int32,
                           device=devs[-1])
        ops = torch.full((B, n1 + n2 - 1), dbatch.OP_DONE,
                         dtype=torch.uint8, device=devs[-1])
    walks, event = [], None
    for i in reversed(range(k)):
        p = parts[i]
        if i + 1 < k:
            state = _handed_on(state, event, streams[i + 1], p["stream"],
                               p["device"])
            ops = _handed_on(ops, event, streams[i + 1], p["stream"],
                             p["device"])
        w0 = _marks([p["stream"]])
        dp_kernels.walk_segment(p["bufs"], *p["inputs"][2:], state, ops,
                                row0=p["row0"], n1=n1, n2=n2,
                                stream=p["stream"])
        walks.append((w0, _marks([p["stream"]])))
        event = _event(p["stream"])
    if cuda:
        torch.cuda.current_stream(devs[0]).wait_event(event)
    state, ops = state.cpu(), ops.cpu()
    if cuda:
        for dev in set(devs):
            torch.cuda.synchronize(dev)

    marked = state[:, 0] == -2
    if bool(((state[:, :2] != 0).any(dim=1) & ~marked).any()):
        raise RuntimeError("a walk did not reach the origin")
    score = state[:, 3].contiguous().view(torch.float32)
    res = dbatch._ops_epilogue(ops, score, state[:, 2], n1=n1, n2=n2)
    n_ops = torch.where(marked, -1, res.n_ops).to(torch.int32)
    dbatch.check_marked_rows(n_ops.numpy())
    out = (score.clone(), res.ops, n_ops)
    if not return_parts:
        return out
    info = [dict(device=str(p["device"]), rows=(p["row0"],
                                                p["row0"] + p["n"]),
                 traceback=p["bufs"].tb, traceback_bytes=p["bufs"].tb.numel(),
                 halo_bytes=p["halo_bytes"], copied=p["copied"],
                 fills=p["fills"], plan=p["plan"], tile=tile) for p in parts]
    times = {"fill_ms": max(_elapsed_ms(fill0, fill1)),
             "walk_ms": sum(_elapsed_ms(a, b)[0] for a, b in walks)}
    return (*out, info, times)


def _plan_fits(n: int, w: int, regs: int) -> bool:
    try:
        dp_kernels.segment_plan(n, w, regs)
    except ValueError:
        return False
    return True


def _event(stream):
    """A CUDA event recorded on stream (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev
