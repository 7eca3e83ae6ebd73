"""Data-parallel align step over several devices.

Counterpart of clique_tpu/parallel/mesh.py. The JAX package lays a 1-D
`data` mesh over its chips and shards each read batch over it; here a
"mesh" is a list of torch devices, and `sharded_align_step` splits the
batch into one contiguous shard a device, each aligned by the port's
dp_align (the fused fill + walk kernel of csrc/dp_align.cu on a CUDA
device, its plain version on the CPU). The shards are dispatched on every
device before any result is read back.

`length_sharded_align` (one alignment's reference lanes split across
devices with a halo exchange every diagonal) is not ported: it needs a
lane-split form of dp_align and a host with several GPUs (ROADMAP.md
Queue 2 item 5).
"""

from __future__ import annotations

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


def sharded_align_step(mesh: List[torch.device], refs, reads, ref_lens,
                       read_lens, params, *, n1: int, n2: int):
    """One data-parallel align step: the batch split over the devices of
    `mesh` (contiguous shards, as P("data") lays them), the scoring params
    [6] f32 copied to each, every shard a dp_align launch (full band,
    special mode "both", as align_batch_device's defaults). refs [B, n1-1],
    reads [B, n2-1] u8, lens [B] i32 (numpy arrays or tensors). Returns
    (scores [B] f32, ops [B, n1 + n2] u8, n_ops [B] i32) as CPU tensors in
    batch order."""
    refs, reads, ref_lens, read_lens, params = (
        (x.cpu() if torch.is_tensor(x)
         else torch.from_numpy(np.array(x))).to(dtype)
        for x, dtype in ((refs, torch.uint8), (reads, torch.uint8),
                         (ref_lens, torch.int32), (read_lens, torch.int32),
                         (params, torch.float32)))
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
