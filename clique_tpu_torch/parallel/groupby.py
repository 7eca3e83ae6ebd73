"""Distributed tag group-by: the multi-process collapse backbone.

Counterpart of clique_tpu/parallel/groupby.py on torch.distributed. The
reference's shardio external-memory sort (collapse.rs:468-469) is a
single-node construct; across processes the same operation becomes:

1. each process extracts tags locally and hashes each read's current tag
   key into one of N buckets (`tag_bucket`, FNV-1a, stable across
   processes);
2. per-bucket histograms are counted on the process's device
   (torch.bincount) and summed over the process group by an all_reduce
   (`bucket_histogram`), where the JAX package sums a one-hot over its
   `data` mesh axis;
3. buckets are deterministically assigned to owner processes balanced by
   count (`assign_bucket_owners`);
4. an exchange co-locates each bucket's items on its owner (on one process
   the in-process exchange `exchange_by_owner` the tests use), after which
   every UMI group lives entirely on one process.

Grouping by hash bucket is exact: all reads sharing a tag key share its
bucket, so no group is ever split across owners. Where the JAX functions
take a mesh these take a process group: None is the default group when
torch.distributed is initialised, else a world of one process.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def tag_bucket(tag: bytes, n_buckets: int) -> int:
    """Deterministic FNV-1a bucket of a tag key (stable across hosts)."""
    h = 0xCBF29CE484222325
    for b in tag:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % n_buckets


def world_of(group=None) -> int:
    """Processes in `group` (the default group for None); 1 when
    torch.distributed is not initialised."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the processes of `group`, on every process (t itself
    where the world is one process). The sum runs where the group's backend
    takes tensors: on this process's current CUDA device under NCCL, on the
    CPU under gloo. Returns a tensor on t's device."""
    if world_of(group) == 1:
        return t
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        buf = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        buf = t.cpu()
    buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def bucket_histogram(group, buckets, n_buckets: int, device="cuda"
                     ) -> np.ndarray:
    """Per-bucket counts of this process's buckets [B] i32, summed over the
    group's processes: torch.bincount on `device`, then an all_reduce where
    the world is larger than one process. Returns the histogram
    [n_buckets] i64, the same on every process."""
    b = torch.as_tensor(np.asarray(buckets, dtype=np.int64), device=device)
    hist = torch.bincount(b, minlength=n_buckets)[:n_buckets]
    return all_reduce_sum(hist, group).cpu().numpy()


def assign_bucket_owners(histogram: np.ndarray, n_hosts: int) -> np.ndarray:
    """Greedy balanced assignment of buckets to hosts by descending count;
    deterministic (ties break to lower bucket id / lower host id)."""
    order = sorted(range(len(histogram)), key=lambda b: (-histogram[b], b))
    load = [0] * n_hosts
    owner = np.zeros(len(histogram), dtype=np.int32)
    for b in order:
        h = min(range(n_hosts), key=lambda i: (load[i], i))
        owner[b] = h
        load[h] += int(histogram[b])
    return owner


def exchange_by_owner(per_host_items: List[List], keys: List[List[bytes]],
                      owner: np.ndarray, n_buckets: int
                      ) -> List[List]:
    """In-process stand-in for the cross-host exchange: route every item
    to its bucket's owner host (the multi-process collapse ships tag
    counts and final-key shards through the shared work dir instead,
    parallel/distributed.py)."""
    n_hosts = len(per_host_items)
    out: List[List] = [[] for _ in range(n_hosts)]
    for h in range(n_hosts):
        for item, key in zip(per_host_items[h], keys[h]):
            b = tag_bucket(key, n_buckets)
            out[int(owner[b])].append(item)
    return out


def distributed_group_keys(group, per_host_keys: List[List[bytes]],
                           n_buckets: int = 1024, device="cuda"
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Full pattern: per-host keys -> histogram summed over the group ->
    owner map. per_host_keys are the keys this process holds, one list a
    host. Returns (histogram, owner)."""
    n_hosts = len(per_host_keys)
    all_buckets = []
    for keys in per_host_keys:
        all_buckets.extend(tag_bucket(k, n_buckets) for k in keys)
    hist = bucket_histogram(group, np.array(all_buckets, dtype=np.int64),
                            n_buckets, device=device)
    owner = assign_bucket_owners(hist, n_hosts)
    return hist, owner
