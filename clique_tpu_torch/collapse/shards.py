"""Out-of-core sorted shards: the external-memory backbone for collapse.

TPU-first replacement for the reference's shardio dependency
(the Rust reference, rust_cmd/src/collapse.rs:468-469: 32-way sharded temp
files sorted by SortingReadSetContainer::Ord). Collapse currently holds a
run's reads in RAM; at pod scale (BASELINE config 5) the read records must
spill while only tag counts stay resident. This module provides the spill
layer:

- `ShardWriter`: hash-partitions pickled items by their sort key into N
  shard files (buffered appends, zlib-compressed frames), so items with
  equal keys always land in the same shard.
- `ShardReader`: streams one shard's items back sorted by key (in-memory
  sort per shard - shards bound memory to ~total/N).
- `iter_sorted_groups(dir)`: merge-iterates every shard in key order,
  yielding (key, [items]) groups; equal keys never span shards, so no
  cross-shard merge heap is needed - shards are simply processed in
  sequence and their group streams concatenated.

The partition function is the same FNV-1a used by the distributed groupby
(parallel/groupby.py), so a future multi-host collapse can map shard
ownership straight onto the device-mesh bucket owners.
"""

from __future__ import annotations

import heapq
import os
import pickle
import struct
import zlib
from typing import Any, Iterable, Iterator, List, Tuple

_MAGIC = b"CQSH\x01"
_FRAME_ITEMS = 512


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def key_shard(key: Any, n_shards: int) -> int:
    """Stable shard id for a (picklable) sort key."""
    return _fnv1a(pickle.dumps(key, protocol=4)) % n_shards


class ShardWriter:
    """Hash-partitioned spill writer: push (key, item) pairs; equal keys
    land in the same shard file."""

    def __init__(self, directory: str, n_shards: int = 32,
                 compress_level: int = 1):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.n_shards = n_shards
        self.level = compress_level
        self._fhs = [open(os.path.join(directory, f"shard{m:04d}.cqs"), "wb")
                     for m in range(n_shards)]
        for fh in self._fhs:
            fh.write(_MAGIC)
        self._buffers: List[List[Tuple[Any, Any]]] = [[] for _ in
                                                      range(n_shards)]
        self.items_written = 0

    def push(self, key: Any, item: Any) -> None:
        m = key_shard(key, self.n_shards)
        buf = self._buffers[m]
        buf.append((key, item))
        self.items_written += 1
        if len(buf) >= _FRAME_ITEMS:
            self._flush_shard(m)

    def _flush_shard(self, m: int) -> None:
        buf = self._buffers[m]
        if not buf:
            return
        payload = zlib.compress(pickle.dumps(buf, protocol=4), self.level)
        self._fhs[m].write(struct.pack("<I", len(payload)))
        self._fhs[m].write(payload)
        buf.clear()

    def close(self) -> None:
        for m in range(self.n_shards):
            self._flush_shard(m)
            self._fhs[m].close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _iter_frames(path: str) -> Iterator[List[Tuple[Any, Any]]]:
    """Stream a shard file's frames one at a time (each <= _FRAME_ITEMS
    items resident)."""
    with open(path, "rb") as fh:
        magic = fh.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"not a shard file: {path}")
        while True:
            head = fh.read(4)
            if len(head) < 4:
                break
            (n,) = struct.unpack("<I", head)
            yield pickle.loads(zlib.decompress(fh.read(n)))


def _read_shard(path: str) -> List[Tuple[Any, Any]]:
    items: List[Tuple[Any, Any]] = []
    for frame in _iter_frames(path):
        items.extend(frame)
    return items


def iter_items(directory) -> Iterator[Tuple[Any, Any]]:
    """Stream every (key, item) pair frame-by-frame in file order - no
    sort, no full-shard materialization. This is the memory-bounded scan
    for passes that only need per-item access (collapse's level passes:
    counting and correction application are per-read once the correction
    maps are in RAM). `directory` may be a list of directories."""
    dirs = [directory] if isinstance(directory, str) else list(directory)
    for d in dirs:
        for path in shard_paths(d):
            for frame in _iter_frames(path):
                yield from frame


class ShardReader:
    """Stream one shard's (key, item) pairs sorted by key."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Tuple[Any, Any]]:
        items = _read_shard(self.path)
        items.sort(key=lambda kv: kv[0])
        return iter(items)


def shard_paths(directory: str) -> List[str]:
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.startswith("shard") and f.endswith(".cqs"))


def iter_sorted_groups(directory
                       ) -> Iterator[Tuple[Any, List[Any]]]:
    """Yield (key, items) groups across all shards. Keys group correctly
    because the hash partition sends equal keys to one shard; group order
    is per-shard sorted (collapse only needs grouping, not a global
    order - matching sort_level's run-grouping contract).

    `directory` may be a list of directories written by INDEPENDENT
    writers with the same n_shards (e.g. one per worker process): shard
    files with the same id are read together, so equal keys still land in
    one merged group - the merge step of the shard-parallel design."""
    dirs = [directory] if isinstance(directory, str) else list(directory)
    by_name: dict = {}
    for d in dirs:
        for path in shard_paths(d):
            by_name.setdefault(os.path.basename(path), []).append(path)
    for name in sorted(by_name):
        items: List[Tuple[Any, Any]] = []
        for path in by_name[name]:
            items.extend(_read_shard(path))
        # ordinal tiebreak: group members come out in input-BAM order
        # regardless of which spill stream (level hash / worker /
        # process) delivered them — matching the in-RAM path exactly
        items.sort(key=lambda kv: (kv[0], getattr(kv[1], "ordinal", 0)))
        current_key = None
        bucket: List[Any] = []
        for key, item in items:
            if current_key is not None and key != current_key:
                yield current_key, bucket
                bucket = []
            current_key = key
            bucket.append(item)
        if bucket:
            yield current_key, bucket


def iter_globally_sorted(directory: str) -> Iterator[Tuple[Any, Any]]:
    """Full key-ordered stream across shards via a k-way heap merge (for
    consumers that need a total order, e.g. deterministic output files)."""
    iters = [iter(ShardReader(p)) for p in shard_paths(directory)]
    return heapq.merge(*iters, key=lambda kv: kv[0])
