"""FASTQ / FASTA host IO.

Replaces the reference's rust-htslib/bio read iteration
(the Rust reference, rust_cmd/src/read_strategies/read_set.rs): lock-step
iteration over up to four gzipped/bgzf FASTQ streams (read1, read2, index1,
index2). Python's gzip handles BGZF transparently (BGZF is valid multi-member
gzip).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Tuple


class FastqRecord(NamedTuple):
    """One FASTQ record. A NamedTuple, not a frozen dataclass: the
    parser creates one per read and frozen-dataclass __init__ (three
    object.__setattr__ calls) measurably taxed ingest at bench scale."""

    name: str
    seq: bytes
    qual: bytes

    def __len__(self) -> int:
        return len(self.seq)


@dataclass(frozen=True)
class ReadSetContainer:
    """One position across the parallel FASTQ files (read_set.rs:10-15)."""

    read_one: FastqRecord
    read_two: Optional[FastqRecord] = None
    index_one: Optional[FastqRecord] = None
    index_two: Optional[FastqRecord] = None


def _open_maybe_gz(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


_FASTQ_BLOCK = 1 << 22


def fastq_records(path: str) -> Iterator[FastqRecord]:
    """FASTQ record stream: the native C scanner when available
    (bamcodec.c fastq_scan — one memchr pass per ~4MB block, VERDICT r4
    item 3's native ingest), else the pure-python block parse. Both
    yield identical records (tests/test_fastq_parse.py pins parity).

    Termination rule (both paths): a complete group whose seq AND qual
    are both empty (blank-line runs, EOF padding) stops the stream; a
    trailing partial group with content is still emitted."""
    from clique_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None:
        return _fastq_records_native(path, lib)
    return _fastq_records_py(path)


def _fastq_records_native(path: str, lib) -> Iterator[FastqRecord]:
    import ctypes

    import numpy as np

    CAP = 1 << 17                       # records per scan call
    name_off = np.empty(CAP, np.int64)
    name_len = np.empty(CAP, np.int32)
    seq_off = np.empty(CAP, np.int64)
    seq_len = np.empty(CAP, np.int32)
    qual_off = np.empty(CAP, np.int64)
    qual_len = np.empty(CAP, np.int32)
    consumed = ctypes.c_longlong()
    stopped = ctypes.c_int()
    with _open_maybe_gz(path) as fh:
        tail = b""
        while True:
            block = fh.read(_FASTQ_BLOCK)
            if not block:
                break
            buf = tail + block
            while True:
                cnt = lib.fastq_scan(
                    buf, len(buf), CAP,
                    name_off.ctypes.data, name_len.ctypes.data,
                    seq_off.ctypes.data, seq_len.ctypes.data,
                    qual_off.ctypes.data, qual_len.ctypes.data,
                    ctypes.byref(consumed), ctypes.byref(stopped))
                no = name_off[:cnt].tolist()
                nl = name_len[:cnt].tolist()
                so = seq_off[:cnt].tolist()
                sl = seq_len[:cnt].tolist()
                qo = qual_off[:cnt].tolist()
                ql = qual_len[:cnt].tolist()
                for i in range(cnt):
                    yield FastqRecord(
                        name=buf[no[i]:no[i] + nl[i]].decode(),
                        seq=buf[so[i]:so[i] + sl[i]],
                        qual=buf[qo[i]:qo[i] + ql[i]])
                if stopped.value:
                    return
                buf = buf[consumed.value:]
                if cnt < CAP:
                    break
            tail = buf
        # trailing partial group: mirror the python reader
        if tail:
            lines = tail.split(b"\n")
            h = lines[0]
            seq = lines[1] if len(lines) > 1 else b""
            qual = lines[3] if len(lines) > 3 else b""
            if h and (seq or qual):
                yield FastqRecord(name=h[1:].split(b" ", 1)[0].decode(),
                                  seq=seq, qual=qual)


def _fastq_records_py(path: str) -> Iterator[FastqRecord]:
    """Pure-python block parse (fallback without a C compiler)."""
    with _open_maybe_gz(path) as fh:
        pending: List[bytes] = []     # complete lines of unfinished groups
        tail = b""                    # partial last line of the last block
        while True:
            block = fh.read(_FASTQ_BLOCK)
            if not block:
                break
            lines = (tail + block).split(b"\n")
            tail = lines.pop()
            pending.extend(lines)
            n4 = len(pending) - (len(pending) % 4)
            for i in range(0, n4, 4):
                h = pending[i]
                seq = pending[i + 1]
                qual = pending[i + 3]
                if not seq and not qual:
                    return
                yield FastqRecord(name=h[1:].split(b" ", 1)[0].decode(),
                                  seq=seq, qual=qual)
            del pending[:n4]
        if tail:
            pending.append(tail)
        # trailing partial group (file truncated mid-record): mirror the
        # line-by-line reader - emit it unless both seq and qual are empty
        if pending:
            h = pending[0]
            seq = pending[1] if len(pending) > 1 else b""
            qual = pending[3] if len(pending) > 3 else b""
            if h and (seq or qual):
                yield FastqRecord(name=h[1:].split(b" ", 1)[0].decode(),
                                  seq=seq, qual=qual)


class ReadIterator:
    """Lock-step iterator over 1-4 FASTQ files (read_set.rs:60-132)."""

    def __init__(self, read1: str, read2: Optional[str] = None,
                 index1: Optional[str] = None, index2: Optional[str] = None):
        def maybe(p):
            if p is not None and p != "NONE" and os.path.exists(str(p)):
                return fastq_records(str(p))
            return None

        self._streams = {
            "read_one": fastq_records(str(read1)),
            "read_two": maybe(read2),
            "index_one": maybe(index1),
            "index_two": maybe(index2),
        }

    @property
    def single_stream(self) -> bool:
        """True when only read1 exists — callers may then iterate
        read_one_records() directly and skip the lock-step containers."""
        return all(v is None for k, v in self._streams.items()
                   if k != "read_one")

    def read_one_records(self) -> Iterator[FastqRecord]:
        return self._streams["read_one"]

    def __iter__(self) -> Iterator[ReadSetContainer]:
        while True:
            recs = {}
            for slot, stream in self._streams.items():
                if stream is None:
                    recs[slot] = None
                    continue
                try:
                    recs[slot] = next(stream)
                except StopIteration:
                    return
            yield ReadSetContainer(**recs)


def read_fasta(path: str) -> List[Tuple[str, bytes]]:
    """[(name, sequence)] from a (optionally gzipped) FASTA file."""
    out: List[Tuple[str, bytes]] = []
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip(b"\n\r")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, b"".join(chunks)))
                name = line[1:].split(b" ", 1)[0].decode()
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, b"".join(chunks)))
    return out


def write_fastq(path: str, records: List[FastqRecord]) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        for r in records:
            fh.write(b"@" + r.name.encode() + b"\n" + r.seq + b"\n+\n" + r.qual + b"\n")
