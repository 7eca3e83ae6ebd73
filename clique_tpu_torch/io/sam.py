"""SAM / BAM / BGZF host IO - no htslib dependency.

Replaces the reference engine's noodles-bam/rust-htslib output layer
(the Rust reference, rust_cmd/src/alignment_manager.rs:55-200). The BAM writer
produces spec-conformant BGZF blocks + BAM records; the reader streams
records back (used by the collapse stage). Tag conventions follow the
reference: per-read extracted UMIs as e<sym>/o<sym>, rm (alignment rate),
as/rs (score), rc (read count), dc (downsampled count), ar (read names).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# --- SAM record model --------------------------------------------------------

CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}
_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_CODE = {b: i for i, b in enumerate(_SEQ_NIBBLE.encode())}
_NIBBLE_LUT = np.full(256, 15, dtype=np.uint8)
for _b, _i in _NIBBLE_CODE.items():
    _NIBBLE_LUT[_b] = _i
    _NIBBLE_LUT[ord(chr(_b).lower())] = _i
_SEQ_ASCII_LUT = np.frombuffer(_SEQ_NIBBLE.encode(), dtype=np.uint8)


@dataclass
class SamRecord:
    name: str
    flag: int
    reference_name: Optional[str]      # None = unmapped (*)
    pos: int                           # 1-based; 0 = unmapped
    mapq: int
    cigar: List[Tuple[int, str]]       # [(count, op)]
    seq: bytes
    qual: bytes                        # ASCII phred+33, b"*" if absent
    tags: Dict[str, str] = field(default_factory=dict)  # tag -> string value
    # non-string tags may be added as (type_char, value) entries
    typed_tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)

    @property
    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{c}{op}" for c, op in self.cigar)

    def to_sam_line(self, _header=None) -> str:
        tags = []
        for k, v in self.tags.items():
            tags.append(f"{k}:Z:{v}")
        for k, (t, v) in self.typed_tags.items():
            tags.append(f"{k}:{t}:{v}")
        return "\t".join([
            self.name,
            str(self.flag),
            self.reference_name or "*",
            str(self.pos),
            str(self.mapq),
            self.cigar_string,
            "*", "0", "0",
            self.seq.decode() if self.seq else "*",
            self.qual.decode() if self.qual else "*",
        ] + tags)


def build_header(references: List[Tuple[str, int]],
                 comment: str = "Clique processed") -> str:
    """SAM header text mirroring BamFileAlignmentWriter::new
    (alignment_manager.rs:88-99): HD, one SQ per reference (in id order),
    and a CO comment line."""
    lines = ["@HD\tVN:1.6"]
    for name, length in references:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    lines.append(f"@CO\t{comment}")
    return "\n".join(lines) + "\n"


# --- SAM text writer ---------------------------------------------------------

class SamWriter:
    def __init__(self, path: str, references: List[Tuple[str, int]]):
        self._fh = open(path, "w")
        self.references = references
        self._fh.write(build_header(references))

    def write(self, rec: SamRecord) -> None:
        self._fh.write(rec.to_sam_line() + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --- BGZF --------------------------------------------------------------------

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# shared deflate pool: BGZF blocks compress independently and CPython's
# zlib releases the GIL, so a small thread pool overlaps compression with
# the writer thread's IO and the other pipeline threads. Output bytes are
# IDENTICAL to the serial path (same per-block deflate at the same level,
# same block boundaries, written in order). CLIQUE_TPU_BGZF_THREADS=1
# restores fully-serial compression.
_DEFLATE_POOL = None


def _deflate_pool():
    global _DEFLATE_POOL
    if _DEFLATE_POOL is None:
        n = max(1, int(os.environ.get("CLIQUE_TPU_BGZF_THREADS", "2")))
        if n > 1:
            from concurrent.futures import ThreadPoolExecutor

            _DEFLATE_POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="bgzf-deflate")
        else:
            _DEFLATE_POOL = False
    return _DEFLATE_POOL or None


class BgzfWriter:
    """Blocked gzip writer (SAM spec section 4.1)."""

    MAX_BLOCK = 0xFF00

    def __init__(self, fh):
        self._fh = fh
        self._buf = bytearray()
        self._level = int(os.environ.get("CLIQUE_TPU_BGZF_LEVEL",
                                         str(self.LEVEL)))

    def write(self, data: bytes) -> None:
        self._buf += data
        n_blocks = len(self._buf) // self.MAX_BLOCK
        if not n_blocks:
            return
        if n_blocks >= 2:
            pool = _deflate_pool()
            if pool is not None:
                # large writes (write_encoded hands whole flushes) fan
                # block deflates over the pool; results written in order
                mb = self.MAX_BLOCK
                blocks = [bytes(self._buf[i * mb:(i + 1) * mb])
                          for i in range(n_blocks)]
                del self._buf[:n_blocks * mb]
                for payload in pool.map(self._deflate_block, blocks):
                    self._fh.write(payload)
                return
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[: self.MAX_BLOCK])
            del self._buf[: self.MAX_BLOCK]

    # BGZF deflate level default (htslib exposes the same knob via -l);
    # level 6 matches htslib, lower levels trade ~4-15% larger BAMs for
    # ~2-4x faster writer-thread compression. The env var is read per
    # writer in __init__ so setting it after import still works.
    LEVEL = 6

    def _deflate_block(self, data: bytes) -> bytes:
        """One complete BGZF block's bytes (header + deflate + trailer).
        Pure function of (data, level) — safe on pool threads."""
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        # BSIZE field = total block length - 1 (SAM spec 4.1); total =
        # header(18) + cdata + crc(4) + isize(4). Storing the full length
        # here breaks htslib-style BSIZE-seeking readers (gzip-stream
        # readers never notice).
        bsize_m1 = len(cdata) + 26 - 1
        header = struct.pack(
            "<4BI2BH2B2H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
            ord("B"), ord("C"), 2, bsize_m1)
        return b"".join((header, cdata, struct.pack(
            "<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))))

    def _flush_block(self, data: bytes) -> None:
        self._fh.write(self._deflate_block(bytes(data)))

    def flush_pending(self) -> None:
        """Flush any buffered partial block so raw pre-compressed BGZF
        blocks can be appended after it (blocks are independent)."""
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def voffset(self) -> int:
        """BGZF virtual offset of the next byte to be written:
        (compressed offset of the pending block << 16) | in-block offset.
        Valid because write() keeps the pending buffer < MAX_BLOCK."""
        return (self._fh.tell() << 16) | len(self._buf)

    def close(self) -> None:
        self.flush_pending()
        self._fh.write(_BGZF_EOF)
        self._fh.flush()


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec reg2bin."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# --- BAM writer --------------------------------------------------------------

class BamWriter:
    def __init__(self, path: str, references: List[Tuple[str, int]],
                 header_text: Optional[str] = None):
        self._raw = open(path, "wb")
        self._bgzf = BgzfWriter(self._raw)
        self.references = references
        self._ref_ids = {name: i for i, (name, _l) in enumerate(references)}
        text = (header_text or build_header(references)).encode()
        payload = b"BAM\x01" + struct.pack("<i", len(text)) + text
        payload += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode() + b"\x00"
            payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(payload)
        # flush so the header occupies whole BGZF blocks: every BAM is then
        # [header blocks][record blocks][EOF], letting part BAMs merge by
        # raw block append (concat_bam_parts) with no recompression
        self._bgzf.flush_pending()
        self.header_size = self._raw.tell()
        # record-boundary (virtual offset, record ordinal) pairs, minted
        # for free as we write: every ~_CQI_EVERY records, plus a trailing
        # sentinel at close. write_cqi() persists them so distributed
        # collapse can inflate only its byte range of the BAM AND stamp
        # globally monotone read ordinals (the shardio/indexed-access
        # boundary of collapse.rs:437-491 scaled to O(filesize/P)).
        self.chunk_offsets: List[Tuple[int, int]] = [(self._bgzf.voffset(), 0)]
        self._recs_since_chunk = 0
        self._total_records = 0
        self._closed = False
        self._cqi_every = int(os.environ.get("CLIQUE_TPU_CQI_EVERY",
                                             str(self._CQI_EVERY)))

    # chunk-index granularity in records (class default; the env var is
    # read per-writer in __init__ so setting it later still works —
    # tiny test datasets need multiple distributed ingest chunks)
    _CQI_EVERY = 2048

    def _mark_boundary(self, n_records: int) -> None:
        """Called at the start of every write call (always a record
        boundary): emit a chunk offset once ~_CQI_EVERY records passed."""
        if self._recs_since_chunk >= self._cqi_every:
            self.chunk_offsets.append(
                (self._bgzf.voffset(), self._total_records))
            self._recs_since_chunk = 0
        self._recs_since_chunk += n_records
        self._total_records += n_records

    def write(self, rec: SamRecord) -> None:
        self._mark_boundary(1)
        ref_id = self._ref_ids.get(rec.reference_name, -1) \
            if rec.reference_name else -1
        pos0 = rec.pos - 1 if rec.pos > 0 else -1
        name_b = rec.name.encode() + b"\x00"
        cigar_b = b"".join(
            struct.pack("<I", (c << 4) | _CIGAR_CODE[op])
            for c, op in rec.cigar if op in _CIGAR_CODE)
        n_cigar = len(cigar_b) // 4

        seq = rec.seq
        l_seq = len(seq)
        codes = _NIBBLE_LUT[np.frombuffer(seq, dtype=np.uint8)]
        if l_seq % 2:
            codes = np.append(codes, 0)
        seq_b = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
        if rec.qual and rec.qual != b"*" and len(rec.qual) == l_seq:
            qual_b = (np.frombuffer(rec.qual, dtype=np.uint8) - 33).tobytes()
        else:
            qual_b = b"\xff" * l_seq

        ref_span = sum(c for c, op in rec.cigar if op in "MDN=X") or 1
        bin_ = _reg2bin(max(pos0, 0), max(pos0, 0) + ref_span)

        tags_b = bytearray()
        for k, v in rec.tags.items():
            tags_b += k.encode() + b"Z" + v.encode() + b"\x00"
        for k, (t, v) in rec.typed_tags.items():
            if t == "i":
                tags_b += k.encode() + b"i" + struct.pack("<i", int(v))
            elif t == "f":
                tags_b += k.encode() + b"f" + struct.pack("<f", float(v))
            elif t == "A":
                tags_b += k.encode() + b"A" + str(v).encode()[:1]
            else:
                tags_b += k.encode() + b"Z" + str(v).encode() + b"\x00"

        body = struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos0,
            len(name_b), rec.mapq, bin_,
            n_cigar, rec.flag, l_seq,
            -1, -1, 0,
        ) + name_b + cigar_b + bytes(seq_b) + qual_b + bytes(tags_b)
        self._bgzf.write(struct.pack("<i", len(body)) + body)

    def write_batch(self, records: List[SamRecord]) -> None:
        """Encode a whole batch of records through the native C codec
        (native/bamcodec.c) in one call; falls back to per-record
        python encoding when no C compiler is available."""
        encoded = encode_records_bytes(records, self._ref_ids)
        if encoded is None:
            for rec in records:
                self.write(rec)
            return
        self._mark_boundary(len(records))
        self._bgzf.write(encoded)

    def write_encoded(self, encoded: bytes, n_records: int) -> None:
        """Append a pre-encoded raw record stream (from
        encode_records_bytes, e.g. produced in a worker process).
        n_records must be the stream's true record count — it feeds the
        chunk index's ordinals and totals."""
        self._mark_boundary(n_records)
        self._bgzf.write(encoded)

    def write_bgzf_blocks(self, blocks: bytes) -> None:
        """Append pre-compressed BGZF blocks (e.g. compressed in a worker
        process): flush the pending partial block, then write raw bytes -
        BGZF blocks are self-contained."""
        self._bgzf.flush_pending()
        self._raw.write(blocks)

    def close(self) -> None:
        if not self._closed:
            # trailing sentinel: (end-of-records voffset, total records) —
            # gives the chunk index a final range bound and part totals
            self._bgzf.flush_pending()
            self.chunk_offsets.append(
                (self._bgzf.voffset(), self._total_records))
            self._closed = True
        self._bgzf.close()
        self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def encode_records_bytes(records: List[SamRecord],
                         ref_ids_map: Dict[str, int]) -> Optional[bytes]:
    """Encode records into raw (uncompressed) BAM record-stream bytes via
    the native C codec; None when the codec is unavailable or the batch is
    empty. Safe to call in jax-free worker processes - the main process
    appends the result with BamWriter.write_encoded."""
    from clique_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None or not records:
        return None

    import ctypes

    n = len(records)
    ref_ids = np.empty(n, dtype=np.int32)
    pos0 = np.empty(n, dtype=np.int32)
    mapq = np.empty(n, dtype=np.uint8)
    flags = np.empty(n, dtype=np.uint16)
    names = []
    cigars = []
    seqs = []
    quals = []
    tags = []
    for i, rec in enumerate(records):
        ref_ids[i] = ref_ids_map.get(rec.reference_name, -1) \
            if rec.reference_name else -1
        pos0[i] = rec.pos - 1 if rec.pos > 0 else -1
        mapq[i] = rec.mapq
        flags[i] = rec.flag
        names.append(rec.name.encode())
        cigars.append(np.array(
            [(c << 4) | _CIGAR_CODE[op] for c, op in rec.cigar
             if op in _CIGAR_CODE], dtype=np.uint32))
        seqs.append(rec.seq)
        if rec.qual and rec.qual != b"*" and len(rec.qual) == len(rec.seq):
            quals.append((np.frombuffer(rec.qual, dtype=np.uint8) - 33
                          ).tobytes())
        else:
            quals.append(b"")
        tag_b = bytearray()
        for k, v in rec.tags.items():
            tag_b += k.encode() + b"Z" + v.encode() + b"\x00"
        for k, (t, v) in rec.typed_tags.items():
            if t == "i":
                tag_b += k.encode() + b"i" + struct.pack("<i", int(v))
            elif t == "f":
                tag_b += k.encode() + b"f" + struct.pack("<f", float(v))
            else:
                tag_b += k.encode() + b"Z" + str(v).encode() + b"\x00"
        tags.append(bytes(tag_b))

    def blob(parts):
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=off[1:])
        return b"".join(parts), off

    name_blob, name_off = blob(names)
    cigar_cat = np.concatenate(cigars) if cigars else \
        np.zeros(0, dtype=np.uint32)
    cigar_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(c) for c in cigars], out=cigar_off[1:])
    seq_blob, seq_off = blob(seqs)
    qual_blob, qual_off = blob(quals)
    tag_blob, tag_off = blob(tags)

    cap = (36 + 256) * n + len(name_blob) + 4 * len(cigar_cat) + \
        len(seq_blob) + len(seq_blob) + len(qual_blob) + len(tag_blob)
    out = ctypes.create_string_buffer(cap)
    written = lib.encode_bam_records(
        n,
        ref_ids.ctypes.data, pos0.ctypes.data, mapq.ctypes.data,
        flags.ctypes.data,
        name_blob, name_off.ctypes.data,
        cigar_cat.ctypes.data, cigar_off.ctypes.data,
        seq_blob, seq_off.ctypes.data,
        qual_blob, qual_off.ctypes.data,
        tag_blob, tag_off.ctypes.data,
        ctypes.addressof(out), cap)
    if written < 0:
        return None
    return out.raw[:written]



def _decode_chunk_native(lib, data: bytes, references,
                         parse_tags: bool):
    """One decode_bam_records call over `data`; returns
    (records, consumed, malformed)."""
    import ctypes

    MAXREC = 65536
    cap = len(data)
    meta = np.empty((MAXREC, 10), dtype=np.int64)
    name_off = np.empty(MAXREC + 1, dtype=np.int64)
    cigar_off = np.empty(MAXREC + 1, dtype=np.int64)
    seq_off = np.empty(MAXREC + 1, dtype=np.int64)
    name_blob = ctypes.create_string_buffer(cap)
    cigar_blob = np.empty(cap // 4 + 1, dtype=np.uint32)
    seq_blob = ctypes.create_string_buffer(2 * cap)
    qual_blob = ctypes.create_string_buffer(2 * cap)
    consumed = ctypes.c_int64(0)
    n = lib.decode_bam_records(
        data, len(data), MAXREC,
        meta.ctypes.data,
        name_off.ctypes.data, name_blob, cap,
        cigar_off.ctypes.data, cigar_blob.ctypes.data, cap // 4 + 1,
        seq_off.ctypes.data, seq_blob, 2 * cap,
        qual_blob,
        ctypes.byref(consumed))
    malformed = consumed.value == -1
    records = []
    names_b = name_blob.raw
    seqs_b = seq_blob.raw
    quals_b = qual_blob.raw
    # bulk-convert the columnar outputs to python ints once; per-record
    # numpy scalar indexing was the dominant python cost of the decode
    m = meta[:n].tolist()
    noff = name_off[:n + 1].tolist()
    coff = cigar_off[:n + 1].tolist()
    soff = seq_off[:n + 1].tolist()
    cw_all = cigar_blob[:coff[n] if n else 0].tolist()
    for i in range(n):
        (ref_id, pos0, flag, mapq, n_cigar, l_seq, tag_abs, tag_len,
         qual_missing, _res) = m[i]
        name = names_b[noff[i]:noff[i + 1]].decode()
        cigar = [(v >> 4, CIGAR_OPS[v & 0xF])
                 for v in cw_all[coff[i]:coff[i + 1]]]
        s0, s1 = soff[i], soff[i + 1]
        seq = seqs_b[s0:s1]
        qual = b"*" if qual_missing or l_seq == 0 else quals_b[s0:s1]
        tags: Dict[str, str] = {}
        typed: Dict[str, Tuple[str, object]] = {}
        if parse_tags and tag_len > 0:
            BamReader._parse_tag_block(
                data[tag_abs:tag_abs + tag_len], tags, typed)
        ref_name = references[ref_id][0] \
            if 0 <= ref_id < len(references) else None
        records.append(SamRecord(
            name=name, flag=flag, reference_name=ref_name,
            pos=pos0 + 1 if pos0 >= 0 else 0, mapq=mapq,
            cigar=cigar, seq=seq, qual=qual, tags=tags,
            typed_tags=typed))
    return records, int(consumed.value) if not malformed else -1, malformed


def decode_record_stream(data: bytes, references,
                         parse_tags: bool = True) -> List[SamRecord]:
    """Decode a raw decompressed BAM record stream that contains only
    COMPLETE records (e.g. a worker's chunk split at record boundaries by
    iter_record_chunks). Uses the native batch decoder when available,
    falling back to pure-python parsing. Raises ValueError on malformed
    records or a trailing partial record."""
    from clique_tpu_torch.native import get_lib

    lib = get_lib()
    out: List[SamRecord] = []
    r = 0
    if lib is not None:
        while r < len(data):
            recs, consumed, malformed = _decode_chunk_native(
                lib, data[r:], references, parse_tags)
            out.extend(recs)
            if malformed:
                raise ValueError(
                    "malformed BAM record (header-claimed sizes "
                    "inconsistent with block size)")
            if consumed == 0:
                raise ValueError("truncated BAM record stream chunk")
            r += consumed
        return out
    while r + 4 <= len(data):
        (block_size,) = struct.unpack_from("<i", data, r)
        body = data[r + 4:r + 4 + block_size]
        if len(body) < block_size:
            raise ValueError("truncated BAM record stream chunk")
        out.append(BamReader._parse_body(body, references, parse_tags))
        r += 4 + block_size
    if r != len(data):
        raise ValueError("truncated BAM record stream chunk")
    return out


# --- BAM reader --------------------------------------------------------------

class BamReader:
    """Streaming BAM reader (gzip handles BGZF as multi-member gzip).

    parse_tags=False skips the per-record tag walk (records get empty tag
    dicts) - for consumers like collapse that re-derive everything from the
    alignment itself."""

    def __init__(self, path: str, parse_tags: bool = True):
        self._parse_tags = parse_tags
        self._path = path
        self._fh = gzip.open(path, "rb")
        magic = self._fh.read(4)
        assert magic == b"BAM\x01", f"not a BAM file: {path}"
        (l_text,) = struct.unpack("<i", self._fh.read(4))
        self.header_text = self._fh.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._fh.read(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._fh.read(4))
            name = self._fh.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._fh.read(4))
            self.references.append((name, l_ref))

    def __iter__(self) -> Iterator[SamRecord]:
        from clique_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None:
            yield from self._iter_native(lib)
            return
        while True:
            size_b = self._fh.read(4)
            if len(size_b) < 4:
                return
            (block_size,) = struct.unpack("<i", size_b)
            body = self._fh.read(block_size)
            yield self._parse(body)

    def _iter_native(self, lib) -> Iterator[SamRecord]:
        """Chunked iteration through the C batch decoder: one
        decode_bam_records call parses every complete record in a ~4MB
        decompressed chunk into columnar blobs (field layout identical to
        _parse; the pure-python path remains the reference)."""
        CHUNK = 4 << 20
        remainder = b""
        while True:
            data = remainder + self._fh.read(CHUNK)
            if not data:
                return
            records, consumed, malformed = _decode_chunk_native(
                lib, data, self.references, self._parse_tags)
            if not records and not malformed:
                more = self._fh.read(CHUNK)
                if not more:
                    return          # exhausted (or truncated trailing bytes)
                remainder = data + more
                continue
            yield from records
            if malformed:
                raise ValueError(
                    "malformed BAM record (header-claimed sizes inconsistent "
                    "with block size)")
            remainder = data[consumed:]

    def fetch(self, reference_name: str, start: int = 0,
              end: Optional[int] = None, bai_path: Optional[str] = None
              ) -> Iterator[SamRecord]:
        """Indexed region query through a .bai (write_bai/build_bai) -
        the random-access pattern of the reference collapse input
        (collapse.rs:437-491). Yields records overlapping
        [start, end) 0-based on `reference_name`, in file order."""
        ref_ids = {name: i for i, (name, _l) in enumerate(self.references)}
        rid = ref_ids[reference_name]
        if end is None:
            end = self.references[rid][1]
        bai_path = bai_path or self._path + ".bai"
        bins_per_ref, linear_per_ref = read_bai(bai_path)
        bins = bins_per_ref[rid]
        linear = linear_per_ref[rid]
        min_off = linear[start >> 14] if (start >> 14) < len(linear) else 0
        chunks = []
        for b in _reg2bins(start, end):
            for beg, cend in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(beg, min_off), cend))
        chunks.sort()
        merged: List[List[int]] = []
        for beg, cend in chunks:
            if merged and beg <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], cend)
            else:
                merged.append([beg, cend])

        with open(self._path, "rb") as raw:
            for vbeg, vend in merged:
                for voff, body in _scan_records_raw(raw, vbeg, vend):
                    (r_id, pos0, _ln, _mq, _bin, n_cigar,
                     flag) = struct.unpack_from("<iiBBHHH", body)
                    if r_id != rid or flag & 0x4:
                        continue
                    l_name = body[8]
                    span = 0
                    for ci in range(n_cigar):
                        (cv,) = struct.unpack_from(
                            "<I", body, 32 + l_name + 4 * ci)
                        if (cv & 0xF) in (0, 2, 3, 7, 8):
                            span += cv >> 4
                    span = span or 1
                    if pos0 < end and pos0 + span > start:
                        yield self._parse(body)

    def _parse(self, body: bytes) -> SamRecord:
        return self._parse_body(body, self.references, self._parse_tags)

    @staticmethod
    def _parse_body(body: bytes, references, parse_tags: bool) -> SamRecord:
        (ref_id, pos0, l_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack("<iiBBHHHiiii", body[:32])
        off = 32
        name = body[off:off + l_name - 1].decode()
        off += l_name
        cigar_words = np.frombuffer(body, dtype="<u4", count=n_cigar,
                                    offset=off) if n_cigar else ()
        cigar = [(int(v) >> 4, CIGAR_OPS[int(v) & 0xF]) for v in cigar_words]
        off += 4 * n_cigar
        n_seq_bytes = (l_seq + 1) // 2
        packed = np.frombuffer(body, dtype=np.uint8, count=n_seq_bytes,
                               offset=off)
        nibs = np.empty(n_seq_bytes * 2, dtype=np.uint8)
        nibs[0::2] = packed >> 4
        nibs[1::2] = packed & 0xF
        seq = _SEQ_ASCII_LUT[nibs[:l_seq]].tobytes()
        off += n_seq_bytes
        qual_raw = body[off:off + l_seq]
        off += l_seq
        if l_seq == 0 or qual_raw[:1] == b"\xff":
            qual = b"*"
        else:
            qual = (np.frombuffer(qual_raw, dtype=np.uint8) + 33).tobytes()

        tags: Dict[str, str] = {}
        typed: Dict[str, Tuple[str, object]] = {}
        if parse_tags and off < len(body):
            BamReader._parse_tag_block(body[off:], tags, typed)

        ref_name = references[ref_id][0] \
            if 0 <= ref_id < len(references) else None
        return SamRecord(
            name=name, flag=flag, reference_name=ref_name,
            pos=pos0 + 1 if pos0 >= 0 else 0, mapq=mapq, cigar=cigar,
            seq=bytes(seq), qual=qual, tags=tags, typed_tags=typed)

    @staticmethod
    def _parse_tag_block(body: bytes, tags: Dict[str, str],
                         typed: Dict[str, Tuple[str, object]]) -> None:
        off = 0
        while off < len(body):
            tag = body[off:off + 2].decode()
            typ = chr(body[off + 2])
            off += 3
            if typ == "Z" or typ == "H":
                end = body.index(b"\x00", off)
                tags[tag] = body[off:end].decode()
                off = end + 1
            elif typ == "A":
                typed[tag] = ("A", chr(body[off])); off += 1
            elif typ in "cC":
                typed[tag] = ("i", body[off] if typ == "C" else
                              struct.unpack("<b", body[off:off+1])[0]); off += 1
            elif typ in "sS":
                fmt = "<h" if typ == "s" else "<H"
                typed[tag] = ("i", struct.unpack(fmt, body[off:off+2])[0]); off += 2
            elif typ in "iI":
                fmt = "<i" if typ == "i" else "<I"
                typed[tag] = ("i", struct.unpack(fmt, body[off:off+4])[0]); off += 4
            elif typ == "f":
                typed[tag] = ("f", struct.unpack("<f", body[off:off+4])[0]); off += 4
            elif typ == "B":
                sub = chr(body[off]); (n,) = struct.unpack("<i", body[off+1:off+5])
                width = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                off += 5 + n * width
                typed[tag] = ("B", None)
            else:
                raise ValueError(f"unknown BAM tag type {typ}")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_alignment_writer(path: str, references: List[Tuple[str, int]]):
    """BAM if path ends .bam, else SAM text."""
    if str(path).endswith(".bam"):
        return BamWriter(path, references)
    return SamWriter(path, references)


_CQI_MAGIC = b"CQI2"


def write_cqi(bam_path: str, chunk_offsets: List[Tuple[int, int]]) -> str:
    """Persist a chunk index sidecar (<bam>.cqi): record-boundary
    (BGZF virtual offset, record ordinal) pairs every
    ~BamWriter._CQI_EVERY records, ending with a sentinel
    (end-of-records voffset, total records). Lets distributed collapse
    deal byte ranges — each process inflates only O(1/P) of the file
    (collapse.rs:437-491's indexed access, scaled across hosts) — and
    stamp globally monotone read ordinals for order-stable grouping."""
    path = str(bam_path) + ".cqi"
    flat = [x for pair in chunk_offsets for x in pair]
    with open(path + ".tmp", "wb") as fh:
        fh.write(_CQI_MAGIC + struct.pack("<I", len(chunk_offsets)))
        fh.write(struct.pack(f"<{len(flat)}Q", *flat))
    os.replace(path + ".tmp", path)  # atomic: no truncated sidecars
    return path


def read_cqi(bam_path: str) -> Optional[List[Tuple[int, int]]]:
    """Chunk-index (voffset, ordinal) pairs for a BAM (sentinel-last), or
    None if no sidecar exists or the sidecar is STALE: the sentinel's
    virtual offset must equal the end-of-records position of the BAM as
    it exists NOW (filesize minus the EOF block) — a BAM rewritten by any
    other tool beside an old sidecar would otherwise yield silently wrong
    byte ranges."""
    path = str(bam_path) + ".cqi"
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            head = fh.read(8)
            if head[:4] != _CQI_MAGIC:
                return None
            (n,) = struct.unpack_from("<I", head, 4)
            flat = struct.unpack(f"<{2 * n}Q", fh.read(16 * n))
            pairs = list(zip(flat[0::2], flat[1::2]))
    except (struct.error, OSError):
        return None  # truncated/unreadable sidecar -> treat as absent
    if pairs:
        try:
            expect = (os.path.getsize(str(bam_path)) - len(_BGZF_EOF)) << 16
        except OSError:
            return None
        if pairs[-1][0] != expect:
            return None
    return pairs


def bam_ingest_ranges(bam_path: str):
    """(references, ranges) for byte-range-parallel ingest: ranges is
    [(vbeg, vend, base_ordinal)] from the chunk-index sidecar, or
    (None, None) when no valid sidecar exists (callers fall back to
    walking the whole stream). One place for the cqi-vs-fallback
    decision shared by the worker pools and the distributed ingest."""
    pairs = read_cqi(bam_path)
    if not pairs or len(pairs) < 2:
        return None, None
    reader = BamReader(bam_path, parse_tags=False)
    references = reader.references
    reader.close()
    return references, [(pairs[i][0], pairs[i + 1][0], pairs[i][1])
                        for i in range(len(pairs) - 1)]


def read_voffset_range(bam_path: str, vbeg: int,
                       vend: Optional[int] = None) -> bytes:
    """Inflate ONLY the BGZF blocks covering virtual range [vbeg, vend)
    and return the uncompressed record-stream bytes in that range (both
    bounds must be record boundaries, e.g. from read_cqi). vend=None
    reads to end of file. O(range bytes), independent of file size."""
    cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
    cend = None if vend is None else vend >> 16
    uend = None if vend is None else vend & 0xFFFF
    chunks: List[bytes] = []
    size_before_last = 0
    total = 0
    with open(bam_path, "rb") as fh:
        fh.seek(cbeg)
        while True:
            pos = fh.tell()
            if cend is not None and pos > cend:
                break
            head = fh.read(12)
            if len(head) < 12:
                break
            if head[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError(f"not a BGZF block at offset {pos}")
            (xlen,) = struct.unpack_from("<H", head, 10)
            extra = fh.read(xlen)
            bsize_m1, xp = None, 0
            while xp + 4 <= xlen:
                si1, si2, slen = struct.unpack_from("<BBH", extra, xp)
                if si1 == 66 and si2 == 67:
                    (bsize_m1,) = struct.unpack_from("<H", extra, xp + 4)
                xp += 4 + slen
            if bsize_m1 is None:
                raise ValueError(f"BGZF block without BC subfield at {pos}")
            rest = fh.read(bsize_m1 + 1 - 12 - xlen)
            data = zlib.decompress(rest[:-8], -15)
            size_before_last = total
            total += len(data)
            chunks.append(data)
            if cend is not None and pos == cend:
                break
    buf = b"".join(chunks)
    if uend is not None:
        buf = buf[:size_before_last + uend]
    return buf[ubeg:]


def concat_bam_parts(output_path: str, references: List[Tuple[str, int]],
                     part_paths: List[str],
                     header_text: Optional[str] = None) -> int:
    """Merge per-process part BAMs into one BAM by raw BGZF-block append.

    Every part must have been written by BamWriter with the SAME reference
    list (so its compressed header bytes are identical to the one this
    writer just minted); record blocks are self-contained BGZF, so the
    merge is O(bytes) with no inflate/recompress — the multi-host align
    merge (the rayon fanout of alignment_functions.rs:90-93 realized as
    one process per host writing a part BAM). Returns bytes appended."""
    writer = BamWriter(output_path, references, header_text)
    hdr = writer.header_size
    # freshly-minted header bytes: every part's first hdr bytes must equal
    # them exactly (exact and O(header) cheap, independent of the sidecar) -
    # a part written with a different reference list whose compressed header
    # happens to be the same size must not merge with misattributed ref_ids
    writer._raw.flush()
    with open(output_path, "rb") as _hf:
        minted_header = _hf.read(hdr)
    appended = 0
    base_ord = 0
    merged_cqi: Optional[List[Tuple[int, int]]] = []
    for part in part_paths:
        with open(part, "rb") as fh:
            raw = fh.read()
        if raw[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"not a BGZF BAM part: {part}")
        if raw[-28:] != _BGZF_EOF:
            raise ValueError(f"truncated part BAM (no EOF block): {part}")
        if raw[:hdr] != minted_header:
            raise ValueError(
                f"part {part} header bytes differ from the merged writer's "
                f"(different references or BGZF settings?), refusing to "
                f"merge")
        body = raw[hdr:-28]
        part_cqi = read_cqi(part)
        if part_cqi is None or len(part_cqi) < 1:
            merged_cqi = None  # can't cover this part; skip the sidecar
        # the part's compressed header must match this writer's byte for
        # byte (same references, same deflate settings) or the raw-block
        # append would start mid-block and silently corrupt the merge
        if part_cqi is not None and (part_cqi[0][0] >> 16) != hdr:
            raise ValueError(
                f"part {part} header size {(part_cqi[0][0] >> 16)} != "
                f"merged writer header {hdr} (different references or "
                f"BGZF settings?)")
        if body and body[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(
                f"part {part} does not start a BGZF block at offset "
                f"{hdr} — header mismatch, refusing to merge")
        if not body:
            continue
        base = writer._raw.tell()  # body appends at a block boundary
        if merged_cqi is not None:
            # translate part entries (sentinel dropped): compressed
            # offsets shift by (base - hdr), in-block offsets unchanged,
            # ordinals shift by the records of earlier parts
            merged_cqi.extend(
                (((base + (off >> 16) - hdr) << 16) | (off & 0xFFFF),
                 base_ord + ordn)
                for off, ordn in part_cqi[:-1] if (off >> 16) >= hdr)
            base_ord += part_cqi[-1][1]
        writer.write_bgzf_blocks(body)
        appended += len(body)
    writer.close()
    if merged_cqi is not None:
        merged_cqi.append(((os.path.getsize(output_path) - 28) << 16,
                           base_ord))
        write_cqi(output_path, merged_cqi)
    return appended


# --- BAI index: reg2bins + reader-side fetch ----------------------------------

def _scan_records_raw(raw, vbeg: int, vend: int
                      ) -> Iterator[Tuple[int, bytes]]:
    """Yield (voffset, record body) for records between virtual offsets
    [vbeg, vend) by inflating BGZF blocks from vbeg's compressed offset."""
    import bisect

    raw.seek(vbeg >> 16)
    buf = bytearray()
    starts: List[int] = []
    coffsets: List[int] = []

    def inflate_next() -> bool:
        coffset = raw.tell()
        head = raw.read(18)
        if len(head) < 18:
            return False
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = head[12:18] + raw.read(max(0, xlen - 6))
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, off)
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
            off += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF block")
        cdata = raw.read(bsize - 12 - xlen - 8)
        raw.read(8)
        starts.append(len(buf))
        coffsets.append(coffset)
        buf.extend(zlib.decompress(cdata, -15))
        return True

    def voffset_of(p: int) -> int:
        i = bisect.bisect_right(starts, p) - 1
        return (coffsets[i] << 16) | (p - starts[i])

    p = vbeg & 0xFFFF
    while True:
        while len(buf) < p + 4:
            if not inflate_next():
                return
        vcur = voffset_of(p)
        if vcur >= vend:
            return
        (block_size,) = struct.unpack_from("<i", buf, p)
        while len(buf) < p + 4 + block_size:
            if not inflate_next():
                return
        yield vcur, bytes(buf[p + 4:p + 4 + block_size])
        p += 4 + block_size

def _reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (SAM spec section 5.3)."""
    out = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def read_bai(path: str):
    """Parse a .bai -> (per-ref {bin: [(beg,end)]}, per-ref linear list)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:4] == b"BAI\x01", "not a BAI file"
    (n_ref,) = struct.unpack_from("<i", data, 4)
    p = 8
    bins_per_ref = []
    linear_per_ref = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, p)
        p += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _b in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, p)
            p += 8
            chunks = []
            for _c in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, p)
                p += 16
                chunks.append((beg, end))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, p)
        p += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, p))
        p += 8 * n_intv
        bins_per_ref.append(bins)
        linear_per_ref.append(linear)
    return bins_per_ref, linear_per_ref


# --- BAI index writer ---------------------------------------------------------

def build_bai(bam_path: str) -> bytes:
    """Build a .bai index for a (coordinate-ordered-per-reference) BAM in
    one streaming pass - the index the reference pipeline requires on its
    collapse inputs (collapse.rs:465 `bai::fs::read`). Works on any BAM
    this package writes (python, C-codec, or worker-compressed blocks)
    because it indexes the FILE, not the writer.

    Binning + 16kb linear index per the SAM spec section 5.2; chunks are
    (start, end) BGZF virtual offsets (coffset << 16 | uoffset)."""
    blocks: List[Tuple[int, int, int]] = []  # (coffset, cum_start, isize)
    data = bytearray()
    with open(bam_path, "rb") as fh:
        while True:
            coffset = fh.tell()
            head = fh.read(18)
            if len(head) < 18:
                break
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = head[12:12 + xlen] + fh.read(max(0, xlen - 6))
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2, slen = struct.unpack_from("<BBH", extra, off)
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
                off += 4 + slen
            if bsize is None:
                raise ValueError("not a BGZF block")
            cdata = fh.read(bsize - len(head) - (len(extra) - xlen) - 8)
            crc_isize = fh.read(8)
            isize = struct.unpack("<I", crc_isize[4:])[0]
            if isize:
                blocks.append((coffset, len(data), isize))
                data += zlib.decompress(cdata, -15)

    def voffset(p: int) -> int:
        """Decompressed position -> BGZF virtual offset."""
        import bisect

        i = bisect.bisect_right([b[1] for b in blocks], p) - 1
        coffset, cum, _ = blocks[i]
        return (coffset << 16) | (p - cum)

    # skip header
    assert data[:4] == b"BAM\x01"
    p = 4
    (l_text,) = struct.unpack_from("<i", data, p)
    p += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p)
        p += 4 + l_name + 4

    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in
                                                    range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    n_unmapped = 0
    while p + 4 <= len(data):
        (block_size,) = struct.unpack_from("<i", data, p)
        start_v = voffset(p)
        end_v = voffset(p + 4 + block_size)
        ref_id, pos0 = struct.unpack_from("<ii", data, p + 4)
        l_name = data[p + 12]
        n_cigar, flag = struct.unpack_from("<HH", data, p + 16)
        if ref_id < 0 or flag & 0x4:
            n_unmapped += 1
            p += 4 + block_size
            continue
        cig_off = p + 4 + 32 + l_name
        span = 0
        for ci in range(n_cigar):
            (cv,) = struct.unpack_from("<I", data, cig_off + 4 * ci)
            if (cv & 0xF) in (0, 2, 3, 7, 8):  # M D N = X consume reference
                span += cv >> 4
        span = span or 1
        b = _reg2bin(pos0, pos0 + span)
        chunks = bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == start_v:
            chunks[-1] = (chunks[-1][0], end_v)
        else:
            chunks.append((start_v, end_v))
        for win in range(pos0 >> 14, (pos0 + span - 1 >> 14) + 1):
            cur = linear[ref_id].get(win)
            if cur is None or start_v < cur:
                linear[ref_id][win] = start_v
        p += 4 + block_size

    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for r in range(n_ref):
        out += struct.pack("<i", len(bins[r]))
        for b in sorted(bins[r]):
            chunks = bins[r][b]
            out += struct.pack("<Ii", b, len(chunks))
            for beg, end in chunks:
                out += struct.pack("<QQ", beg, end)
        if linear[r]:
            n_intv = max(linear[r]) + 1
            out += struct.pack("<i", n_intv)
            last = 0
            for win in range(n_intv):
                v = linear[r].get(win)
                if v is not None:
                    last = v
                out += struct.pack("<Q", v if v is not None else last)
        else:
            out += struct.pack("<i", 0)
    out += struct.pack("<Q", n_unmapped)
    return bytes(out)


def write_bai(bam_path: str, bai_path: Optional[str] = None) -> str:
    bai_path = bai_path or bam_path + ".bai"
    idx = build_bai(bam_path)
    with open(bai_path, "wb") as fh:
        fh.write(idx)
    return bai_path
