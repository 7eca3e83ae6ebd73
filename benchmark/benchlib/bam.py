"""A plain BAM reader: BGZF inflated by `gzip`, records decoded by
`struct`, per the SAM/BAM format specification (section 4.2). The
benchmark judges the program's BAM files with it, so it shares no code
with the program's own codec."""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SEQ_LUT = np.frombuffer(SEQ_CODES.encode(), dtype=np.uint8)
_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
            "I": "<I", "f": "<f", "A": "<c"}


class Record(NamedTuple):
    name: str
    reference: str          # "*" when unmapped
    pos: int                # 1-based, 0 when unmapped
    cigar: str
    seq: bytes
    tags: Dict[str, object]


def _tags(buf: bytes, i: int, end: int) -> Dict[str, object]:
    out: Dict[str, object] = {}
    while i < end:
        key = buf[i:i + 2].decode()
        t = chr(buf[i + 2])
        i += 3
        if t == "Z" or t == "H":
            j = buf.index(b"\0", i)
            out[key] = buf[i:j].decode()
            i = j + 1
        elif t == "B":
            sub = chr(buf[i])
            (n,) = struct.unpack_from("<i", buf, i + 1)
            fmt = _TAG_FMT[sub]
            size = struct.calcsize(fmt)
            out[key] = [struct.unpack_from(fmt, buf, i + 5 + k * size)[0]
                        for k in range(n)]
            i += 5 + n * size
        else:
            fmt = _TAG_FMT[t]
            (v,) = struct.unpack_from(fmt, buf, i)
            out[key] = v.decode() if t == "A" else v
            i += struct.calcsize(fmt)
    return out


def read_bam(path: str, names=None) -> Tuple[List[str], Iterator]:
    """(reference names, records in file order). With `names` (a set),
    the records of those reads in full and (reference, read length) of
    every other."""
    with open(path, "rb") as fh:
        buf = gzip.decompress(fh.read())
    if buf[:4] != b"BAM\1":
        raise ValueError(f"{path} is not a BAM file")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    i = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, i)
    i += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, i)
        refs.append(buf[i + 4:i + 4 + l_name - 1].decode())
        i += 8 + l_name

    def records(i=i):
        while i < len(buf):
            (block,) = struct.unpack_from("<i", buf, i)
            (ref_id, pos, l_name, _mapq, _bin, n_cig, _flag, l_seq
             ) = struct.unpack_from("<iiBBHHHi", buf, i + 4)
            j = i + 36
            name = buf[j:j + l_name - 1].decode()
            j += l_name
            end = i + 4 + block
            if names is not None and name not in names:
                yield refs[ref_id] if ref_id >= 0 else "*", l_seq
                i = end
                continue
            cig = struct.unpack_from(f"<{n_cig}I", buf, j)
            j += 4 * n_cig
            packed = np.frombuffer(buf, np.uint8, (l_seq + 1) // 2, j)
            nib = np.empty(2 * len(packed), np.uint8)
            nib[0::2] = _SEQ_LUT[packed >> 4]
            nib[1::2] = _SEQ_LUT[packed & 15]
            seq = nib[:l_seq].tobytes()
            j += (l_seq + 1) // 2 + l_seq
            yield Record(name, refs[ref_id] if ref_id >= 0 else "*", pos + 1,
                         "".join(f"{c >> 4}{CIGAR_OPS[c & 15]}" for c in cig),
                         seq, _tags(buf, j, end))
            i = end

    return refs, records()


def scan_bam(path: str, names):
    """One pass over a BAM: ({name: Record} of the reads in `names`,
    [(reference, read length)] of every record)."""
    _refs, items = read_bam(path, names=set(names))
    full, lens = {}, []
    for it in items:
        if isinstance(it, Record):
            full[it.name] = it
            lens.append((it.reference, len(it.seq)))
        else:
            lens.append(it)
    return full, lens
