"""Native (C) runtime components, loaded via ctypes.

The shared library is built on first use from bamcodec.c (cc -O3 -shared
-fPIC -lz) into the package's gitignored _build/ directory, keyed by a hash
of the source; no pybind11/pip needed. Falls back to the pure-python
codecs in io/sam.py when no C compiler is available."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

log = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[str]:
    src = os.path.join(os.path.dirname(__file__), "bamcodec.c")
    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "bamcodec")
    out = os.path.join(out_dir, f"_bamcodec.{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    for cc in ("cc", "gcc", "clang"):
        try:
            res = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src, "-lz"],
                capture_output=True, timeout=120)
            if res.returncode == 0:
                os.replace(tmp, out)
                return out
            log.debug("%s failed: %s", cc, res.stderr.decode()[:500])
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The bamcodec shared library, or None if unbuildable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build_lib()
    if path is None:
        log.warning("no C compiler found; using pure-python BAM codec")
        return None
    lib = ctypes.CDLL(path)
    lib.encode_bam_records.restype = ctypes.c_long
    lib.encode_bam_records.argtypes = [
        ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long,
    ]
    lib.encode_fastpath_records.restype = ctypes.c_long
    lib.encode_fastpath_records.argtypes = [
        ctypes.c_long,
        ctypes.c_void_p,                     # ref_ids
        ctypes.c_char_p, ctypes.c_void_p,    # name blob/off
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cigar runs
        ctypes.c_char_p, ctypes.c_void_p,    # seq blob/off
        ctypes.c_long, ctypes.c_char_p,      # n_syms, syms
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # captures
        ctypes.c_char_p, ctypes.c_void_p,    # rm strings
        ctypes.c_char_p, ctypes.c_void_p,    # score strings
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,  # out, cap, rec_off
    ]
    lib.bgzf_compress.restype = ctypes.c_long
    lib.bgzf_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long,
    ]
    lib.fastq_scan.restype = ctypes.c_long
    lib.fastq_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p,    # name off/len
        ctypes.c_void_p, ctypes.c_void_p,    # seq off/len
        ctypes.c_void_p, ctypes.c_void_p,    # qual off/len
        ctypes.c_void_p, ctypes.c_void_p,    # consumed, stopped
    ]
    lib.decode_bam_records.restype = ctypes.c_long
    lib.decode_bam_records.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    _LIB = lib
    return _LIB
