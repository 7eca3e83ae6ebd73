"""Plain reference of the lineage chain (align -> collapse -> call) on
one amplicon: what the program's aligned BAM, collapsed BAM and allele
table must hold, worked out from the reads and the configuration alone.

- Align: every read against the amplicon by the global affine DP
  (`affine_dp`, upstream rust-bio-compatible scoring, a reference N the
  only wildcard). A tag is the read's bytes in the columns where the
  reference holds the tag's digit, gaps included.
- Collapse (upstream collapse.rs, correct_tags.rs, consensus_builders.rs):
  a read passes when its aligned columns hold at least `min_aligned_bases`
  letter pairs (the reference not N) of which `min_identical` agree. Level
  by level (cell barcode, then UMI within each corrected cell), a tag whose
  gapless length lies outside length +- max_distance drops its read; the
  rest are right-padded with '-' to the length and counted. A tag b is
  absorbed by the tag a of highest count (then the smallest bytes) within
  Levenshtein max_distance (on tags padded with '-' to the group's
  longest) whose count is at least `ratio` times b's and differs from it;
  absorption chains resolve to their root. A group of reads that share
  their corrected tags becomes one record named after its first read:
  one member is written as aligned; several, with no insertion in any
  member, take per column the most frequent of A, C, G, T (the last of
  equals), or a gap where gaps are at least `gap_call_threshold` of the
  column's bases.
- Call (upstream callers.py): for records whose alignment rate is at least
  0.9, per target occurrence (substring matches of the target in the
  amplicon and in its reverse complement) the deletion and insertion runs
  that touch its Cas9 editing window (14..19 from its start), NONE, or
  UNKNOWN outside the read's covered span, joined with '_'.

Groups of several reads with an insertion in a member are judged by their
members and tags only; `unjudged` counts them.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference import affine_dp

GAP = ord("-")
CAS9_WINDOW = (14, 19)


def levenshtein(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """Levenshtein distance of a[p, :w[p]] and b[p, :w[p]], u8 rows [P, W]."""
    P, W = a.shape
    prev = torch.arange(W + 1, dtype=torch.int16, device=a.device
                        ).expand(P, W + 1).clone()
    out = torch.full((P,), -1, dtype=torch.long, device=a.device)
    for i in range(1, W + 1):
        cur = torch.empty_like(prev)
        cur[:, 0] = i
        ai = a[:, i - 1:i]
        sub = prev[:, :-1] + (ai != b).to(torch.int16)
        dele = prev[:, 1:] + 1
        best = torch.minimum(sub, dele)
        for j in range(1, W + 1):
            cur[:, j] = torch.minimum(best[:, j - 1], cur[:, j - 1] + 1)
        done = w == i
        out = torch.where(done, cur.gather(1, w[:, None])[:, 0].long(), out)
        prev = cur
    return out


def correct(groups: List[Counter], max_distance: int, length: int,
            ratio: float, device, chunk: int = 1 << 21
            ) -> List[Dict[bytes, bytes]]:
    """The correction map of each group of normalized tag counts."""
    rows, h_all, j_all, w_all, g_all = [], [], [], [], []
    tags_of, cnt_of = [], []
    off = 0
    for gi, counts in enumerate(groups):
        tags = list(counts)
        cnt = np.array([counts[t] for t in tags], np.int64)
        tags_of.append(tags)
        cnt_of.append(cnt)
        if len(tags) < 2:
            continue
        w = max(map(len, tags))
        rows.extend(t.ljust(w, b"-") for t in tags)
        for h in np.flatnonzero(cnt >= ratio * cnt.min()).tolist():
            js = np.flatnonzero((cnt * ratio <= cnt[h]) & (cnt != cnt[h]))
            h_all.append(np.full(len(js), off + h, np.int64))
            j_all.append(js + off)
            w_all.append(np.full(len(js), w, np.int64))
            g_all.append(np.full(len(js), gi, np.int64))
        off += len(tags)
    close: List[List] = [[] for _ in groups]
    if h_all:
        W = max(map(len, rows))
        mat = np.frombuffer(b"".join(r.ljust(W, b"-") for r in rows),
                            np.uint8).reshape(len(rows), W)
        mat = torch.from_numpy(mat.copy()).to(device)
        hs, js, ws, gs = (np.concatenate(x) for x in (h_all, j_all, w_all,
                                                       g_all))
        starts = np.concatenate(([0], np.cumsum([len(t) if len(t) > 1 else 0
                                                 for t in tags_of])))
        for s in range(0, len(hs), chunk):
            h = torch.from_numpy(hs[s:s + chunk]).to(device)
            j = torch.from_numpy(js[s:s + chunk]).to(device)
            w = torch.from_numpy(ws[s:s + chunk]).to(device)
            near = (levenshtein(mat[h], mat[j], w) <= max_distance).cpu()
            for k in torch.nonzero(near)[:, 0].tolist():
                gi = int(gs[s + k])
                close[gi].append((int(hs[s + k] - starts[gi]),
                                  int(js[s + k] - starts[gi])))
    maps = []
    for gi, tags in enumerate(tags_of):
        cnt = cnt_of[gi]
        parent = list(range(len(tags)))
        for h, j in close[gi]:
            cur = parent[j]
            if cur == j or cnt[h] > cnt[cur] or (cnt[h] == cnt[cur]
                                                  and tags[h] < tags[cur]):
                parent[j] = h

        def root(i):
            seen = set()
            while parent[i] != i and i not in seen:
                seen.add(i)
                i = parent[i]
            return i

        maps.append({t: tags[root(i)] for i, t in enumerate(tags)})
    return maps


def _norm(tag: bytes, length: int) -> bytes:
    s = tag.replace(b"-", b"")
    return s.ljust(length, b"-") if len(s) < length else s


def _rate(ra: np.ndarray, qa: np.ndarray) -> float:
    counted = (ra > 64) & (ra != 78) & (qa > 64)
    tot = int(counted.sum())
    return float(((ra == qa) & counted).sum() / tot) if tot else float("nan")


def _fmt(x: float) -> str:
    if x != x:
        return "NaN"
    if x == int(x):
        return str(int(x))
    return repr(x)


def _cigar_of(ra: np.ndarray, qa: np.ndarray) -> str:
    ops = np.where(ra == GAP, 2, np.where(qa == GAP, 1, 0))
    return affine_dp._cigar(ops)


def _targets(reference: str, targets: Sequence[str]):
    """Editing windows in target order: every substring match of a target
    in the amplicon, then in its reverse complement (in the reverse
    complement's coordinates, as upstream reports them)."""
    ref = reference.upper()
    comp = str.maketrans("ACGTN", "TGCAN")
    rc = ref.translate(comp)[::-1]
    out = []
    for t in targets:
        pat = re.escape(t.upper())
        for seq in (ref, rc):
            out.extend((m.start() + CAS9_WINDOW[0], m.start() + CAS9_WINDOW[1])
                       for m in re.finditer(pat, seq))
    return out


def call(ra: np.ndarray, qa: np.ndarray, windows) -> str:
    """The allele string of one gapped (reference, read) pair."""
    read_ng, ref_ng = qa != GAP, ra != GAP
    nz = np.flatnonzero(read_ng)
    n = len(ra)
    first, last = (int(nz[0]), int(nz[-1])) if len(nz) else (n, -1)
    coord = np.cumsum(ref_ng) - ref_ng
    total = int(ref_ng.sum())
    cov_start = int(coord[first]) if first < n else total
    cov_stop = int(coord[last]) if last >= 0 else -1
    events = []

    def runs(mask):
        e = np.flatnonzero(np.diff(np.concatenate(([0], mask.astype(np.int8),
                                                   [0]))))
        return zip(e[0::2].tolist(), e[1::2].tolist())

    dmask = ref_ng & ~read_ng
    dmask[:max(first, 0)] = False
    dmask[last + 1:] = False
    for s, e in runs(dmask):
        st = int(coord[s])
        events.append((s, st, st + e - s - 1, f"{e - s}D+{st}"))
    for s, e in runs(~ref_ng & read_ng):
        st = int(coord[s])
        events.append((s, st, st, f"{e - s}I+{st}+{qa[s:e].tobytes().decode()}"))
    events.sort(key=lambda ev: ev[0])
    out = []
    for ws, we in windows:
        if ws > cov_stop or we < cov_start:
            out.append("UNKNOWN")
            continue
        hits = [ev[3] for ev in events if ev[1] <= we and ev[2] >= ws]
        out.append("&".join(hits) if hits else "NONE")
    return "_".join(out)


def expected(inputs, config, device, dtype=torch.float32, block=16384):
    """What a pass must produce: {"aligned": {name: (pos, cigar, seq, e0,
    e1)}, "collapsed": {name: fields}, "alleles": {name: row},
    "unjudged": int}."""
    ref_name, ref_seq = inputs["references"][0]
    reads = inputs["reads"]
    names = [n for n, _ in reads]
    als = affine_dp.align([ref_seq] * len(reads), [s for _, s in reads],
                          "rust_bio_compat", "ref_n_only", device, dtype,
                          block=block)
    levels = [("0", config["cell_barcode"]), ("1", config["umi"])]
    aligned = {}
    tags = []
    for (name, seq), al in zip(reads, als):
        raw = {sym: affine_dp.extract(al, ord(sym))[1] for sym, _ in levels}
        aligned[name] = (1, al.cigar, seq, raw["0"].decode(), raw["1"].decode())
        tags.append(raw)
    # the alignment check
    passing = []
    for k, al in enumerate(als):
        ra = np.frombuffer(al.ref_aligned, np.uint8)
        qa = np.frombuffer(al.read_aligned, np.uint8)
        m = (ra > 59) & (qa > 59) & (ra != 78)
        n_al = int(m.sum())
        if n_al > 0 and n_al >= config["min_aligned_bases"] and \
                int(((ra == qa) & m).sum()) / n_al >= config["min_identical"]:
            passing.append(k)
    ratio = float(config["minimum_collapsing_difference"])
    # groups: key -> member indices; keys are the corrected tags so far
    groups: Dict[tuple, List[int]] = {(): passing}
    keys: Dict[int, List] = {k: [] for k in passing}
    for sym, tag in levels:
        lo, hi = tag["length"] - tag["max_distance"], \
            tag["length"] + tag["max_distance"]
        order = list(groups)
        counts = []
        kept = []
        for key in order:
            c: Counter = Counter()
            keep = []
            for k in groups[key]:
                gl = tags[k][sym].replace(b"-", b"")
                if lo <= len(gl) <= hi:
                    c[_norm(gl, tag["length"])] += 1
                    keep.append(k)
            counts.append(c)
            kept.append(keep)
        maps = correct(counts, tag["max_distance"], tag["length"], ratio,
                       device)
        nxt: Dict[tuple, List[int]] = {}
        for key, keep, cmap in zip(order, kept, maps):
            for k in keep:
                orig = _norm(tags[k][sym], tag["length"])
                keys[k].append((sym, orig, cmap[orig]))
                nxt.setdefault(key + (cmap[orig],), []).append(k)
        groups = nxt
    ref_u8 = np.frombuffer(ref_seq, np.uint8)
    windows = _targets(ref_seq.decode(), inputs["targets"])
    collapsed, alleles, unjudged = {}, {}, 0
    for members in groups.values():
        members = sorted(members)
        base = members[0]
        fields = {"rc": str(len(members)),
                  "dc": str(min(40, len(members))),
                  "ar": ",".join(names[k] for k in members)}
        for sym, orig, corr in keys[base]:
            fields[f"e{sym}"] = corr.decode()
            fields[f"o{sym}"] = orig.decode()
        pair = None
        if len(members) == 1:
            al = als[base]
            pair = (np.frombuffer(al.ref_aligned, np.uint8),
                    np.frombuffer(al.read_aligned, np.uint8))
        elif all(als[k].ref_aligned == ref_seq for k in members):
            rows = np.stack([np.frombuffer(als[k].read_aligned, np.uint8)
                             for k in members])
            cnt = np.stack([(rows == b).sum(0) for b in b"ACGTN-"])
            total = cnt.sum(0)
            pick = 3 - np.argmax(cnt[3::-1], axis=0)
            gap = (total == 0) | (cnt[5] / np.maximum(total, 1)
                                  >= config["gap_call_threshold"])
            bases = np.where(gap, GAP, np.frombuffer(b"ACGT", np.uint8)[pick])
            pair = (ref_u8, bases.astype(np.uint8))
        else:
            unjudged += 1
        if pair is not None:
            ra, qa = pair
            rate = _rate(ra, qa)
            fields.update(cigar=_cigar_of(ra, qa), seq=qa[qa != GAP].tobytes(),
                          rm=_fmt(rate))
            if rate >= 0.9:
                alleles[names[base]] = (ref_name, call(ra, qa, windows),
                                        fields["rc"], fields["rm"],
                                        fields["e0"], fields["e1"])
        collapsed[names[base]] = fields
    return {"aligned": aligned, "collapsed": collapsed, "alleles": alleles,
            "unjudged": unjudged}
