"""String-graph clustering tools on PyTorch + CUDA.

Counterpart of clique_tpu/collapse/graph.py, its bodies as there; the
pairwise distances go to the port's collapse/distance.py
(edit_distance_pairs on `device`: the edit_distance kernel on a CUDA
device, host Myers on the CPU), and every class takes that device.

Re-derivations of the reference's auxiliary clustering components:

- Bron-Kerbosch maximal-clique enumeration (the package's namesake,
  the reference's rust_cmd/src/umis/bronkerbosch.rs:12-64);
- vantage-point string graph + connected components + balanced subgroup
  splitting (umis/sequence_clustering.rs:151-262) - with the VP-tree radius
  searches replaced by pigeonhole candidates + the batched device
  Levenshtein kernel (collapse/distance.py);
- SymSpell-style deletion-neighborhood known-list lookup
  (sequence_lookup.rs:7-50).
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from clique_tpu_torch.collapse.distance import candidate_pairs, edit_distance_pairs


class BronKerbosch:
    """Maximal cliques of an undirected graph (bronkerbosch.rs:12-64)."""

    def __init__(self, adjacency: Dict[object, Set[object]]):
        self.adj = {k: set(v) for k, v in adjacency.items()}
        self.max_cliques: List[Set[object]] = []

    def compute(self) -> List[Set[object]]:
        self._bk(set(self.adj.keys()), set(), set())
        return self.max_cliques

    def _bk(self, p: Set, r: Set, x: Set) -> None:
        if not p:
            if not x:
                self.max_cliques.append(set(r))
            return
        p_fp = set(p)
        x_fp = set(x)
        for v in list(p):
            nv = self.adj.get(v, set())
            self._bk(p_fp & nv, r | {v}, x_fp & nv)
            p_fp.discard(v)
            x_fp.add(v)


class StringGraph:
    """Undirected graph over strings with edges for pairs within
    max_distance (vantage_point_string_graph, sequence_clustering.rs:
    151-199), built with device distance kernels."""

    def __init__(self, strings: Sequence[bytes], counts: Optional[Dict[bytes, int]],
                 max_distance: int, device="cuda"):
        self.device = device
        self.strings = list(dict.fromkeys(strings))
        self.counts = counts or {s: 1 for s in self.strings}
        self.max_distance = max_distance
        self.edges: Set[Tuple[int, int]] = set()
        self.adj: Dict[int, Set[int]] = defaultdict(set)
        self._build()

    def _build(self) -> None:
        n = len(self.strings)
        if n < 2:
            return
        if n <= 2048:
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        else:
            max_len = max(len(s) for s in self.strings)
            padded = [s + b"-" * (max_len - len(s)) for s in self.strings]
            pairs = candidate_pairs(padded, self.max_distance)
        if not pairs:
            return
        d = edit_distance_pairs([self.strings[i] for i, _j in pairs],
                                [self.strings[j] for _i, j in pairs],
                                device=self.device)
        for (i, j), dd in zip(pairs, d):
            if dd <= self.max_distance:
                self.edges.add((i, j))
                self.adj[i].add(j)
                self.adj[j].add(i)

    def connected_components(self) -> List[List[bytes]]:
        """sequence_clustering.rs:256-262."""
        seen: Set[int] = set()
        out: List[List[bytes]] = []
        for start in range(len(self.strings)):
            if start in seen:
                continue
            stack = [start]
            comp = []
            seen.add(start)
            while stack:
                v = stack.pop()
                comp.append(self.strings[v])
                for w in self.adj.get(v, ()):
                    if w not in seen:
                        seen.add(w)
                        stack.append(w)
            out.append(comp)
        return out

    def max_set_distance(self, members: Sequence[bytes]) -> int:
        """Diameter of a member set (sequence_clustering.rs:202-213)."""
        if len(members) < 2:
            return 0
        pa, pb = [], []
        for a, b in itertools.combinations(members, 2):
            pa.append(a)
            pb.append(b)
        return int(max(edit_distance_pairs(pa, pb, device=self.device)))

    def split_subgroup(self, members: Sequence[bytes]
                       ) -> Optional[List[List[bytes]]]:
        """Try removing a single edge so the component splits into the most
        balanced two halves, each with diameter <= 2 * max_distance
        (sequence_clustering.rs:216-254)."""
        idx = {s: i for i, s in enumerate(self.strings)}
        member_ids = {idx[m] for m in members if m in idx}
        local_edges = [(i, j) for (i, j) in self.edges
                       if i in member_ids and j in member_ids]
        best: Optional[Tuple[int, List[List[bytes]]]] = None
        for drop in local_edges:
            adj = defaultdict(set)
            for (i, j) in local_edges:
                if (i, j) == drop:
                    continue
                adj[i].add(j)
                adj[j].add(i)
            comps: List[List[int]] = []
            seen: Set[int] = set()
            for v in member_ids:
                if v in seen:
                    continue
                stack, comp = [v], []
                seen.add(v)
                while stack:
                    u = stack.pop()
                    comp.append(u)
                    for w in adj.get(u, ()):
                        if w not in seen:
                            seen.add(w)
                            stack.append(w)
                comps.append(comp)
            if len(comps) != 2:
                continue
            g1 = [self.strings[i] for i in comps[0]]
            g2 = [self.strings[i] for i in comps[1]]
            if self.max_set_distance(g1) > 2 * self.max_distance or \
                    self.max_set_distance(g2) > 2 * self.max_distance:
                continue
            balance = abs(len(g1) - len(g2))
            if best is None or balance < best[0]:
                best = (balance, [g1, g2])
        return best[1] if best else None


class KnownLookup:
    """SymSpell-style known-list lookup (sequence_lookup.rs:7-50): index
    every deletion-neighborhood variant of the allowlist; correct a query by
    meeting it in deletion space."""

    def __init__(self, known: Sequence[bytes], max_distance: int = 2,
                 device="cuda"):
        self.device = device
        self.known = list(known)
        self.max_distance = max_distance
        self.index: Dict[bytes, List[int]] = defaultdict(list)
        for i, seq in enumerate(self.known):
            for var in self._deletes(seq, max_distance):
                self.index[var].append(i)

    @staticmethod
    def _deletes(seq: bytes, d: int) -> Set[bytes]:
        out = {seq}
        frontier = {seq}
        for _ in range(d):
            nxt = set()
            for s in frontier:
                for i in range(len(s)):
                    nxt.add(s[:i] + s[i + 1:])
            out |= nxt
            frontier = nxt
        return out

    def correct(self, sequence: bytes, max_distance: Optional[int] = None,
                if_multiple_take_first: bool = False) -> Optional[bytes]:
        d = max_distance if max_distance is not None else self.max_distance
        cands: Set[int] = set()
        for var in self._deletes(sequence, d):
            cands.update(self.index.get(var, ()))
        if not cands:
            return None
        ordered = sorted(cands)
        hits = []
        dists = edit_distance_pairs([sequence] * len(ordered),
                                    [self.known[i] for i in ordered],
                                    device=self.device)
        for i, dd in zip(ordered, dists):
            if dd <= d:
                hits.append((int(dd), i))
        if not hits:
            return None
        hits.sort()
        if len(hits) == 1 or if_multiple_take_first or \
                (len(hits) > 1 and hits[0][0] < hits[1][0]):
            return self.known[hits[0][1]]
        return None
