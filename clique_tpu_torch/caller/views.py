"""BAM read-set views for lineage analysis (host code).

Counterpart of clique_tpu/caller/views.py, on the port's BAM reader,
EventCaller and extractor; integration_id_distances takes a `device` for
the port's edit_distance_pairs (the edit_distance kernel on a CUDA
device, host Myers on the CPU).

Working re-design of the reference's python_package/clique/views.py
(CliqueReadSet :12-30, LineageBamFile :33-74, BaseCalledCell /
BaseEditingCellList :77-92,168-198, CellList integration-ID clustering
:95-134) on top of our own BAM reader (no pysam) and completed caller.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from clique_tpu_torch.caller.events import EventCaller
from clique_tpu_torch.io.sam import BamReader, SamRecord

log = logging.getLogger(__name__)


@dataclass
class CliqueReadSet:
    """One tagged read with its extracted barcodes e0..e9 (views.py:12-30)."""

    tags: Dict[str, str]
    name: str
    read: bytes
    alignment_rate: float
    read_count: int
    cigar: str
    caller: Optional[EventCaller] = None
    _record: Optional[SamRecord] = None
    reference_sequence: Optional[str] = None

    def __getattr__(self, item):
        if item.startswith("e") and len(item) == 2 and item[1].isdigit():
            return self.tags.get(item)
        raise AttributeError(item)

    def reference_difference(self) -> Optional[str]:
        """The per-target allele string for this read (completed version of
        views.py:26)."""
        if self.caller is None or self._record is None or \
                self.reference_sequence is None:
            return None
        from clique_tpu_torch.extract.extractor import recover_aligned_sequences

        aligned_read, aligned_ref = recover_aligned_sequences(
            self._record.seq, self._record.pos, self._record.cigar,
            self.reference_sequence.encode(), soft_clip="Clip")
        return self.caller.call_events(aligned_ref.decode(),
                                       aligned_read.decode())


def lineage_bam_reads(bam_file: str, reference: Optional[str],
                      minimum_alignment_rate: float,
                      minimum_read_count: int,
                      anchors: Sequence[str] = (),
                      caller: Optional[EventCaller] = None
                      ) -> Iterator[CliqueReadSet]:
    """LineageBamFile (views.py:33-74) as a plain generator: yields reads
    passing rm/rc thresholds that contain at least one anchor substring."""
    with BamReader(bam_file) as reader:
        for rec in reader:
            tags = {k: v for k, v in rec.tags.items()
                    if len(k) == 2 and k[0] == "e" and k[1].isdigit()}
            rm = float(rec.tags.get("rm", "0") or "0")
            rc = int(rec.tags.get("rc", "0") or "0")
            if rm >= minimum_alignment_rate and rc >= minimum_read_count and \
                    (not anchors or
                     any(a.encode() in rec.seq for a in anchors)):
                yield CliqueReadSet(
                    tags=tags, name=rec.name, read=rec.seq,
                    alignment_rate=rm, read_count=rc,
                    cigar=rec.cigar_string, caller=caller, _record=rec,
                    reference_sequence=reference)


@dataclass
class BaseCalledCell:
    """views.py:77-92."""

    cell_id: str
    integration_ids: List[str] = field(default_factory=list)
    editing_outcomes: Dict[str, List] = field(default_factory=dict)
    read_counts: List[int] = field(default_factory=list)

    def add_editing(self, integration_id: str, editing_outcome,
                    read_count: int) -> None:
        if integration_id in self.integration_ids:
            self.editing_outcomes[integration_id].append(editing_outcome)
            self.read_counts[
                self.integration_ids.index(integration_id)] += read_count
        else:
            self.integration_ids.append(integration_id)
            self.editing_outcomes[integration_id] = [editing_outcome]
            self.read_counts.append(read_count)


class BaseEditingCellList:
    """Aggregate editing outcomes per cell (views.py:168-198)."""

    def __init__(self, read_iterator: Iterable[CliqueReadSet],
                 known_cell_ids: Sequence[str], cell_id_tag: str,
                 integration_id_tag: str):
        self.matched_cell_barcodes = 0
        self.unmatched_cell_barcodes = 0
        self.matched_cells: Dict[str, BaseCalledCell] = {
            x: BaseCalledCell(x) for x in known_cell_ids}
        for idx, read in enumerate(read_iterator):
            cell_id = getattr(read, cell_id_tag, None)
            if cell_id in self.matched_cells:
                self.matched_cells[cell_id].add_editing(
                    getattr(read, integration_id_tag, None),
                    read.reference_difference(), read.read_count)
                self.matched_cell_barcodes += 1
            else:
                self.unmatched_cell_barcodes += 1
            if idx and idx % 10_000_000 == 0:
                log.info("Processed %d reads", idx)


def integration_id_distances(list1: Sequence[str], list2: Sequence[str],
                             device="cuda") -> np.ndarray:
    """Pairwise Levenshtein distance matrix via the device kernel (working
    version of views.py:110-122)."""
    from clique_tpu_torch.collapse.distance import edit_distance_pairs

    pa, pb = [], []
    for a in list1:
        for b in list2:
            pa.append(a.encode())
            pb.append(b.encode())
    d = edit_distance_pairs(pa, pb, device=device)
    return np.asarray(d, dtype=np.float64).reshape(len(list1), len(list2))


def cluster_integration_ids(integration_ids: Sequence[str],
                            distance_threshold: float = 2.0,
                            device="cuda") -> Dict[str, int]:
    """Single-linkage agglomerative clustering of integration IDs on
    Levenshtein distances (working version of views.py:97-108). Returns
    {integration_id: cluster_label}."""
    if not integration_ids:
        return {}
    if len(integration_ids) == 1:
        return {integration_ids[0]: 0}
    from sklearn.cluster import AgglomerativeClustering

    distances = integration_id_distances(integration_ids, integration_ids,
                                         device)
    clustering = AgglomerativeClustering(
        n_clusters=None, distance_threshold=distance_threshold,
        metric="precomputed", linkage="single").fit(distances)
    return {iid: int(lbl)
            for iid, lbl in zip(integration_ids, clustering.labels_)}
