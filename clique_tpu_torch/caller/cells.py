"""Cell grouping from tagged BAMs (host code).

Counterpart of clique_tpu/caller/cells.py, on the port's BAM reader.

Working re-design of the reference's python_package/clique/cell.py
(CellManager :24-64) on our own BAM reader: group reads into cells keyed by
a configured tuple of tags, intersect with a known transcriptome cell-ID
list.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from clique_tpu_torch.io.sam import BamReader


@dataclass
class Cell:
    barcode_sequences: List[Dict[str, str]] = field(default_factory=list)

    def add_barcodes(self, keys_and_values: Dict[str, str]) -> None:
        self.barcode_sequences.append(dict(keys_and_values))

    def __repr__(self) -> str:
        return f"Cell with {len(self.barcode_sequences)} barcodes"


class CellManager:
    """cell.py:24-64: cells keyed by '.'-joined values of the configured
    cell-defining tags."""

    def __init__(self, bam_file_path: str,
                 tags_that_define_cell: Sequence[str],
                 other_tags: Sequence[str]):
        self.cells: Dict[str, Cell] = {}
        self.bam_file_path = bam_file_path
        self.tags_that_define_cell = list(tags_that_define_cell)
        self.other_tags = list(other_tags)
        self.transcriptome_known_cell_ids: Dict[str, bool] = {}
        self.process_bam_file()

    def process_bam_file(self) -> None:
        with BamReader(self.bam_file_path) as reader:
            for read in reader:
                try:
                    tag_values = {t: read.tags[t]
                                  for t in self.tags_that_define_cell}
                except KeyError:
                    continue
                address = ".".join(tag_values.values())
                if address not in self.cells:
                    self.cells[address] = Cell()
                for tag in self.other_tags:
                    if tag in read.tags:
                        tag_values[tag] = read.tags[tag]
                self.cells[address].add_barcodes(tag_values)

    def add_known_cell_id_list(self, cell_id_list: Sequence[str]) -> None:
        for cid in cell_id_list:
            self.transcriptome_known_cell_ids[cid] = True

    def intersection(self) -> Tuple[int, int]:
        matching = sum(1 for cell in self.cells
                       if cell in self.transcriptome_known_cell_ids)
        return matching, len(self.cells) - matching

    def get_cell(self, tag_values: str):
        return self.cells.get(tag_values)

    def __repr__(self) -> str:
        return f"CellManager with {len(self.cells)} cells"
