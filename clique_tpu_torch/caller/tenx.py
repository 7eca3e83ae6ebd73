"""10X Genomics single-cell companion stats (host code).

Counterpart of clique_tpu/caller/tenx.py, copied as it is.

Working re-design of the reference's python_package/clique/tenX.py
(TenXSingleCellStats :7-65): read CellRanger filtered/raw barcode lists,
apply the 3M-february-2018 feature-barcode translation, optionally load the
raw coverage matrix.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Tuple


def read_10x_cell_list(cell_list_file: str) -> List[str]:
    out = []
    with gzip.open(cell_list_file, "rt") as fh:
        for line in fh:
            out.append(line.split("-")[0])
    return out


class TenXSingleCellStats:
    def __init__(self, ten_x_out_directory: str,
                 matching_list: Optional[str] = None,
                 read_coverage: bool = False):
        self.ten_x_out_directory = ten_x_out_directory
        self.filtered_list, self.unfiltered_list = self.read_10x_cell_lists()
        self.matching_list: Dict[str, str] = {}
        self.filtered_list_matched: List[str] = list(self.filtered_list)
        if matching_list:
            self.map_feature_barcode(matching_list)
        if read_coverage:
            self.read_cell_coverage()

    def read_10x_cell_lists(self) -> Tuple[List[str], List[str]]:
        filtered = read_10x_cell_list(os.path.join(
            self.ten_x_out_directory,
            "filtered_feature_bc_matrix/barcodes.tsv.gz"))
        unfiltered = read_10x_cell_list(os.path.join(
            self.ten_x_out_directory,
            "raw_feature_bc_matrix/barcodes.tsv.gz"))
        assert len(set(filtered).intersection(unfiltered)) == len(filtered)
        return filtered, unfiltered

    def map_feature_barcode(self, matching_list_file: str) -> None:
        """Translate capture-tagged IDs to cell IDs via the 10X
        3M-february-2018 map (tenX.py:31-44)."""
        self.matching_list = {}
        with gzip.open(matching_list_file, "rt") as fh:
            for line in fh:
                tks = line.strip().split("\t")
                if len(tks) >= 2:
                    self.matching_list[tks[1]] = tks[0]
        self.filtered_list_matched = [
            self.matching_list[x] for x in self.filtered_list
            if x in self.matching_list]

    def get_passing_cell_ids(self, mapped_to_known_tag: bool) -> List[str]:
        if mapped_to_known_tag:
            return self.filtered_list_matched
        return self.filtered_list

    def read_cell_coverage(self) -> None:
        from scipy.io import mmread

        raw = mmread(os.path.join(
            self.ten_x_out_directory, "raw_feature_bc_matrix/matrix.mtx.gz"))
        self.unfiltered_cell_coverage = raw.sum(0)
        assert self.unfiltered_cell_coverage.shape[1] == \
            len(self.unfiltered_list)
