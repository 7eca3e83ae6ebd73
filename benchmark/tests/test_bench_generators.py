"""The generators make the same inputs from the same seed, other inputs
of the same sizes from another, and a layout the program reads."""

import json
import os

import pytest

from benchlib import runner
from conftest import BENCH


def _make(tmp_path, cell_name, seed, **over):
    _wl, config, cell = runner.Manifest(os.path.dirname(BENCH)).cell(
        cell_name)
    cell = dict(cell, **over)
    gen = runner.part("generators", config["generator"])
    d = tmp_path / str(seed)
    d.mkdir(parents=True, exist_ok=True)
    return gen.generate(config, cell, seed, str(d))


CASES = [("panel180.hmm", {"reads_per_reference": 2}),
         ("gestalt.chain", {"reads": 300})]


@pytest.mark.parametrize("cell,over", CASES)
def test_same_seed_same_inputs(tmp_path, cell, over):
    a = _make(tmp_path / "a", cell, 2 ** 31 + 7, **over)
    b = _make(tmp_path / "b", cell, 2 ** 31 + 7, **over)
    assert a["reads"] == b["reads"] and a["references"] == b["references"]
    assert a["layout_text"] == b["layout_text"]
    with open(a["fastq"]) as fa, open(b["fastq"]) as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("cell,over", CASES)
def test_other_seed_same_sizes(tmp_path, cell, over):
    a = _make(tmp_path, cell, 11, **over)
    b = _make(tmp_path, cell, 12, **over)
    assert a["reads"] != b["reads"]
    assert [len(s) for _n, s in a["references"]] == \
        [len(s) for _n, s in b["references"]]
    assert len(a["reads"]) == len(b["reads"])


@pytest.mark.parametrize("cell,over", CASES)
def test_layout_parses(tmp_path, cell, over):
    from clique_tpu_torch.config.layout import SequenceLayout

    inp = _make(tmp_path, cell, 5, **over)
    layout = SequenceLayout.from_yaml_string(inp["layout_text"])
    assert sorted(layout.references) == sorted(n for n, _ in
                                               inp["references"])


def test_panel_sizes(tmp_path):
    inp = _make(tmp_path, "panel180.hmm", 3)
    assert len(inp["references"]) == 180 and len(inp["reads"]) == 36000
    assert {len(s) for _n, s in inp["references"]} == {230}
    refs = [s for _n, s in inp["references"]]
    assert all(r[:80] == refs[0][:80] and r[100:] == refs[0][100:]
               for r in refs)


def test_panel_indels_change_lengths(tmp_path):
    inp = _make(tmp_path, "panel180.hmm", 3, reads_per_reference=2,
                insertion=0.02, deletion=0.02, trim=10)
    assert len({len(s) for _n, s in inp["reads"]}) > 1


def test_chain_sizes(tmp_path):
    with open(os.path.join(BENCH, "configs", "gestalt_sc_v3.json")) as fh:
        cfg = json.load(fh)
    inp = _make(tmp_path, "gestalt.chain", 3, reads=100)
    (_n, ref), = inp["references"]
    assert len(ref) == 342
    assert ref.count(b"0") == cfg["cell_barcode"]["length"]
    assert ref.count(b"1") == cfg["umi"]["length"]
    assert len(inp["targets"]) == cfg["targets"]
