"""The port's host modules that no verb reaches, each held against the
JAX package's on the same inputs (device="cpu" for the distance calls;
distances, clusters, maps and tables compare exactly):

- collapse/graph.py (BronKerbosch, StringGraph, KnownLookup), the cases
  of tests/test_graph.py;
- caller/views.py, caller/cells.py (tests/test_views.py) and
  caller/tenx.py;
- utils/read_sim.py (tests/test_multiref.py:103);
- collapse/correct.py::correct_degenerate, the one-group form
  (tests/test_collapse_correct.py:64-113), and its agreement with
  correct_degenerate_groups (tests/test_pigeonhole.py:251)."""

import gzip

import numpy as np
import pytest

from clique_tpu_torch.collapse.correct import (correct_degenerate,
                                               correct_degenerate_groups)
from clique_tpu_torch.collapse.graph import (BronKerbosch, KnownLookup,
                                             StringGraph)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


# --- collapse/graph.py (tests/test_graph.py) --------------------------------

def test_bron_kerbosch_triangle_plus_edge():
    from clique_tpu.collapse.graph import BronKerbosch as JaxBK

    adj = {1: {2, 3}, 2: {1, 3}, 3: {1, 2, 4}, 4: {3}}
    cliques = BronKerbosch(adj).compute()
    as_sets = {frozenset(c) for c in cliques}
    assert frozenset({1, 2, 3}) in as_sets
    assert frozenset({3, 4}) in as_sets
    assert as_sets == {frozenset(c) for c in JaxBK(adj).compute()}


def test_string_graph_components():
    from clique_tpu.collapse.graph import StringGraph as JaxSG

    strings = [b"AAAAAAAA", b"AAAAAAAT", b"AAAAAATT",
               b"GGGGGGGG", b"GGGGGGGC"]
    g = StringGraph(strings, None, max_distance=1, device="cpu")
    comps = sorted(g.connected_components(), key=len, reverse=True)
    assert len(comps) == 2
    assert set(comps[0]) == {b"AAAAAAAA", b"AAAAAAAT", b"AAAAAATT"}
    assert set(comps[1]) == {b"GGGGGGGG", b"GGGGGGGC"}
    j = JaxSG(strings, None, max_distance=1)
    assert g.edges == j.edges
    assert g.connected_components() == j.connected_components()


def test_string_graph_split_subgroup():
    from clique_tpu.collapse.graph import StringGraph as JaxSG

    left = [b"AAAAAAAA", b"AAAAAAAT"]
    right = [b"AATTTTTT", b"AATTTTTA"]
    bridge = [b"AAAATTTT"]
    g = StringGraph(left + bridge + right, None, max_distance=4,
                    device="cpu")
    comps = g.connected_components()
    assert len(comps) == 1
    split = g.split_subgroup(comps[0])
    j = JaxSG(left + bridge + right, None, max_distance=4)
    assert split == j.split_subgroup(j.connected_components()[0])
    if split is not None:  # a valid balanced split exists
        assert len(split) == 2
        assert sum(len(s) for s in split) == 5
    assert g.max_set_distance(left + right) == j.max_set_distance(
        left + right)


def test_string_graph_pigeonhole_route_matches_jax():
    """Past 2,048 strings StringGraph takes the pigeonhole candidates: the
    same edges as the JAX package's."""
    from clique_tpu.collapse.graph import StringGraph as JaxSG

    rng = np.random.default_rng(9)
    centers = [rng.choice(BASES, 12).tobytes() for _ in range(300)]
    strings = set(centers)
    while len(strings) < 2100:
        c = bytearray(centers[int(rng.integers(0, len(centers)))])
        c[int(rng.integers(0, 12))] = int(rng.choice(BASES))
        strings.add(bytes(c))
    strings = sorted(strings)
    g = StringGraph(strings, None, max_distance=1, device="cpu")
    j = JaxSG(strings, None, max_distance=1)
    assert g.edges == j.edges and len(g.edges) > 0


def test_known_lookup_symspell():
    from clique_tpu.collapse.graph import KnownLookup as JaxKL

    known = [b"ACGTACGTACGT", b"TTTTTTTTTTTT"]
    kl = KnownLookup(known, max_distance=2, device="cpu")
    jkl = JaxKL(known, max_distance=2)
    queries = [b"ACGTACGTACGT", b"ACGTACGTACG", b"ACGAACGTACGT",
               b"GGGGGGGGGGGG"]
    assert [kl.correct(q) for q in queries] == [
        b"ACGTACGTACGT", b"ACGTACGTACGT", b"ACGTACGTACGT", None]
    assert [kl.correct(q) for q in queries] == [jkl.correct(q)
                                                for q in queries]
    assert kl.index == jkl.index
    kl2 = KnownLookup([b"AAAAAAAA", b"AAAAAACC"], max_distance=2,
                      device="cpu")
    assert kl2.correct(b"AAAAAAAC") is None
    assert kl2.correct(b"AAAAAAAC", if_multiple_take_first=True) == \
        JaxKL([b"AAAAAAAA", b"AAAAAACC"], 2).correct(
            b"AAAAAAAC", if_multiple_take_first=True)


# --- caller/views.py, cells.py (tests/test_views.py), tenx.py ---------------

def _write_bam(path, records):
    from clique_tpu_torch.io.sam import BamWriter

    with BamWriter(str(path), [("amp1", 200)]) as w:
        for r in records:
            w.write(r)


def _rec(name, seq=b"ACGTACGTACGT", rm="0.97", rc="5", e0=None, e1=None):
    from clique_tpu_torch.io.sam import SamRecord

    tags = {"rm": rm, "rc": rc}
    if e0:
        tags["e0"] = e0
    if e1:
        tags["e1"] = e1
    return SamRecord(name=name, flag=0, reference_name="amp1", pos=1,
                     mapq=255, cigar=[(len(seq), "M")], seq=seq,
                     qual=b"I" * len(seq), tags=tags)


def test_lineage_bam_reads_filters(tmp_path):
    from clique_tpu.caller.views import lineage_bam_reads as jax_reads
    from clique_tpu_torch.caller.views import lineage_bam_reads

    bam = tmp_path / "x.bam"
    _write_bam(bam, [
        _rec("keep", e0="AAAA", e1="CCCC"),
        _rec("low_rm", rm="0.5"),
        _rec("low_rc", rc="1"),
        _rec("no_anchor", seq=b"TTTTTTTTTTTT", e0="GGGG"),
    ])
    reads = list(lineage_bam_reads(str(bam), None, 0.9, 2,
                                   anchors=["ACGT"]))
    assert [r.name for r in reads] == ["keep"]
    assert reads[0].e0 == "AAAA" and reads[0].e1 == "CCCC"
    assert reads[0].read_count == 5
    want = list(jax_reads(str(bam), None, 0.9, 2, anchors=["ACGT"]))
    key = lambda r: (r.name, r.tags, r.read, r.alignment_rate,  # noqa: E731
                     r.read_count, r.cigar)
    assert [key(r) for r in reads] == [key(r) for r in want]


def test_reference_difference_matches_jax(tmp_path):
    """CliqueReadSet.reference_difference through the port's EventCaller
    and extractor: the same allele strings as the JAX package's."""
    from clique_tpu.caller import events as jev
    from clique_tpu.caller.views import lineage_bam_reads as jax_reads
    from clique_tpu_torch.caller import events as tev
    from clique_tpu_torch.caller.views import lineage_bam_reads

    rng = np.random.default_rng(3)
    target = "GGCACTGCGGCTGGAGGTGG"
    ref = (rng.choice(BASES, 30).tobytes().decode() + target +
           rng.choice(BASES, 30).tobytes().decode())
    edited = ref[:44] + ref[48:]          # a 4 bp deletion at the cut
    recs = [_rec("wt", seq=ref.encode()), _rec("del", seq=edited.encode())]
    recs[1].cigar = [(44, "M"), (4, "D"), (len(edited) - 44, "M")]
    bam = tmp_path / "v.bam"
    _write_bam(bam, recs)

    def calls(fn, ev):
        caller = ev.EventCaller(ref, [ev.Target(
            target, ev.TargetType.CAS9_DSB, validate=False)])
        return [r.reference_difference()
                for r in fn(str(bam), ref, 0.9, 1, caller=caller)]
    got = calls(lineage_bam_reads, tev)
    assert got == calls(jax_reads, jev)
    assert len(got) == 2 and got[0] != got[1] and all(got)


def test_base_editing_cell_list(tmp_path):
    from clique_tpu.caller.views import BaseEditingCellList as JaxBECL
    from clique_tpu.caller.views import lineage_bam_reads as jax_reads
    from clique_tpu_torch.caller.views import (BaseEditingCellList,
                                               lineage_bam_reads)

    bam = tmp_path / "y.bam"
    _write_bam(bam, [
        _rec("r1", e0="CELL1", e1="INT1"),
        _rec("r2", e0="CELL1", e1="INT1"),
        _rec("r3", e0="CELL1", e1="INT2"),
        _rec("r4", e0="CELLX", e1="INT1"),
    ])
    becl = BaseEditingCellList(lineage_bam_reads(str(bam), None, 0.9, 1),
                               ["CELL1", "CELL2"], "e0", "e1")
    assert becl.matched_cell_barcodes == 3
    assert becl.unmatched_cell_barcodes == 1
    cell = becl.matched_cells["CELL1"]
    assert set(cell.integration_ids) == {"INT1", "INT2"}
    assert cell.read_counts[cell.integration_ids.index("INT1")] == 10
    j = JaxBECL(jax_reads(str(bam), None, 0.9, 1), ["CELL1", "CELL2"],
                "e0", "e1")
    for cid, c in becl.matched_cells.items():
        jc = j.matched_cells[cid]
        assert (c.integration_ids, c.read_counts, c.editing_outcomes) == \
            (jc.integration_ids, jc.read_counts, jc.editing_outcomes)


def test_cell_manager(tmp_path):
    from clique_tpu.caller.cells import CellManager as JaxCM
    from clique_tpu_torch.caller.cells import CellManager

    bam = tmp_path / "z.bam"
    _write_bam(bam, [
        _rec("r1", e0="AAAA", e1="X1"),
        _rec("r2", e0="AAAA", e1="X2"),
        _rec("r3", e0="CCCC", e1="X1"),
    ])
    cm = CellManager(str(bam), ["e0"], ["e1"])
    assert len(cm.cells) == 2
    assert len(cm.cells["AAAA"].barcode_sequences) == 2
    cm.add_known_cell_id_list(["AAAA", "GGGG"])
    assert cm.intersection() == (1, 1)
    j = JaxCM(str(bam), ["e0"], ["e1"])
    assert {k: v.barcode_sequences for k, v in cm.cells.items()} == \
        {k: v.barcode_sequences for k, v in j.cells.items()}


def test_cluster_integration_ids():
    from clique_tpu.caller.views import (cluster_integration_ids as jax_cl,
                                         integration_id_distances as jax_d)
    from clique_tpu_torch.caller.views import (cluster_integration_ids,
                                               integration_id_distances)

    ids = ["ACGTACGTACGT", "ACGTACGTACGA", "TTTTGGGGCCCC", "TTTTGGGGCCCA"]
    labels = cluster_integration_ids(ids, distance_threshold=2.0,
                                     device="cpu")
    assert labels["ACGTACGTACGT"] == labels["ACGTACGTACGA"]
    assert labels["TTTTGGGGCCCC"] == labels["TTTTGGGGCCCA"]
    assert labels["ACGTACGTACGT"] != labels["TTTTGGGGCCCC"]
    assert labels == jax_cl(ids, distance_threshold=2.0)
    d = integration_id_distances(ids, ids[:3], device="cpu")
    assert d.dtype == np.float64 and d.shape == (4, 3)
    np.testing.assert_array_equal(d, jax_d(ids, ids[:3]))


def test_tenx_cell_lists(tmp_path):
    from clique_tpu.caller.tenx import TenXSingleCellStats as JaxTenX
    from clique_tpu_torch.caller.tenx import TenXSingleCellStats

    for sub, cells in (("filtered_feature_bc_matrix", ["AAAC", "AAAG"]),
                       ("raw_feature_bc_matrix", ["AAAC", "AAAG", "TTTT"])):
        (tmp_path / sub).mkdir()
        with gzip.open(tmp_path / sub / "barcodes.tsv.gz", "wt") as fh:
            fh.write("".join(f"{c}-1\n" for c in cells))
    match = tmp_path / "map.tsv.gz"
    with gzip.open(match, "wt") as fh:
        fh.write("CCCC\tAAAC\nGGGG\tTTTT\n")
    t = TenXSingleCellStats(str(tmp_path), matching_list=str(match))
    j = JaxTenX(str(tmp_path), matching_list=str(match))
    assert t.filtered_list == j.filtered_list == ["AAAC", "AAAG"]
    assert t.unfiltered_list == j.unfiltered_list
    assert t.get_passing_cell_ids(True) == j.get_passing_cell_ids(True) \
        == ["CCCC"]
    assert t.get_passing_cell_ids(False) == j.get_passing_cell_ids(False)


# --- utils/read_sim.py (tests/test_multiref.py:103) -------------------------

def test_read_sim_assignment_tsv(tmp_path):
    from clique_tpu.utils.read_sim import write_assignment_tsv as jax_write
    from clique_tpu_torch.utils.read_sim import write_assignment_tsv

    fq = tmp_path / "sim.fastq"
    fq.write_text(
        "@read1 ampA,+strand,10-110 length=100\nACGT\n+\nIIII\n"
        "@read2\nACGT\n+\nIIII\n"
        "@read3 ampB,-,5-9\nACGT\n+\nIIII\n")
    out, out_j = tmp_path / "assign.tsv", tmp_path / "jax.tsv"
    assert write_assignment_tsv(str(fq), str(out)) == 3
    assert jax_write(str(fq), str(out_j)) == 3
    lines = out.read_text().splitlines()
    assert lines[1].split("\t") == ["read1", "ampA", "10", "110"]
    assert lines[2].split("\t")[1] == ""
    assert out.read_text() == out_j.read_text()


# --- correct_degenerate (tests/test_collapse_correct.py:64-113) -------------

CFG = dict(max_distance=2, length=10, collapse_ratio=5.0)


def _counts(anchor_count):
    return {
        b"AAAAATTTTT": anchor_count,
        b"AAAAATTTGT": 1,
        b"GGGGGCCCCC": anchor_count,
        b"GCGGGCCCCC": 1,
    }


def _both(counts, **kw):
    from clique_tpu.collapse.correct import correct_degenerate as jax_cd

    got = correct_degenerate(counts, device="cpu", **kw)
    assert got == jax_cd(counts, **kw)
    return got


def test_degenerate_above_ratio_merges():
    out = _both(_counts(10), **CFG)
    assert out[b"AAAAATTTTT"] == b"AAAAATTTTT"
    assert out[b"AAAAATTTGT"] == b"AAAAATTTTT"
    assert out[b"GGGGGCCCCC"] == b"GGGGGCCCCC"
    assert out[b"GCGGGCCCCC"] == b"GGGGGCCCCC"


def test_degenerate_below_ratio_keeps():
    out = _both(_counts(3), **CFG)
    assert out[b"AAAAATTTGT"] == b"AAAAATTTGT"
    assert out[b"GCGGGCCCCC"] == b"GCGGGCCCCC"


def test_degenerate_gappy_variants_absorb():
    counts = _counts(10)
    counts[b"GGGGGCCCC-"] = 1
    counts[b"GGGGGCCCCA"] = 1
    counts[b"GGGGCCCCC-"] = 1
    out = _both(counts, **CFG)
    assert out[b"GGGGGCCCC-"] == b"GGGGGCCCCC"
    assert out[b"GGGGGCCCCA"] == b"GGGGGCCCCC"
    assert out[b"GGGGCCCCC-"] == b"GGGGGCCCCC"


def test_degenerate_single_tag_and_empty():
    assert _both({b"AAAAATT": 3}, **CFG) == {b"AAAAATT---": b"AAAAATT---"}
    assert _both({}, **CFG) == {}


def test_degenerate_transitive_absorption():
    counts = {b"AAAAAAAAAA": 100, b"AAAAAAAATT": 10, b"AAAAAATTTT": 1}
    out = _both(counts, **CFG)
    assert out[b"AAAAAAAATT"] == b"AAAAAAAAAA"
    assert out[b"AAAAAATTTT"] == b"AAAAAAAAAA"


# --- correct_degenerate against the group path (test_pigeonhole.py:251) ----

@pytest.mark.parametrize("L,d", [(12, 2), (16, 2), (16, 1)])
def test_group_path_equals_single_group_path(L, d):
    """The port's correct_degenerate_groups (restricted pair joins) and its
    one-group correct_degenerate give the map of the JAX correct_degenerate
    (brute-force all pairs)."""
    rng = np.random.default_rng(7 * L + d)
    for _trial in range(2):
        centers = [rng.choice(BASES, L).tobytes() for _ in range(6)]
        counts = {}
        for c in centers:
            counts[c] = int(rng.integers(20, 60))
            for _ in range(30):
                x = bytearray(c)
                for _ in range(int(rng.integers(1, d + 1))):
                    x[int(rng.integers(L))] = int(rng.choice(BASES))
                t = bytes(x)
                if t not in counts:
                    counts[t] = int(rng.integers(1, 3))
        got = correct_degenerate_groups([counts], d, L, 5.0,
                                        device="cpu")[0]
        assert got == _both(counts, max_distance=d, length=L,
                            collapse_ratio=5.0)


def test_correct_degenerate_exported():
    import clique_tpu_torch.collapse as tc

    assert tc.correct_degenerate is correct_degenerate
    assert set(tc.__all__) == {
        "correct_degenerate", "correct_known_hamming",
        "correct_known_levenshtein", "ShardReader", "ShardWriter",
        "iter_sorted_groups"}
    with pytest.raises(AttributeError):
        tc.no_such_name
