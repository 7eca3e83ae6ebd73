"""The port's multi-process align and collapse (parallel/distributed.py)
across 2 and 4 processes on torch.distributed's gloo backend with
device="cpu", each rank a fresh interpreter with the repo root on its
PYTHONPATH and jax and the JAX package blocked. Each output's record
multiset equals the JAX package's single-process align_reads / collapse
on the same input, computed in the test process. Every rank has a
timeout at its rendezvous and collectives (CLIQUE_TPU_DIST_TIMEOUT) and
every communicate() one of its own, so a rank that dies fails the case.

The cases of tests/test_distributed_align.py:181 (the two-process chain),
tests/test_distributed_collapse.py:118 (two-process collapse) and
tests/test_distributed_matrix.py:154-206 (four-process two-level, out of
core, correct-only, single-process out of core)."""

import os
import socket
import subprocess
import sys
import textwrap

from clique_tpu.collapse.pipeline import collapse as jax_collapse
from clique_tpu.io.sam import read_cqi

from tests.test_distributed_collapse import build_dataset, record_multiset
from tests.test_distributed_matrix import build_two_level_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a rank may take in all, and at one rendezvous or barrier
RANK_TIMEOUT = 120
DIST_TIMEOUT = 60

_WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None        # the port runs without jax
    sys.modules["jaxlib"] = None
    sys.modules["clique_tpu"] = None
    import logging
    logging.basicConfig(level=logging.INFO)
    import torch
    torch.set_num_threads(1)
    (verb, layout_path, inp, work, out_bam, pid, nproc, port,
     correct_only, out_of_core, cwork, cout) = sys.argv[1:13]
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.parallel.distributed import (
        align_distributed, collapse_distributed, shutdown_distributed)
    from clique_tpu_torch.reference.manager import ReferenceManager
    layout = SequenceLayout.from_yaml(layout_path)
    kw = dict(process_id=int(pid), num_processes=int(nproc),
              coordinator_address=f"localhost:{port}", device="cpu")
    if verb == "chain":
        rm = ReferenceManager.from_layout(layout)
        align_distributed(layout, rm, out_bam, work, read1=inp,
                          batch_size=8, **kw)
        # straight into distributed collapse on the merged BAM: the
        # multi-process align -> collapse path in one process set
        collapse_distributed(cout, layout, out_bam, cwork, **kw)
    else:
        collapse_distributed(out_bam, layout, inp, work,
                             correct_only=correct_only == "1",
                             out_of_core={"1": True, "0": None}[out_of_core],
                             **kw)
    shutdown_distributed()
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in
                    ("jax", "jaxlib", "clique_tpu"))
    assert not loaded, loaded
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(tmp_path, nproc, verb, layout_path, inp, out_bam, *,
               correct_only=False, out_of_core=False, cqi_every="8",
               cwork="-", cout="-"):
    work = tmp_path / f"work_{os.path.basename(out_bam)}"
    work.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["CLIQUE_TPU_DIST_TIMEOUT"] = str(DIST_TIMEOUT)
    env["CLIQUE_TPU_CQI_EVERY"] = cqi_every
    # small stripe chunks so 30 reads really split across ranks
    env["CLIQUE_TPU_SHARD_CHUNK"] = "8"
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), verb, layout_path, inp, str(work),
             out_bam, str(p), str(nproc), str(port),
             "1" if correct_only else "0", "1" if out_of_core else "0",
             cwork, cout],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")[-4000:]
    logs = b"".join(outs).decode(errors="replace")
    assert logs.count("torch.distributed gloo backend") == nproc, logs
    return work


def test_distributed_chain_two_processes(tmp_path):
    """Two ranks: distributed align (each rank's stripe really split) ->
    distributed collapse of the merged BAM; the aligned multiset equals
    the JAX align_reads', the collapsed one the JAX collapse's of the same
    merged BAM (group-member order follows input order)."""
    _jl, layout_path, aligned = build_dataset(tmp_path)
    fq = str(tmp_path / "reads.fastq.gz")
    cwork = tmp_path / "work_collapse"
    cwork.mkdir()
    out_bam = str(tmp_path / "dist_align2.bam")
    cout_bam = str(tmp_path / "dist_collapsed2.bam")
    work = _run_world(tmp_path, 2, "chain", layout_path, fq, out_bam,
                      cwork=str(cwork), cout=cout_bam)
    from clique_tpu_torch.io.sam import BamReader

    for p in range(2):
        with BamReader(str(work / f"part.p{p}.bam")) as reader:
            assert sum(1 for _ in reader) > 0
    assert record_multiset(out_bam) == record_multiset(aligned)
    from clique_tpu.config.layout import SequenceLayout as JaxLayout

    ref_collapsed = tmp_path / "ref_collapsed.bam"
    jax_collapse(str(ref_collapsed), JaxLayout.from_yaml(layout_path),
                 out_bam)
    assert record_multiset(cout_bam) == record_multiset(str(ref_collapsed))


def test_distributed_collapse_two_processes(tmp_path):
    jax_layout, layout_path, aligned = build_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), jax_layout, aligned)
    out_bam = str(tmp_path / "dist2.bam")
    _run_world(tmp_path, 2, "collapse", layout_path, aligned, out_bam)
    assert record_multiset(out_bam) == record_multiset(str(ref_bam))


def test_four_process_two_level_parity(tmp_path):
    layout, layout_path, aligned = build_two_level_dataset(tmp_path)
    # the aligner minted a chunk index -> byte-range ingest is active
    assert read_cqi(aligned)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), layout, aligned)
    out_bam = str(tmp_path / "dist4.bam")
    _run_world(tmp_path, 4, "collapse", layout_path, aligned, out_bam)
    assert record_multiset(out_bam) == record_multiset(str(ref_bam))


def test_four_process_out_of_core_parity(tmp_path):
    # maximum_subsequences set -> collapse_distributed auto-routes
    # out-of-core (same trigger as single-process collapse)
    layout, layout_path, aligned = build_two_level_dataset(
        tmp_path, maximum_subsequences=4)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), layout, aligned)
    out_bam = str(tmp_path / "dist_ooc.bam")
    work = _run_world(tmp_path, 4, "collapse", layout_path, aligned, out_bam)
    # the streaming path really ran: local per-process spill dirs exist
    assert any(p.name.startswith("local.p") for p in work.iterdir())
    assert record_multiset(out_bam) == record_multiset(str(ref_bam))


def test_two_process_correct_only_parity(tmp_path):
    layout, layout_path, aligned = build_two_level_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), layout, aligned, correct_only=True)
    out_bam = str(tmp_path / "dist_co.bam")
    _run_world(tmp_path, 2, "collapse", layout_path, aligned, out_bam,
               correct_only=True)
    assert record_multiset(out_bam) == record_multiset(str(ref_bam))


def test_single_process_out_of_core_matches_in_ram(tmp_path):
    """1-process distributed out-of-core == the JAX single-process IN-RAM
    collapse: read ordinals make group-member order input-BAM order in
    every path, so the spill pipeline reproduces the in-RAM records."""
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.parallel.distributed import collapse_distributed

    layout, layout_path, aligned = build_two_level_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), layout, aligned)
    out_bam = tmp_path / "dist_ooc1.bam"
    work = tmp_path / "w1"
    work.mkdir()
    collapse_distributed(str(out_bam), SequenceLayout.from_yaml(layout_path),
                         aligned, str(work), process_id=0, num_processes=1,
                         out_of_core=True, device="cpu")
    assert record_multiset(str(out_bam)) == record_multiset(str(ref_bam))


def test_a_dead_rank_fails_the_world(tmp_path):
    """A world of two whose second rank never starts: rank 0 gives up at
    the rendezvous after its timeout and exits non-zero, instead of
    hanging."""
    _jl, layout_path, aligned = build_dataset(tmp_path)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    work = tmp_path / "w"
    work.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT, CLIQUE_TPU_DIST_TIMEOUT="5",
               OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, str(script), "collapse", layout_path, aligned,
         str(work), str(tmp_path / "x.bam"), "0", "2", str(_free_port()),
         "0", "0", "-", "-"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        out = p.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode != 0, out.decode(errors="replace")[-2000:]
    assert not (tmp_path / "x.bam").exists()
