"""Command-line interface of the PyTorch + CUDA port.

`clique-tpu-torch align|collapse|run ...` take the flags of the same verbs
of `clique-tpu` (clique_tpu/cli.py:25-184) plus `--device`; `call` takes
those of `clique-tpu call` and runs on the host. `align` and `collapse`
with `--distributed-world N > 1` run as one of N processes
(parallel/distributed.py) over a shared `--work-dir`, joined at
`--distributed-coordinator` (host:port, rank 0's); each process runs its
kernels on `--device`, a bare `cuda` meaning cuda:(rank % device count).
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(
        prog="clique-tpu-torch",
        description="amplicon / lineage-barcode analysis engine, PyTorch + "
                    "CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_align = sub.add_parser("align", help="align reads to amplicon references")
    p_align.add_argument("--read-structure", required=True,
                         help="sequence layout YAML")
    p_align.add_argument("--output-bam-file", required=True)
    p_align.add_argument("--max-reference-multiplier", type=int, default=2)
    p_align.add_argument("--min-read-length", type=int, default=50)
    p_align.add_argument("--read1", required=True)
    p_align.add_argument("--read2", default="NONE")
    p_align.add_argument("--index1", default="NONE")
    p_align.add_argument("--index2", default="NONE")
    p_align.add_argument("--threads", type=int, default=1,
                         help="accepted for CLI compatibility; device batching"
                              " replaces host threading")
    p_align.add_argument("--aligner", default="wfa",
                         choices=["wfa", "degenerate", "inversion"],
                         help="accepted for CLI compatibility (the reference "
                              "engine ignores it too); see --engine")
    p_align.add_argument("--engine", default="auto",
                         choices=["auto", "dp", "wfa", "convex"],
                         help="alignment engine: dp = exact 3-plane affine DP "
                              "(auto = dp); wfa = wavefront engine; convex = "
                              "wavefront engine under dual-affine penalties")
    p_align.add_argument("--batch-size", type=int, default=256)
    p_align.add_argument("--single-ref-native", action="store_true",
                         help="use native affine scoring on single-reference "
                              "panels instead of the rust-bio-compat scoring")
    p_align.add_argument("--mode", default="ont", choices=["ont", "hifi"],
                         help="scoring preset: ont (reference-compatible) or "
                              "hifi (PacBio low-error)")
    p_align.add_argument("--router", default="kmer", choices=["kmer", "hmm"],
                         help="multi-reference routing: unique-kmer vote "
                              "or pair-HMM forward likelihood (on "
                              "--device)")
    p_align.add_argument("--metrics", default=None,
                         help="write per-stage JSON metrics to this path")
    p_align.add_argument("--profile-dir", default=None,
                         help="write a torch.profiler Chrome trace of the "
                              "run (host, and the card's activity) here")
    p_align.add_argument("--kmer-size", type=int, default=8,
                         help="reference routing kmer size (main.rs:271 "
                              "hardcodes 8)")
    p_align.add_argument("--kmer-spacing", type=int, default=4,
                         help="reference routing kmer spacing (hardcoded 4 "
                              "in the reference)")
    p_align.add_argument("--quick-match-threshold", type=float, default=0.90,
                         help="kmer-vote share above which a reference is "
                              "picked without exhaustive search "
                              "(alignment_functions.rs:613 hardcodes 0.90)")
    p_align.add_argument("--anchored-min-length", type=int, default=2048,
                         help="reads at least this long route through the "
                              "anchored seed-and-extend path (DP engine)")
    p_align.add_argument("--distributed-world", type=int, default=1,
                         help="run align as N cooperating processes over a "
                              "shared --work-dir; launch every process with "
                              "identical args plus a distinct "
                              "--distributed-rank")
    p_align.add_argument("--distributed-rank", type=int, default=0)
    p_align.add_argument("--distributed-coordinator", default=None,
                         help="host:port of the torch.distributed "
                              "rendezvous (rank 0's address)")
    p_align.add_argument("--work-dir", default=None,
                         help="shared scratch dir for part BAMs (required "
                              "with --distributed-world > 1)")
    p_align.add_argument("--bandwidth", type=int, default=None,
                         help="banded DP half-width around the length-"
                              "proportional diagonal (alignment_matrix.rs"
                              ":376-425); default full band")
    p_align.add_argument("--device", default="cuda",
                         help="torch device the DP runs on: cuda, cuda:N or "
                              "cpu")

    p_collapse = sub.add_parser(
        "collapse", help="hierarchically sort, correct and collapse tags")
    p_collapse.add_argument("--output-bam-file", required=True)
    p_collapse.add_argument("--read-structure", required=True)
    p_collapse.add_argument("--threads", type=int, default=1,
                            help="host worker processes (ingest and "
                                 "consensus); the corrections stay on "
                                 "--device")
    p_collapse.add_argument("--temp-dir", default="NONE")
    p_collapse.add_argument("--input-bam-file", required=True)
    # accepted-and-ignored like the reference (main.rs:228)
    p_collapse.add_argument("--find-inversions", action="store_true")
    p_collapse.add_argument("--fast-reference-lookup", action="store_true")
    p_collapse.add_argument("--max-deletion", type=int, default=0)
    p_collapse.add_argument("--correct-only", action="store_true")
    p_collapse.add_argument("--checkpoint", action="store_true",
                            help="persist each correction level under "
                                 "--temp-dir and resume interrupted runs")
    p_collapse.add_argument("--out-of-core", action="store_true",
                            help="stream reads through spill shards under "
                                 "--temp-dir instead of holding them in RAM")
    p_collapse.add_argument("--min-aligned-bases", type=int, default=45,
                            help="AlignmentCheck: minimum alignable columns "
                                 "(collapse.rs:455-459 hardcodes 45)")
    p_collapse.add_argument("--min-identity", type=float, default=0.8,
                            help="AlignmentCheck: minimum identity over "
                                 "alignable columns (hardcoded 0.8 in the "
                                 "reference)")
    p_collapse.add_argument("--gap-call-threshold", type=float, default=0.75,
                            help="consensus gap-call fraction "
                                 "(consensus_builders.rs:235 hardcodes 0.75)")
    p_collapse.add_argument("--downsample-cap", type=int, default=40,
                            help="consensus group downsample cap / dc tag "
                                 "(collapse.rs:128 hardcodes 40)")
    p_collapse.add_argument("--shards", type=int, default=None,
                            help="spill shard count for the out-of-core "
                                 "path (default: sized from the input)")
    p_collapse.add_argument("--distributed-world", type=int, default=1,
                            help="number of cooperating processes; run one "
                                 "process per rank with identical flags "
                                 "plus a distinct --distributed-rank")
    p_collapse.add_argument("--distributed-rank", type=int, default=0)
    p_collapse.add_argument("--distributed-coordinator", default=None,
                            help="host:port of the torch.distributed "
                                 "rendezvous (rank 0's address)")
    p_collapse.add_argument("--work-dir", default=None,
                            help="shared filesystem directory for the "
                                 "multi-process exchange (required when "
                                 "--distributed-world > 1)")
    p_collapse.add_argument("--device", default="cuda",
                            help="torch device the tag-distance kernels run "
                                 "on: cuda, cuda:N or cpu")

    p_run = sub.add_parser(
        "run", help="fused align + collapse (+ call) in one job: collapse "
                    "ingests align's in-memory results instead of "
                    "re-parsing the BAM; outputs are byte-identical to "
                    "running the stages separately")
    p_run.add_argument("--read-structure", required=True)
    p_run.add_argument("--read1", required=True)
    p_run.add_argument("--read2", default="NONE")
    p_run.add_argument("--index1", default="NONE")
    p_run.add_argument("--index2", default="NONE")
    p_run.add_argument("--aligned-bam-file", required=True,
                       help="tagged align BAM artifact (still written)")
    p_run.add_argument("--output-bam-file", required=True,
                       help="collapsed consensus BAM")
    p_run.add_argument("--alleles", default=None,
                       help="also run call: allele table (.tsv) output")
    p_run.add_argument("--vcf", default=None,
                       help="also run call: VCF output")
    p_run.add_argument("--batch-size", type=int, default=256)
    p_run.add_argument("--mode", default="ont", choices=["ont", "hifi"])
    p_run.add_argument("--engine", default="auto",
                       choices=["auto", "dp", "wfa", "convex"],
                       help="auto = dp; wfa = wavefront engine; convex = "
                            "wavefront engine under dual-affine penalties")
    p_run.add_argument("--router", default="kmer", choices=["kmer", "hmm"],
                       help="multi-reference routing: kmer vote or pair-HMM")
    p_run.add_argument("--correct-only", action="store_true")
    p_run.add_argument("--downsample-cap", type=int, default=40)
    p_run.add_argument("--min-aligned-bases", type=int, default=45)
    p_run.add_argument("--min-identity", type=float, default=0.8)
    p_run.add_argument("--gap-call-threshold", type=float, default=0.75)
    p_run.add_argument("--min-read-count", type=int, default=1)
    p_run.add_argument("--metrics", default=None,
                       help="align metrics JSON path (collapse metrics go "
                            "next to the collapsed BAM)")
    p_run.add_argument("--device", default="cuda",
                       help="torch device the kernels run on: cuda, cuda:N "
                            "or cpu")

    p_call = sub.add_parser(
        "call", help="call editing events / lineage alleles from a tagged "
                     "BAM (host code)")
    p_call.add_argument("--read-structure", required=True)
    p_call.add_argument("--input-bam-file", required=True)
    p_call.add_argument("--output", required=True,
                        help="output allele table (.tsv) or VCF (.vcf)")
    p_call.add_argument("--min-alignment-rate", type=float, default=0.9)
    p_call.add_argument("--min-read-count", type=int, default=1)

    args = parser.parse_args(argv)
    if getattr(args, "distributed_world", 1) > 1:
        if not args.work_dir:
            parser.error("--work-dir is required with "
                         "--distributed-world > 1")
        if not args.distributed_coordinator:
            parser.error("--distributed-coordinator is required with "
                         "--distributed-world > 1")
        from clique_tpu_torch.parallel.distributed import \
            shutdown_distributed

        try:
            return _run(args)
        finally:
            shutdown_distributed()
    return _run(args)


def _run(args) -> int:
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.reference.manager import ReferenceManager

    if args.cmd == "align":
        from clique_tpu_torch.align.pipeline import align_reads

        layout = SequenceLayout.from_yaml(args.read_structure)
        rm = ReferenceManager.from_layout(layout, args.kmer_size,
                                          args.kmer_spacing)
        align_kwargs = dict(
            max_reference_multiplier=args.max_reference_multiplier,
            min_read_length=args.min_read_length,
            batch_size=args.batch_size,
            single_ref_native=args.single_ref_native,
            mode=args.mode,
            router=args.router,
            engine=None if args.engine == "auto" else args.engine,
            quick_match_threshold=args.quick_match_threshold,
            anchored_min_length=args.anchored_min_length,
            metrics_path=args.metrics,
            profile_dir=args.profile_dir,
            bandwidth=args.bandwidth,
            device=args.device,
        )
        if args.distributed_world > 1:
            from clique_tpu_torch.parallel.distributed import \
                align_distributed

            stats = align_distributed(
                layout, rm, args.output_bam_file, args.work_dir,
                read1=args.read1, read2=args.read2,
                index1=args.index1, index2=args.index2,
                process_id=args.distributed_rank,
                num_processes=args.distributed_world,
                coordinator_address=args.distributed_coordinator,
                **align_kwargs)
            logging.info("distributed align done: %s", stats)
            return 0
        stats = align_reads(
            layout, rm, args.output_bam_file,
            read1=args.read1, read2=args.read2,
            index1=args.index1, index2=args.index2,
            **align_kwargs)
        logging.info("align done: %s", stats)
        return 0

    if args.cmd == "collapse":
        from clique_tpu_torch.collapse.pipeline import collapse

        layout = SequenceLayout.from_yaml(args.read_structure)
        if args.distributed_world > 1:
            from clique_tpu_torch.parallel.distributed import \
                collapse_distributed

            collapse_distributed(
                args.output_bam_file, layout, args.input_bam_file,
                args.work_dir,
                process_id=args.distributed_rank,
                num_processes=args.distributed_world,
                coordinator_address=args.distributed_coordinator,
                correct_only=args.correct_only,
                downsample_cap=args.downsample_cap,
                out_of_core=args.out_of_core or None,
                device=args.device,
            )
            return 0
        collapse(
            output_path=args.output_bam_file,
            layout=layout,
            input_bam=args.input_bam_file,
            temp_dir=None if args.temp_dir == "NONE" else args.temp_dir,
            correct_only=args.correct_only,
            checkpoint=args.checkpoint,
            out_of_core=args.out_of_core,
            min_aligned_bases=args.min_aligned_bases,
            min_identical=args.min_identity,
            gap_call_threshold=args.gap_call_threshold,
            downsample_cap=args.downsample_cap,
            shards=args.shards,
            n_workers=args.threads,
            device=args.device,
        )
        return 0

    if args.cmd == "run":
        from clique_tpu_torch.chain import run_chain

        layout = SequenceLayout.from_yaml(args.read_structure)
        rm = ReferenceManager.from_layout(layout)
        astats, cstats = run_chain(
            layout, rm, args.aligned_bam_file, args.output_bam_file,
            read1=args.read1,
            read2=None if args.read2 == "NONE" else args.read2,
            index1=None if args.index1 == "NONE" else args.index1,
            index2=None if args.index2 == "NONE" else args.index2,
            correct_only=args.correct_only,
            downsample_cap=args.downsample_cap,
            min_aligned_bases=args.min_aligned_bases,
            min_identical=args.min_identity,
            gap_call_threshold=args.gap_call_threshold,
            align_metrics_path=args.metrics,
            alleles_path=args.alleles, vcf_path=args.vcf,
            min_read_count=args.min_read_count,
            batch_size=args.batch_size, mode=args.mode,
            engine=None if args.engine == "auto" else args.engine,
            router=args.router, device=args.device)
        logging.info("run done: align %s, collapse passing=%d",
                     astats, cstats.passing)
        return 0

    if args.cmd == "call":
        from clique_tpu_torch.caller.events import call_events_from_bam

        call_events_from_bam(
            SequenceLayout.from_yaml(args.read_structure),
            args.input_bam_file, args.output,
            min_alignment_rate=args.min_alignment_rate,
            min_read_count=args.min_read_count)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
