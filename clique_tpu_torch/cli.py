"""Command-line interface of the PyTorch + CUDA port.

`clique-tpu-torch align ...` takes the flags of `clique-tpu align`
(clique_tpu/cli.py:25-95) plus `--device`. Options the port does not run
yet exit with an error that names the ROADMAP.md item porting them.
"""

from __future__ import annotations

import argparse
import logging
import sys

# flag -> (is it set to an unported value?, key of pipeline.ROADMAP_ITEMS)
_UNPORTED = {
    "--engine wfa|convex": (lambda a: a.engine in ("wfa", "convex"),
                            "wavefront"),
    "--router hmm": (lambda a: a.router == "hmm", "hmm"),
    "--distributed-world > 1": (lambda a: a.distributed_world > 1,
                                "parallel"),
    "--bandwidth": (lambda a: a.bandwidth is not None, "batch_modes"),
    "--profile-dir": (lambda a: a.profile_dir is not None, "profiling"),
}


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
                              "(auto = dp); wfa and convex are not ported")
    p_align.add_argument("--batch-size", type=int, default=256)
    p_align.add_argument("--single-ref-native", action="store_true",
                         help="use native affine scoring on single-reference "
                              "panels instead of the rust-bio-compat scoring")
    p_align.add_argument("--mode", default="ont", choices=["ont", "hifi"],
                         help="scoring preset: ont (reference-compatible) or "
                              "hifi (PacBio low-error)")
    p_align.add_argument("--router", default="kmer", choices=["kmer", "hmm"],
                         help="multi-reference routing: unique-kmer vote "
                              "(hmm is not ported)")
    p_align.add_argument("--metrics", default=None,
                         help="write per-stage JSON metrics to this path")
    p_align.add_argument("--profile-dir", default=None,
                         help="not ported")
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
                         help="reads at least this long need the anchored "
                              "path, which is not ported: they raise")
    p_align.add_argument("--distributed-world", type=int, default=1,
                         help="values above 1 are not ported")
    p_align.add_argument("--distributed-rank", type=int, default=0)
    p_align.add_argument("--distributed-coordinator", default=None)
    p_align.add_argument("--work-dir", default=None)
    p_align.add_argument("--bandwidth", type=int, default=None,
                         help="banded DP half-width (not ported)")
    p_align.add_argument("--device", default="cuda",
                         help="torch device the DP runs on: cuda, cuda:N or "
                              "cpu")

    args = parser.parse_args(argv)

    if args.cmd == "align":
        from clique_tpu.config.layout import SequenceLayout
        from clique_tpu.reference.manager import ReferenceManager
        from clique_tpu_torch.align.pipeline import (align_reads,
                                                     unported_message)

        for flag, (is_set, item) in _UNPORTED.items():
            if is_set(args):
                parser.error(unported_message(flag, item))

        layout = SequenceLayout.from_yaml(args.read_structure)
        rm = ReferenceManager.from_layout(layout, args.kmer_size,
                                          args.kmer_spacing)
        stats = align_reads(
            layout, rm, args.output_bam_file,
            read1=args.read1, read2=args.read2,
            index1=args.index1, index2=args.index2,
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
            device=args.device,
        )
        logging.info("align done: %s", stats)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
