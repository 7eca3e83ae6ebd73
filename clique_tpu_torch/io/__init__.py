from clique_tpu_torch.io.fastq import FastqRecord, ReadIterator, ReadSetContainer, read_fasta
from clique_tpu_torch.io.sam import SamRecord, SamWriter, BamWriter, BamReader, open_alignment_writer

__all__ = [
    "FastqRecord",
    "ReadIterator",
    "ReadSetContainer",
    "read_fasta",
    "SamRecord",
    "SamWriter",
    "BamWriter",
    "BamReader",
    "open_alignment_writer",
]
