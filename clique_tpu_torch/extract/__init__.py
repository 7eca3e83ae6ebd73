from clique_tpu_torch.extract.extractor import (
    extract_tagged_sequences,
    extract_tag_sequences,
    gap_proportion_per_tag,
    recover_aligned_sequences,
    stretch_sequence_to_alignment,
)

__all__ = [
    "extract_tagged_sequences",
    "extract_tag_sequences",
    "gap_proportion_per_tag",
    "recover_aligned_sequences",
    "stretch_sequence_to_alignment",
]
