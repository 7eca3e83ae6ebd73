from clique_tpu_torch.consensus.stretcher import AlignmentCandidate
from clique_tpu_torch.consensus.quality import (
    calculate_qual_scores,
    combine_qual_scores,
    phred_to_error_prob,
    prob_to_phred,
)

__all__ = [
    "AlignmentCandidate",
    "calculate_qual_scores",
    "combine_qual_scores",
    "phred_to_error_prob",
    "prob_to_phred",
]
