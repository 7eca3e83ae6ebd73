from clique_tpu_torch.config.layout import (
    AlignedReadOrientation,
    MergeStrategy,
    ReadPosition,
    ReferenceRecord,
    SequenceLayout,
    TargetType,
    UMIConfiguration,
    UMIPadding,
    UMISortType,
)

__all__ = [
    "AlignedReadOrientation",
    "MergeStrategy",
    "ReadPosition",
    "ReferenceRecord",
    "SequenceLayout",
    "TargetType",
    "UMIConfiguration",
    "UMIPadding",
    "UMISortType",
]
