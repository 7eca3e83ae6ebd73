from clique_tpu_torch.caller.events import (
    Event,
    EventCaller,
    EventCigar,
    Target,
    TargetPosition,
    TargetType,
    call_events_from_bam,
)

__all__ = [
    "Event",
    "EventCaller",
    "EventCigar",
    "Target",
    "TargetPosition",
    "TargetType",
    "call_events_from_bam",
]
