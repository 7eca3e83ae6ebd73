from clique_tpu_torch.reference.manager import Reference, ReferenceManager

__all__ = ["Reference", "ReferenceManager"]
