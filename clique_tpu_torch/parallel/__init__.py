"""Multi-device and multi-process runs of the port on torch.distributed:
the data-parallel align step and the row-split alignment over a list of
devices (mesh.py), the tag group-by backbone (groupby.py) and the
multi-process `align` and `collapse` (distributed.py). Counterpart of
clique_tpu/parallel/."""

from clique_tpu_torch.parallel.mesh import (length_sharded_align, make_mesh,
                                            sharded_align_step)

__all__ = ["length_sharded_align", "make_mesh", "sharded_align_step"]
