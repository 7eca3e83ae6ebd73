"""PyTorch + CUDA port of clique_tpu.

A second package beside the JAX reference (clique_tpu/). It imports torch
and never jax, and nothing of the JAX package: the host modules it needs
(config, io, native, reference, extract, consensus, caller, utils and the
host parts of align and collapse) are its own copies. Device code is
PyTorch plus hand-written CUDA kernels (csrc/, built at first use by
_build.py). Ported so far: the `align` verb with the dp engine and the kmer
router (align/), the `collapse` verb on one process (collapse/), `call`
(caller/) and the fused `run` chain (chain.py), all behind cli.py.
"""
