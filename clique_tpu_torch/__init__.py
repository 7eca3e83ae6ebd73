"""PyTorch + CUDA port of clique_tpu.

A second package beside the JAX reference (clique_tpu/). It imports torch
and never jax: host modules without jax are shared from clique_tpu by
import, device code is PyTorch plus hand-written CUDA kernels (csrc/,
built at first use by _build.py). Ported so far: the `align` verb with the
dp engine and the kmer router (align/), the `collapse` verb on one process
(collapse/), `call` (shared host code) and the fused `run` chain
(chain.py), all behind cli.py.
"""
