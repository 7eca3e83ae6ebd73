"""The `collapse` verb on PyTorch + CUDA: tag correction with hand-written
distance kernels (distance.py, csrc/tag_distance.cu), correct.py and the
level pipeline (pipeline.py) over the shared jax-free collapse code.

Re-exports resolve lazily, as clique_tpu/collapse/__init__.py's do, so
that the worker processes of collapse/workers.py import the shard and
ingestion submodules without torch or the distance kernels.
"""

_EXPORTS = {
    "correct_degenerate": "clique_tpu_torch.collapse.correct",
    "correct_known_hamming": "clique_tpu_torch.collapse.correct",
    "correct_known_levenshtein": "clique_tpu_torch.collapse.correct",
    "ShardReader": "clique_tpu_torch.collapse.shards",
    "ShardWriter": "clique_tpu_torch.collapse.shards",
    "iter_sorted_groups": "clique_tpu_torch.collapse.shards",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
