"""Alignment: batched DP (batch.py), its CUDA kernels (dp_kernels.py) and
the `align` pipeline (pipeline.py)."""
