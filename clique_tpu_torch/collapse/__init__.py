"""The `collapse` verb on PyTorch + CUDA: tag correction with hand-written
distance kernels (distance.py, csrc/tag_distance.cu), correct.py and the
level pipeline (pipeline.py) over the shared jax-free collapse code."""
