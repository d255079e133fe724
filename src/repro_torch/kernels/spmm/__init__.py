"""Scatter-SpMM: segment sum of edge messages by destination (CUDA, ``csrc/``)."""
