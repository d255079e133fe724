"""Fused cycle kernel: K engine cycles per launch (CUDA, ``csrc/``)."""
