"""Hand-written Hopper kernels, one directory per kernel: ``csrc/`` (the
CUDA source), ``ops.py`` (wrapper: builds, checks, launches, counts) and
``ref.py`` (the plain PyTorch version).

  cca_cycle/   fused cycle kernel: K engine cycles per launch
"""
